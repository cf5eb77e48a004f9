"""The nets of the LJSpeech and LibriTTS zoos (ref: models.py:1002-1110):
the inference nets (a multispeaker config's with the style-conditioned
denoiser, a HiFi-GAN config's with that decoder), stage 1's aligner, pitch
extractor and style encoder, its TMA phase's discriminators and Whisper
encoder, and stage 2's prosody style encoder (``predictor_encoder``) and
Whisper discriminator (``wd``); the reference's initialisation
(``init_reference_``) and the bench's seeded random one (``init_random_``);
and the bridge from the JAX package's parameter trees.

The JAX package keys its parameter trees by the reference torch
``state_dict`` names, so each net here has ``state_dict`` keys equal to the
dot-joined keys of the matching JAX subtree, and loading one is
``load_state_dict(flatten(tree), strict=True)``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import ModelParams
from ..nn import init as tinit
from .asr import ASRCNN, ASRConfig
from .common import ChannelLayerNorm, SNConv2d
from .decoder import hifigan, istftnet
from .diffusion.denoiser import Denoiser
from .discriminators import (MPD_CHANNELS, MultiPeriodDiscriminator, MultiResSpecDiscriminator,
                             WhisperDiscriminator)
from .diffusion.denoiser import _LearnedPositional
from .jdc import JDC, BatchNormStats, JDCConfig
from .plbert import PLBert, PLBertConfig
from .predictor import ProsodyPredictor
from .style_encoder import StyleEncoder
from .text_encoder import TextEncoder
from .whisper import WhisperConfig, WhisperEncoder

INFERENCE_NETS = ("bert", "bert_encoder", "predictor", "decoder", "text_encoder",
                  "diffusion")
# and the two style encoders of ``InferenceEngine.compute_style``: a
# multispeaker model's default
STYLE_INFERENCE_NETS = INFERENCE_NETS + ("style_encoder", "predictor_encoder")
# stage 1 before TMA: the trained text encoder, style encoder and decoder,
# and the frozen aligner and pitch extractor
STAGE1_NETS = ("text_encoder", "style_encoder", "decoder", "text_aligner", "pitch_extractor")
# stage 1 from TMA on: the discriminators and the frozen Whisper encoder too
STAGE1_TMA_NETS = STAGE1_NETS + ("mpd", "msd", "slm_encoder")
# what stage 1's sample dump reads beyond them, frozen and never stepped
# there (the JAX stage-1 zoo holds all 13 nets): ``train_stage1`` builds
# them and saves them in its checkpoints for stage 2
STAGE1_SAMPLE_NETS = ("bert", "bert_encoder", "predictor", "predictor_encoder")
# stage 2: every net of configs/ljspeech.yml, the JAX zoo's 13 and the
# Whisper encoder
STAGE2_NETS = INFERENCE_NETS + ("predictor_encoder", "style_encoder", "text_aligner",
                                "pitch_extractor", "mpd", "msd", "wd", "slm_encoder")


def build_nets(mp: ModelParams, plbert_cfg: PLBertConfig = PLBertConfig(),
               decoder_width: Optional[int] = None, decoder_asr_res_ch: int = 64,
               nets: Optional[Sequence[str]] = None, asr_cfg: Optional[ASRConfig] = None,
               jdc_cfg: JDCConfig = JDCConfig(),
               whisper_cfg: WhisperConfig = WhisperConfig(),
               mpd_channels: Sequence[int] = MPD_CHANNELS, msd_width: int = 32
               ) -> nn.ModuleDict:
    """The named nets of the zoo with placeholder parameters (fill them with
    ``init_reference_``, ``init_random_`` or ``load_jax_params``); ``nets``
    defaults to ``STYLE_INFERENCE_NETS`` for a multispeaker config, else
    ``INFERENCE_NETS``.  The decoder is ``mp.decoder.type``'s (iSTFTNet or
    HiFi-GAN); a multispeaker config's denoiser is the ``StyleTransformer1d``.
    ``decoder_width`` defaults to twice the generator's
    ``upsample_initial_channel``: the reference's 1024 over 512
    (Modules/istftnet.py, Modules/hifigan.py).  ``asr_cfg`` defaults to
    ``ASRConfig(n_token=mp.n_token)``; ``whisper_cfg`` sizes the
    ``slm_encoder`` (Whisper-base by default)."""
    if mp.decoder.type not in ("istftnet", "hifigan"):
        raise NotImplementedError(f"no decoder of type {mp.decoder.type!r}")
    if nets is None:
        nets = STYLE_INFERENCE_NETS if mp.multispeaker else INFERENCE_NETS
    decoder_cls = istftnet.Decoder if mp.decoder.type == "istftnet" else hifigan.Decoder
    tr = mp.diffusion.transformer
    decoder_width = decoder_width or 2 * mp.decoder.upsample_initial_channel
    makers = {
        "bert": lambda: PLBert(plbert_cfg),
        "bert_encoder": lambda: nn.Linear(plbert_cfg.hidden_size, mp.hidden_dim),
        "predictor": lambda: ProsodyPredictor(mp.style_dim, mp.hidden_dim, mp.n_layer,
                                              mp.max_dur),
        "decoder": lambda: decoder_cls(mp.decoder, mp.hidden_dim, mp.style_dim, decoder_width,
                                       decoder_asr_res_ch),
        "text_encoder": lambda: TextEncoder(mp.n_token, mp.hidden_dim, 5, mp.n_layer),
        "diffusion": lambda: nn.ModuleDict({"transformer": Denoiser(
            channels=mp.style_dim * 2, context_embedding_features=plbert_cfg.hidden_size,
            num_layers=tr.num_layers, num_heads=tr.num_heads,
            head_features=tr.head_features, multiplier=tr.multiplier,
            embedding_max_length=plbert_cfg.max_position_embeddings,
            style_dim=mp.style_dim * 2 if mp.multispeaker else None)}),
        "style_encoder": lambda: StyleEncoder(mp.dim_in, mp.style_dim, mp.hidden_dim),
        "predictor_encoder": lambda: StyleEncoder(mp.dim_in, mp.style_dim, mp.hidden_dim),
        "text_aligner": lambda: ASRCNN(asr_cfg or ASRConfig(n_token=mp.n_token)),
        "pitch_extractor": lambda: JDC(jdc_cfg),
        "mpd": lambda: MultiPeriodDiscriminator(mpd_channels),
        "msd": lambda: MultiResSpecDiscriminator(msd_width),
        "slm_encoder": lambda: WhisperEncoder(whisper_cfg),
        "wd": lambda: WhisperDiscriminator(mp.slm.hidden, mp.slm.nlayers,
                                           mp.slm.initial_channel),
    }
    unknown = [n for n in nets if n not in makers]
    if unknown:
        raise NotImplementedError(f"the port has no net {unknown}")
    return nn.ModuleDict({name: makers[name]() for name in nets})


# the generator convs the JAX package draws with ``jinit_hifigan``: the MRF
# and noise resblocks' convs and ``conv_post`` (resblock.py:32-35, istftnet.py:76)
_HIFIGAN_CONVS = re.compile(r"^generator\.((resblocks|noise_res)\.\d+\.convs[12]\.\d+"
                            r"|conv_post)$")
# the aligner's tanh-gain LinearNorms (asr.py:196-208)
_TANH_GAIN = ("query_layer", "memory_layer", "location_dense")
_PLAIN_ALIGNER_LINEARS = ("asr_s2s.project_to_n_symbols", "duration_predictor.2")
_NORMS = (nn.LayerNorm, nn.GroupNorm, ChannelLayerNorm, BatchNormStats)


def _kernel_init(net: str, prefix: str, module: nn.Module, root: nn.Module
                 ) -> Callable[[torch.Tensor, torch.Generator], torch.Tensor]:
    """How the JAX ``build_zoo`` draws the kernel of ``module`` (at
    ``prefix`` in the net ``net``, whose module is ``root``)."""
    if net in ("bert", "slm_encoder"):          # HF init (plbert.py:40, whisper.py:100)
        return lambda t, g: tinit.normal_(t, g, 0.02)
    if net == "text_aligner":
        if prefix == "asr_s2s.embedding":       # U(+-sqrt(6 / d)), d = hidden / 2
            bound = math.sqrt(6.0 / (root.cfg.hidden_dim // 2))
            return lambda t, g: tinit.uniform_(t, g, bound)
        if prefix.endswith(("linear_layer", "conv")):   # ConvNorm/LinearNorm: xavier
            gain = 5.0 / 3.0 if any(n in prefix for n in _TANH_GAIN) else 1.0
            return lambda t, g: tinit.xavier_uniform_(t, g, gain)
        if not isinstance(module, nn.Embedding) and prefix not in _PLAIN_ALIGNER_LINEARS:
            raise NotImplementedError(f"no reference init for text_aligner.{prefix}")
    if isinstance(module, nn.Embedding):        # common.py:136
        return tinit.normal_
    if ((net == "pitch_extractor" and isinstance(module, nn.Conv2d))
            or (net == "decoder" and _HIFIGAN_CONVS.match(prefix))):
        return tinit.hifigan_conv_
    if net == "predictor" and prefix == "duration_proj.linear_layer":
        return tinit.xavier_uniform_
    return tinit.kaiming_uniform_


def _init_module_(net: str, prefix: str, module: nn.Module, root: nn.Module,
                  generator: torch.Generator) -> None:
    """Draw the tensors ``module`` itself holds (not its children's)."""
    own = dict(module.named_parameters(recurse=False))
    own.update(module.named_buffers(recurse=False))
    if not own:
        return
    if isinstance(module, (nn.LSTM, nn.LSTMCell)):
        for t in own.values():
            tinit.uniform_sqrt_hidden_(t, generator, module.hidden_size)
    elif isinstance(module, _NORMS):
        for name, t in own.items():
            t.fill_(1.0 if name in ("weight", "gamma", "running_var") else 0.0)
    elif isinstance(module, nn.ParameterList) and re.search(r"(^|\.)alpha(s|[12])$", prefix):
        for t in own.values():                  # Snake alphas (resblock.py:38-39, hifigan.py:48)
            t.fill_(1.0)
    elif isinstance(module, _LearnedPositional):
        tinit.normal_(own["weights"], generator)
    else:
        kernel_name = next((n for n in ("weight", "weight_orig", "weight_v") if n in own), None)
        extra = set(own) - {kernel_name, "bias", "weight_g", "weight_u", "weight_v"}
        if kernel_name is None or extra:
            raise NotImplementedError(f"no reference init for {net}.{prefix} "
                                      f"({type(module).__name__}: {sorted(own)})")
        kernel = own[kernel_name]
        _kernel_init(net, prefix, module, root)(kernel, generator)
        if kernel_name == "weight_v":           # weight norm: g = ||v|| (common.py:67-75)
            dims = tuple(range(1, kernel.ndim))
            own["weight_g"].copy_(torch.sqrt(torch.sum(kernel * kernel, dim=dims,
                                                       keepdim=True)))
        if kernel_name == "weight_orig":        # spectral norm: u ~ N(0, 1), unit
            u = tinit.normal_(own["weight_u"], generator)
            u.div_(torch.linalg.vector_norm(u))
        if own.get("bias") is not None:
            if net in ("bert", "slm_encoder"):
                own["bias"].zero_()
            else:
                tinit.conv_bias_(own["bias"], generator, kernel.shape)


@torch.no_grad()
def init_reference_(nets: nn.ModuleDict, generator: torch.Generator) -> nn.ModuleDict:
    """Fill every tensor of ``nets`` from the distribution the JAX package's
    ``build_zoo`` draws it from (``styletts2_tpu/models/zoo.py:32-81``),
    net by net: torch's defaults (kaiming-uniform kernels, fan-in uniform
    biases, U(+-1/sqrt(H)) LSTMs, N(0, 1) embeddings, unit norms), the
    aligner's xavier ConvNorm/LinearNorm, the generator's and pitch
    extractor's N(0, 0.01) HiFi-GAN convs, the predictor's xavier duration
    head, and N(0, 0.02) with zero biases in PL-BERT and Whisper.  Weight
    norm's ``weight_g`` is ``||weight_v||`` per output channel; spectral
    norm's vectors start from a unit normal ``weight_u`` and are converged
    by 15 power iterations (``common.py:91-115``).  The draws come from
    ``generator`` (a CPU generator), in module order: the distributions are
    the JAX package's, the streams are not."""
    for net_name, net in nets.items():
        for prefix, module in net.named_modules():
            _init_module_(net_name, prefix, module, net, generator)
    for m in nets.modules():
        if isinstance(m, SNConv2d):
            m.converge_()
    return nets


@torch.no_grad()
def init_random_(nets: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from ``numpy.random.default_rng(seed)``, in
    ``state_dict`` order, with the JAX package's ``materialize_params`` rule:
    standard normals scaled by 0.5/sqrt(fan_in) for tensors of rank >= 2
    (flat 0.05 normals overflow the iSTFT head's exp()), 0.05 for vectors,
    1 + that for norm scales (1-D ``weight``) and 1 + |that| for batch-norm
    ``running_var``.  Then every spectral-norm conv runs its power iteration
    to convergence: random ``weight_u``/``weight_v`` give a wildly wrong
    sigma and blow the forward up."""
    rng = np.random.default_rng(seed)
    for name, p in nets.state_dict(keep_vars=True).items():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if a.ndim >= 2:
            a *= 0.5 / np.sqrt(max(int(np.prod(a.shape[1:])), 1))
        else:
            a *= 0.05
            if name.endswith("running_var"):
                a = np.abs(a) + 1.0
            elif name.endswith("weight"):
                a += 1.0
        p.copy_(torch.from_numpy(a))
    for m in nets.modules():
        if isinstance(m, SNConv2d):
            m.converge_()
    return nets


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> dot-joined flat mapping."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def nest(flat: Mapping[str, Any]) -> Dict:
    """Dot-joined flat mapping -> nested dict."""
    out: Dict = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


@torch.no_grad()
def load_jax_params(nets: Mapping[str, nn.Module], zoo_np: Mapping) -> Mapping:
    """Load the JAX package's parameter tree (nested dicts of numpy arrays,
    keyed by net name) into ``nets`` (a ModuleDict, or a dict of some of its
    nets), each net with ``strict=True``."""
    for name, net in nets.items():
        state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
                 for k, v in flatten(zoo_np[name]).items()}
        net.load_state_dict(state, strict=True)
    return nets


def export_params(nets: nn.ModuleDict) -> Dict:
    """The inverse of ``load_jax_params``: nested dicts of numpy arrays."""
    return {name: nest({k: v.detach().cpu().numpy() for k, v in net.state_dict().items()})
            for name, net in nets.items()}
