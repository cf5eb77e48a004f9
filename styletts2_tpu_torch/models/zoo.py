"""The nets of the LJSpeech zoo (ref: models.py:1002-1110): the inference
nets, stage 1's aligner, pitch extractor and style encoder, and its TMA
phase's discriminators and Whisper encoder; a seeded
random initialisation; and the bridge from the JAX package's parameter
trees.

The JAX package keys its parameter trees by the reference torch
``state_dict`` names, so each net here has ``state_dict`` keys equal to the
dot-joined keys of the matching JAX subtree, and loading one is
``load_state_dict(flatten(tree), strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import ModelParams
from .asr import ASRCNN, ASRConfig
from .common import SNConv2d
from .decoder.istftnet import Decoder
from .diffusion.denoiser import Denoiser
from .discriminators import MPD_CHANNELS, MultiPeriodDiscriminator, MultiResSpecDiscriminator
from .jdc import JDC, JDCConfig
from .plbert import PLBert, PLBertConfig
from .predictor import ProsodyPredictor
from .style_encoder import StyleEncoder
from .text_encoder import TextEncoder
from .whisper import WhisperConfig, WhisperEncoder

INFERENCE_NETS = ("bert", "bert_encoder", "predictor", "decoder", "text_encoder",
                  "diffusion")
# stage 1 before TMA: the trained text encoder, style encoder and decoder,
# and the frozen aligner and pitch extractor
STAGE1_NETS = ("text_encoder", "style_encoder", "decoder", "text_aligner", "pitch_extractor")
# stage 1 from TMA on: the discriminators and the frozen Whisper encoder too
STAGE1_TMA_NETS = STAGE1_NETS + ("mpd", "msd", "slm_encoder")


def build_nets(mp: ModelParams, plbert_cfg: PLBertConfig = PLBertConfig(),
               decoder_width: int = 1024, decoder_asr_res_ch: int = 64,
               nets: Sequence[str] = INFERENCE_NETS, asr_cfg: Optional[ASRConfig] = None,
               jdc_cfg: JDCConfig = JDCConfig(),
               whisper_cfg: WhisperConfig = WhisperConfig(),
               mpd_channels: Sequence[int] = MPD_CHANNELS, msd_width: int = 32
               ) -> nn.ModuleDict:
    """The named nets of the single-speaker zoo with zero-filled parameters
    (fill them with ``init_random_`` or ``load_jax_params``).  ``asr_cfg``
    defaults to ``ASRConfig(n_token=mp.n_token)``; ``whisper_cfg`` sizes
    the ``slm_encoder`` (Whisper-base by default)."""
    if mp.multispeaker or mp.decoder.type != "istftnet":
        raise NotImplementedError("the port builds the single-speaker iSTFTNet zoo only")
    tr = mp.diffusion.transformer
    makers = {
        "bert": lambda: PLBert(plbert_cfg),
        "bert_encoder": lambda: nn.Linear(plbert_cfg.hidden_size, mp.hidden_dim),
        "predictor": lambda: ProsodyPredictor(mp.style_dim, mp.hidden_dim, mp.n_layer,
                                              mp.max_dur),
        "decoder": lambda: Decoder(mp.decoder, mp.hidden_dim, mp.style_dim, decoder_width,
                                   decoder_asr_res_ch),
        "text_encoder": lambda: TextEncoder(mp.n_token, mp.hidden_dim, 5, mp.n_layer),
        "diffusion": lambda: nn.ModuleDict({"transformer": Denoiser(
            channels=mp.style_dim * 2, context_embedding_features=plbert_cfg.hidden_size,
            num_layers=tr.num_layers, num_heads=tr.num_heads,
            head_features=tr.head_features, multiplier=tr.multiplier,
            embedding_max_length=plbert_cfg.max_position_embeddings)}),
        "style_encoder": lambda: StyleEncoder(mp.dim_in, mp.style_dim, mp.hidden_dim),
        "text_aligner": lambda: ASRCNN(asr_cfg or ASRConfig(n_token=mp.n_token)),
        "pitch_extractor": lambda: JDC(jdc_cfg),
        "mpd": lambda: MultiPeriodDiscriminator(mpd_channels),
        "msd": lambda: MultiResSpecDiscriminator(msd_width),
        "slm_encoder": lambda: WhisperEncoder(whisper_cfg),
    }
    unknown = [n for n in nets if n not in makers]
    if unknown:
        raise NotImplementedError(f"the port has no net {unknown}")
    return nn.ModuleDict({name: makers[name]() for name in nets})


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
def load_jax_params(nets: nn.ModuleDict, zoo_np: Mapping) -> nn.ModuleDict:
    """Load the JAX package's parameter tree (nested dicts of numpy arrays,
    keyed by net name) into ``nets``, each net with ``strict=True``."""
    for name, net in nets.items():
        state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
                 for k, v in flatten(zoo_np[name]).items()}
        net.load_state_dict(state, strict=True)
    return nets


def export_params(nets: nn.ModuleDict) -> Dict:
    """The inverse of ``load_jax_params``: nested dicts of numpy arrays."""
    return {name: nest({k: v.detach().cpu().numpy() for k, v in net.state_dict().items()})
            for name, net in nets.items()}
