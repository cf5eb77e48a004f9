"""``models.zoo.init_reference_`` against the JAX package's ``build_zoo``,
net by net, at a tiny size: the JAX package's ``testing.py`` configuration
with one MRF kernel size, and the full MPD.  The JAX trees are drawn by the
``init_*`` functions ``build_zoo`` calls, with its arguments, each net in
its own jit (one jit of ``build_zoo`` compiles for minutes on a CPU); their
structure is held against ``jax.eval_shape(build_zoo)``.

The streams differ (torch's generator against ``jax.random``), so leaves
are held by what a seed cannot change:
- every leaf has the JAX leaf's shape;
- constant leaves (unit norms, zero biases, batch-norm statistics, Snake
  alphas) equal the JAX ones exactly, and ``weight_g`` is exactly
  ``||weight_v||`` per output channel;
- the spectral-norm vectors are unit vectors, ``u = W v / ||W v||`` as the
  last power iteration leaves them, with ``u^T W v`` within 10% of the
  largest singular value after 15 iterations, as in JAX;
- leaves of >= 4096 elements match the JAX leaf's family, std and
  largest values.  At n >= 4096 draws the sample std of a uniform or a
  normal leaf spreads by under 1.1% (1 / sqrt(2n) for a normal,
  sqrt(0.8 / 4n) for a uniform), so two independent leaves differ by
  < 1.6% at one sigma: within 5% is three sigma.  A uniform leaf's max |x|
  is its bound to within 1 / n, so its max |x| is held within 10%.  A
  normal leaf's max of n draws is no such bound: it lies near
  sqrt(2 ln n) sigma with a spread of ~1.28 / sqrt(2 ln n) sigma, and two
  leaves of 5728 draws (the text encoder's embedding) measured 3.52 and
  4.21: 16% apart with both right.  So a normal leaf's largest values are
  held by the 99th percentile of |x| within 10% (its spread at n >= 4096 is
  ~2%), and the family by the sample kurtosis (uniform 1.8, normal 3.0;
  spread ~0.08 at n = 4096), within 0.5.  Leaves of 256-4095 elements,
  most of the tiny aligner's and decoder's, are held by their std within
  5 / sqrt(n) (five sigma of the difference between two leaves' stds;
  31% at 256, 16% at 1024): enough to tell kaiming from xavier, the
  aligner's tanh gain or N(0, 0.01) apart.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from styletts2_tpu.models import common as j_cm
from styletts2_tpu.models.asr import ASRConfig as JASRConfig
from styletts2_tpu.models.asr import init_asr
from styletts2_tpu.models.decoder.istftnet import init_decoder
from styletts2_tpu.models.diffusion.denoiser import init_denoiser
from styletts2_tpu.models.discriminators import init_mpd, init_msd, init_whisper_discriminator
from styletts2_tpu.models.jdc import JDCConfig as JJDCConfig
from styletts2_tpu.models.jdc import init_jdc
from styletts2_tpu.models.plbert import PLBertConfig as JPLBertConfig
from styletts2_tpu.models.plbert import init_plbert
from styletts2_tpu.models.predictor import init_prosody_predictor
from styletts2_tpu.models.style_encoder import init_style_encoder
from styletts2_tpu.models.text_encoder import init_text_encoder
from styletts2_tpu.models.whisper import init_whisper_encoder
from styletts2_tpu.models.zoo import build_zoo
from styletts2_tpu.testing import tiny_model_params, tiny_whisper_cfg
from styletts2_tpu_torch.config import ModelParams, _build
from styletts2_tpu_torch.models.asr import ASRConfig
from styletts2_tpu_torch.models.common import SNConv2d
from styletts2_tpu_torch.models.jdc import JDCConfig
from styletts2_tpu_torch.models.plbert import PLBertConfig
from styletts2_tpu_torch.models.whisper import WhisperConfig
from styletts2_tpu_torch.models.zoo import (STAGE2_NETS, build_nets, export_params, flatten,
                                            init_reference_)

torch.set_num_threads(1)

PORT_NETS = STAGE2_NETS
PLBERT = dict(vocab_size=179, embedding_size=8, hidden_size=24, num_attention_heads=2,
              intermediate_size=32, max_position_embeddings=64, num_hidden_layers=1)
ASR = dict(hidden_dim=32, n_layers=1, n_token=179, token_embedding_dim=16,
           location_kernel_size=7)
JDC = dict(lstm_hidden=8, lstm_layers=1)
WIDTH, ASR_RES = 64, 8


def jax_model_params():
    jmp = tiny_model_params()
    return dataclasses.replace(jmp, decoder=dataclasses.replace(
        jmp.decoder, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),)))


def jax_inits(jmp, pl, wcfg):
    """The ``init_*`` call of each port net, as ``build_zoo`` makes it
    (``styletts2_tpu/models/zoo.py:47-81``)."""
    tr = jmp.diffusion.transformer
    return {
        "bert": lambda k: init_plbert(k, pl),
        "bert_encoder": lambda k: j_cm.init_linear(k, pl.hidden_size, jmp.hidden_dim),
        "predictor": lambda k: init_prosody_predictor(k, jmp.style_dim, jmp.hidden_dim,
                                                      jmp.n_layer, jmp.max_dur),
        "decoder": lambda k: init_decoder(k, jmp.decoder, jmp.hidden_dim, jmp.style_dim,
                                          width=WIDTH, asr_res_ch=ASR_RES),
        "text_encoder": lambda k: init_text_encoder(k, jmp.n_token, jmp.hidden_dim,
                                                    kernel_size=5, depth=jmp.n_layer),
        "style_encoder": lambda k: init_style_encoder(k, jmp.dim_in, jmp.style_dim,
                                                      jmp.hidden_dim),
        "predictor_encoder": lambda k: init_style_encoder(k, jmp.dim_in, jmp.style_dim,
                                                          jmp.hidden_dim),
        "diffusion": lambda k: {"transformer": init_denoiser(
            k, channels=jmp.style_dim * 2, context_embedding_features=pl.hidden_size,
            num_layers=tr.num_layers, num_heads=tr.num_heads,
            head_features=tr.head_features, multiplier=tr.multiplier,
            embedding_max_length=pl.max_position_embeddings)},
        "text_aligner": lambda k: init_asr(k, JASRConfig(**ASR)),
        "pitch_extractor": lambda k: init_jdc(k, JJDCConfig(**JDC)),
        "mpd": init_mpd,
        "msd": init_msd,
        "slm_encoder": lambda k: init_whisper_encoder(k, wcfg),
        "wd": lambda k: init_whisper_discriminator(k, jmp.slm.hidden, jmp.slm.nlayers,
                                                   jmp.slm.initial_channel),
    }


@functools.lru_cache(maxsize=None)
def trees():
    """(JAX leaves, port leaves, port nets), flat by ``net.key``, and the
    shapes of ``jax.eval_shape(build_zoo)``."""
    jmp, pl, wcfg = jax_model_params(), JPLBertConfig(**PLBERT), tiny_whisper_cfg()
    inits = jax_inits(jmp, pl, wcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), len(inits))
    with ThreadPoolExecutor(4) as pool:
        drawn = pool.map(lambda fk: jax.block_until_ready(jax.jit(fk[0])(fk[1])),
                         zip(inits.values(), keys))
        zoo = dict(zip(inits, drawn))
    theirs = {f"{n}.{k}": np.asarray(v) for n in PORT_NETS for k, v in flatten(zoo[n]).items()}
    shapes = jax.eval_shape(lambda k: build_zoo(
        k, jmp, pl, JASRConfig(**ASR), JJDCConfig(**JDC), wcfg, decoder_width=WIDTH,
        decoder_asr_res_ch=ASR_RES), jax.random.PRNGKey(0))
    shapes = {f"{n}.{k}": tuple(v.shape) for n in PORT_NETS
              for k, v in flatten(shapes[n]).items()}
    nets = build_nets(_build(ModelParams, dataclasses.asdict(jmp)), PLBertConfig(**PLBERT),
                      decoder_width=WIDTH, decoder_asr_res_ch=ASR_RES, nets=PORT_NETS,
                      asr_cfg=ASRConfig(**ASR), jdc_cfg=JDCConfig(**JDC),
                      whisper_cfg=_build(WhisperConfig, dataclasses.asdict(wcfg)))
    init_reference_(nets, torch.Generator().manual_seed(0))
    ours = {f"{n}.{k}": v for n, tree in export_params(nets).items()
            for k, v in flatten(tree).items()}
    return theirs, ours, nets, shapes


def _constant(a):
    return a.size >= 2 and bool(np.all(a == a.flat[0]))


def _kurtosis(a):
    a = a - a.mean()
    return float(np.mean(a ** 4) / np.mean(a ** 2) ** 2)


def test_every_leaf_has_the_jax_shape():
    theirs, ours, _, shapes = trees()
    assert sorted(ours) == sorted(theirs) == sorted(shapes)
    for k, v in theirs.items():
        assert ours[k].shape == v.shape == shapes[k], k


def test_constant_leaves_and_weight_norm_gains_exact():
    theirs, ours, nets, _ = trees()
    constant = [k for k, v in theirs.items() if _constant(v)]
    assert len(constant) > 50
    for k in constant:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    gains = 0
    for m in nets.modules():
        if isinstance(getattr(m, "weight_g", None), torch.nn.Parameter):
            v = m.weight_v
            norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
            assert torch.equal(m.weight_g, norm)
            gains += 1
    assert gains > 100


def test_spectral_norm_vectors_converged_as_in_jax():
    theirs, _, nets, _ = trees()
    names = [n for n, m in nets["style_encoder"].named_modules() if isinstance(m, SNConv2d)]
    assert len(names) >= 10
    for name in names:
        m = nets["style_encoder"].get_submodule(name)
        ju = theirs[f"style_encoder.{name}.weight_u"]
        jv = theirs[f"style_encoder.{name}.weight_v"]
        jw = theirs[f"style_encoder.{name}.weight_orig"].reshape(len(ju), -1)
        w = m.weight_orig.detach().reshape(len(ju), -1)
        for u, v, mat in ((m.weight_u, m.weight_v, w),
                          (torch.from_numpy(ju), torch.from_numpy(jv), torch.from_numpy(jw))):
            assert abs(float(torch.linalg.vector_norm(u)) - 1.0) < 1e-6
            assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-6
            wv = mat @ v
            torch.testing.assert_close(u, wv / torch.linalg.vector_norm(wv), atol=1e-6,
                                       rtol=0)
            sigma = float(u @ wv)
            top = float(torch.linalg.matrix_norm(mat.double(), 2))
            assert abs(sigma - top) <= 0.1 * top, (name, sigma, top)


@pytest.mark.parametrize("net", PORT_NETS)
def test_large_leaves_match_the_jax_distributions(net):
    theirs, ours, _, _ = trees()
    mine = [k for k, v in theirs.items()
            if k.startswith(net + ".") and v.size >= 256 and not _constant(v)]
    for k in mine:
        a, b = ours[k].astype(np.float64), theirs[k].astype(np.float64)
        assert abs(a.std() / b.std() - 1.0) <= 5.0 / np.sqrt(a.size), (k, a.std(), b.std())
    for k in (k for k in mine if theirs[k].size >= 4096):
        a, b = ours[k].astype(np.float64), theirs[k].astype(np.float64)
        assert abs(a.std() / b.std() - 1.0) <= 0.05, (k, a.std(), b.std())
        kurt = _kurtosis(b)
        assert abs(_kurtosis(a) - kurt) <= 0.5, (k, _kurtosis(a), kurt)
        top = (lambda x: np.abs(x).max()) if kurt < 2.4 else (
            lambda x: np.quantile(np.abs(x), 0.99))
        assert abs(top(a) / top(b) - 1.0) <= 0.10, (k, top(a), top(b))
