"""The ASR text aligner (ref: Utils/ASR/models.py, Utils/ASR/layers.py): the
default path the shipped checkpoints use.

Mel -> MFCC (DCT matmul) -> strided conv stem -> ``n_layers`` dilated-conv
encoder stages with GroupNorms -> projection.  Heads: the CTC linear and the
attention seq2seq decoder whose location-sensitive attention gives the
text <-> mel alignment (``s2s_attn``) stage-1 training reads.  The decode is
a Python loop over the ``T_text + 1`` steps.

The fork's multi-task heads, stochastic depth and gradient checkpointing are
not ported: ``ASRConfig`` refuses a configuration that turns them on.
Dropout takes explicit keep masks (``ASRNoise``); without them the forward
is the eval one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import conv1d
from ..nn.linear import linear
from ..nn.lstm import lstm_step
from . import common as cm


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    input_dim: int = 80
    hidden_dim: int = 256
    n_token: int = 178
    n_layers: int = 5
    token_embedding_dim: int = 512
    location_kernel_size: int = 31
    n_mfcc: int = 40
    n_location_filters: int = 32
    sos: int = 1
    unk_index: int = 3
    random_mask: float = 0.1
    # the fork's optional heads and training tricks (off in the shipped
    # checkpoints); not ported
    intermediate_ctc_layers: tuple = ()
    self_conditioned_layers: tuple = ()
    enable_frame_classifier: bool = False
    frame_num_classes: int = 0
    enable_speaker: bool = False
    num_speakers: int = 0
    speaker_embedding_dim: int = 0
    enable_pron_error: bool = False
    pron_error_classes: int = 2
    stochastic_depth_rate: float = 0.0
    gradient_checkpointing: bool = False

    def __post_init__(self):
        unported = [name for name, on in (
            ("intermediate_ctc_layers", bool(self.intermediate_ctc_layers)),
            ("self_conditioned_layers", bool(self.self_conditioned_layers)),
            ("enable_frame_classifier", self.enable_frame_classifier),
            ("enable_speaker", self.enable_speaker),
            ("enable_pron_error", self.enable_pron_error),
            ("stochastic_depth_rate", self.stochastic_depth_rate > 0),
            ("gradient_checkpointing", self.gradient_checkpointing)) if on]
        if unported:
            raise NotImplementedError(f"the port's aligner has no {', '.join(unported)} "
                                      "(the fork's multi-task options; ROADMAP.md)")


CONV_DROPOUT = 0.2
HIDDEN_DROPOUT = 0.5


@dataclasses.dataclass
class ASRNoise:
    """Keep masks of the aligner's dropout sites and its token masking; a
    field left None switches that site off.

    conv_keep (n_layers, 3, 2, B, hidden, L) bool: the two dropouts of each
    conv block; hidden_keep (T_text + 1, B, hidden // 2) bool: the decoder's
    per-step dropout; token_unk (B, T_text) bool: tokens replaced by ``unk``.
    """

    conv_keep: Optional[torch.Tensor] = None
    hidden_keep: Optional[torch.Tensor] = None
    token_unk: Optional[torch.Tensor] = None

    @classmethod
    def draw(cls, generator: torch.Generator, cfg: ASRConfig, batch: int, t_text: int,
             length: int, device) -> "ASRNoise":
        """Masks at the training rates from ``generator`` (on ``device``)."""
        def u(*shape):
            return torch.rand(shape, generator=generator, device=device)
        h = cfg.hidden_dim
        return cls(conv_keep=u(cfg.n_layers, 3, 2, batch, h, length) < 1.0 - CONV_DROPOUT,
                   hidden_keep=u(t_text + 1, batch, h // 2) < 1.0 - HIDDEN_DROPOUT,
                   token_unk=u(batch, t_text) < cfg.random_mask)


def _conv_norm(i: int, o: int, k: int = 1, bias: bool = True) -> nn.ModuleDict:
    return nn.ModuleDict({"conv": nn.Conv1d(i, o, k, bias=bias)})


def _linear_norm(i: int, o: int, bias: bool = True) -> nn.ModuleDict:
    return nn.ModuleDict({"linear_layer": nn.Linear(i, o, bias=bias)})


class _ConvBlock(nn.Module):
    def __init__(self, hidden: int, n_conv: int = 3):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"0": _conv_norm(hidden, hidden, 3), "2": nn.GroupNorm(8, hidden),
                           "4": _conv_norm(hidden, hidden, 3)})
            for _ in range(n_conv))


class _EncoderLayer(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.block = _ConvBlock(hidden)
        self.post_norm = nn.GroupNorm(1, hidden)


class ASRS2S(nn.Module):
    def __init__(self, cfg: ASRConfig):
        super().__init__()
        d = cfg.hidden_dim // 2
        self.embedding = nn.Embedding(cfg.n_token, cfg.token_embedding_dim)
        self.project_to_n_symbols = nn.Linear(d, cfg.n_token)
        self.attention_layer = nn.ModuleDict({
            "query_layer": _linear_norm(d, d, bias=False),
            "memory_layer": _linear_norm(d, d, bias=False),
            "v": _linear_norm(d, 1, bias=False),
            "location_layer": nn.ModuleDict({
                "location_conv": _conv_norm(2, cfg.n_location_filters,
                                            cfg.location_kernel_size, bias=False),
                "location_dense": _linear_norm(cfg.n_location_filters, d, bias=False)}),
        })
        self.project_to_hidden = nn.ModuleDict({"0": _linear_norm(d * 2, d)})
        self.decoder_rnn = nn.LSTMCell(d + cfg.token_embedding_dim, d)


class ASRCNN(nn.Module):
    def __init__(self, cfg: ASRConfig = ASRConfig()):
        super().__init__()
        h = cfg.hidden_dim
        self.cfg = cfg
        self.init_cnn = _conv_norm(cfg.n_mfcc, h, 7)
        self.encoder_layers = nn.ModuleList(_EncoderLayer(h) for _ in range(cfg.n_layers))
        self.projection = _conv_norm(h, h // 2)
        self.ctc_linear = nn.ModuleDict({"0": _linear_norm(h // 2, h),
                                         "2": _linear_norm(h, cfg.n_token)})
        self.duration_predictor = nn.ModuleDict({
            "0": nn.Embedding(cfg.n_token, max(4, h // 16)),
            "2": nn.Linear(max(4, h // 16), 1)})
        self.asr_s2s = ASRS2S(cfg)


@functools.lru_cache(maxsize=None)
def _dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """torchaudio ``create_dct(n_mfcc, n_mels, 'ortho')`` -> (n_mels, n_mfcc)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / n_mels * (n[None, :] + 0.5) * k)
    dct *= np.sqrt(2.0 / n_mels)
    dct[0] *= 1.0 / np.sqrt(2.0)
    return dct.T.astype(np.float32)


def _conv(m: nn.ModuleDict, x: torch.Tensor, **kw) -> torch.Tensor:
    return conv1d(x, m["conv"].weight, m["conv"].bias, **kw)


def _lin(m: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    return linear(x, m["linear_layer"].weight, m["linear_layer"].bias)


def _group_norm(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, m.num_groups, m.weight, m.bias, eps=1e-5)


def asr_encode(m: ASRCNN, mels: torch.Tensor,
               conv_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mel (B, 80, T) -> encoder features (B, T//2, hidden//2)."""
    cfg = m.cfg
    mels = cm.autocast(m, mels)
    dct = torch.from_numpy(_dct_matrix(cfg.n_mfcc, cfg.input_dim)).to(mels)
    mfcc = (mels.transpose(1, 2) @ dct).transpose(1, 2)       # (B, 40, T)
    x = _conv(m.init_cnn, mfcc, stride=2, padding=3)
    for i, layer in enumerate(m.encoder_layers):
        for j, blk in enumerate(layer.block.blocks):
            keep = (None, None) if conv_keep is None else (conv_keep[i, j, 0], conv_keep[i, j, 1])
            dil = 3 ** j
            h = torch.relu(_conv(blk["0"], x, padding=dil, dilation=dil))
            h = cm.dropout(_group_norm(blk["2"], h), keep[0], CONV_DROPOUT)
            h = torch.relu(_conv(blk["4"], h, padding=1))
            x = cm.dropout(h, keep[1], CONV_DROPOUT) + x
        x = _group_norm(layer.post_norm, x)
    return _conv(m.projection, x).transpose(1, 2)


def asr_s2s_apply(m: ASRS2S, cfg: ASRConfig, memory: torch.Tensor,
                  memory_pad_mask: torch.Tensor, text: torch.Tensor,
                  noise: Optional[ASRNoise] = None):
    """The location-sensitive seq2seq decode (ref: Utils/ASR/models.py:742-803).

    memory (B, L, d), memory_pad_mask (B, L) True at padding, text (B, T) ids
    -> (hidden (B, T+1, d), logits (B, T+1, n_token), attn (B, T+1, L)).
    """
    noise = noise or ASRNoise()
    att = m.attention_layer
    b, length, d = memory.shape
    if noise.token_unk is not None:
        text = torch.where(noise.token_unk, torch.full_like(text, cfg.unk_index), text)
    emb = cm.embedding(m.embedding, text)                     # (B, T, E)
    sos = m.embedding.weight[cfg.sos].expand(b, 1, emb.shape[-1])
    dec_inputs = torch.cat([sos, emb], dim=1)                  # (B, T+1, E)

    processed_memory = memory @ att["memory_layer"]["linear_layer"].weight.t()
    loc_w = att["location_layer"]["location_conv"]["conv"].weight
    loc_dense_w = att["location_layer"]["location_dense"]["linear_layer"].weight
    query_w = att["query_layer"]["linear_layer"].weight
    v_w = att["v"]["linear_layer"].weight
    neg_inf = torch.finfo(memory.dtype).min
    hid_proj = m.project_to_hidden["0"]

    zeros = memory.new_zeros
    h, c, context = zeros((b, d)), zeros((b, d)), zeros((b, d))
    attn_w, attn_cum = zeros((b, length)), zeros((b, length))
    hiddens, logits, attns = [], [], []
    for step in range(dec_inputs.shape[1]):
        h, c = lstm_step(m.decoder_rnn, torch.cat([dec_inputs[:, step], context], dim=-1), h, c)
        loc = conv1d(torch.stack([attn_w, attn_cum], dim=1), loc_w,
                     padding=(cfg.location_kernel_size - 1) // 2)
        loc = loc.transpose(1, 2) @ loc_dense_w.t()            # (B, L, d)
        q = (h @ query_w.t())[:, None, :]
        energies = (torch.tanh(q + loc + processed_memory) @ v_w.t())[..., 0]
        energies = energies.masked_fill(memory_pad_mask, neg_inf)
        attn_w = torch.softmax(energies, dim=1)
        context = torch.einsum("bl,bld->bd", attn_w, memory)
        attn_cum = attn_cum + attn_w
        hid = torch.tanh(_lin(hid_proj, torch.cat([h, context], dim=-1)))
        keep = None if noise.hidden_keep is None else noise.hidden_keep[step]
        logit = linear(cm.dropout(hid, keep, HIDDEN_DROPOUT), m.project_to_n_symbols.weight,
                       m.project_to_n_symbols.bias)
        hiddens.append(hid)
        logits.append(logit)
        attns.append(attn_w)
    return torch.stack(hiddens, 1), torch.stack(logits, 1), torch.stack(attns, 1)


def asr_apply(m: ASRCNN, mels: torch.Tensor, memory_pad_mask: torch.Tensor,
              text: torch.Tensor, noise: Optional[ASRNoise] = None) -> Dict[str, torch.Tensor]:
    """The aligner forward (ref: Utils/ASR/models.py:377-535): mels (B, 80, T),
    memory_pad_mask (B, T//2) True at padding, text (B, T_text) ->
    ``ctc_logits``, ``encoder_features``, ``s2s_hidden``, ``s2s_logits``,
    ``s2s_attn``, ``duration_predictions``."""
    memory = asr_encode(m, mels, None if noise is None else noise.conv_keep)
    h = torch.relu(_lin(m.ctc_linear["0"], memory))
    ctc_logits = _lin(m.ctc_linear["2"], h)
    hidden, s2s_logits, s2s_attn = asr_s2s_apply(m.asr_s2s, m.cfg, memory, memory_pad_mask,
                                                 text, noise)
    dp = m.duration_predictor
    dur = F.softplus(linear(torch.relu(cm.embedding(dp["0"], text)), dp["2"].weight,
                            dp["2"].bias))
    return {"ctc_logits": ctc_logits, "encoder_features": memory, "s2s_hidden": hidden,
            "s2s_logits": s2s_logits, "s2s_attn": s2s_attn, "duration_predictions": dur}
