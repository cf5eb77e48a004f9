"""Style-diffusion denoiser transformers, single-speaker ``Transformer1d``
and multispeaker ``StyleTransformer1d`` (ref: Modules/diffusion/modules.py).

Denoises a (B, 1, 2*style_dim) latent conditioned on PL-BERT token
embeddings, with additive time "mapping" conditioning at every block and a
mean pool over the token axis.  ``Denoiser(style_dim=...)`` is the
``StyleTransformer1d``: a reference style (``features``) joins the mapping
through ``to_features``, and its attention norms are AdaLayerNorms of it
(the JAX package's ``style_conditioned``, which its callers set exactly
for this denoiser).  Classifier-free guidance runs the conditional
and fixed-embedding branches as one doubled batch.  Attention is a plain
matmul + softmax, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...nn.activations import gelu
from ...nn.linear import linear
from ...nn.norm import ada_layer_norm, layer_norm
from .. import common as cm


class _Attention(nn.Module):
    def __init__(self, features: int, mid: int, style_dim: Optional[int] = None):
        super().__init__()
        self.to_q = nn.Linear(features, mid, bias=False)
        self.to_kv = nn.Linear(features, mid * 2, bias=False)
        self.attention = nn.ModuleDict({"to_out": nn.Linear(mid, features)})
        if style_dim is None:
            self.norm = nn.LayerNorm(features)
            self.norm_context = nn.LayerNorm(features)
        else:                                   # AdaLayerNorm (modules.py:556-584)
            self.norm = cm.StyleAffine(style_dim, features)
            self.norm_context = cm.StyleAffine(style_dim, features)


class _Block(nn.Module):
    def __init__(self, features: int, mid: int, multiplier: int,
                 style_dim: Optional[int] = None):
        super().__init__()
        self.attention = _Attention(features, mid, style_dim)
        self.feed_forward = nn.ModuleDict({
            "0": nn.Linear(features, features * multiplier),
            "2": nn.Linear(features * multiplier, features)})


class _LearnedPositional(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weights = cm._param(dim)


class Denoiser(nn.Module):
    def __init__(self, channels: int = 256, context_embedding_features: int = 768,
                 num_layers: int = 3, num_heads: int = 8, head_features: int = 64,
                 multiplier: int = 2, embedding_max_length: int = 512,
                 style_dim: Optional[int] = None):
        """``style_dim`` (the model's 2 * style_dim) makes it the
        multispeaker ``StyleTransformer1d``."""
        super().__init__()
        self.num_heads = num_heads
        features = channels + context_embedding_features
        mid = num_heads * head_features
        self.blocks = nn.ModuleDict(
            {str(i): _Block(features, mid, multiplier, style_dim) for i in range(num_layers)})
        self.to_out = nn.ModuleDict({"1": nn.Conv1d(features, channels, 1)})
        self.to_mapping = nn.ModuleDict({
            "0": nn.Linear(features, features), "2": nn.Linear(features, features)})
        self.to_time = nn.ModuleDict({"0": nn.ModuleDict({
            "0": _LearnedPositional(channels // 2),
            "1": nn.Linear(channels + 1, features)})})
        if style_dim is not None:
            self.to_features = nn.ModuleDict({"0": nn.Linear(style_dim, features)})
        self.fixed_embedding = nn.ModuleDict({
            "embedding": nn.Embedding(embedding_max_length, context_embedding_features)})


def _lin(x, mod: nn.Linear):
    return linear(x, mod.weight, mod.bias)


def _attention(p: _Attention, x: torch.Tensor, num_heads: int,
               mask: Optional[torch.Tensor],
               style: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm self-attention, LayerNorms or (``style`` given) AdaLayerNorms;
    ``mask`` (B, L) True = valid excludes pad KEYS so a padded batch
    reproduces exact-length inference."""
    if style is None:
        h = layer_norm(x, p.norm.weight, p.norm.bias)
        ctx = layer_norm(x, p.norm_context.weight, p.norm_context.bias)
    else:
        h = ada_layer_norm(p.norm, x, style)
        ctx = ada_layer_norm(p.norm_context, x, style)
    q = linear(h, p.to_q.weight)
    k, v = torch.chunk(linear(ctx, p.to_kv.weight), 2, dim=-1)
    b, n, _ = q.shape
    d = q.shape[-1] // num_heads

    def heads(t):
        return t.reshape(b, n, num_heads, d).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    sim = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
    if mask is not None:
        sim = torch.where(mask[:, None, None, :], sim, torch.full_like(sim, -1e9))
    out = torch.matmul(torch.softmax(sim, dim=-1), v)
    out = out.transpose(1, 2).reshape(b, n, num_heads * d)
    return _lin(out, p.attention["to_out"])


def _time_embedding(p: nn.ModuleDict, t: torch.Tensor) -> torch.Tensor:
    """LearnedPositionalEmbedding -> Linear (ref: modules.py:657-678)."""
    freqs = t[:, None] * p["0"].weights[None, :] * 2.0 * math.pi
    fourier = torch.cat([t[:, None], torch.sin(freqs), torch.cos(freqs)], dim=-1)
    return _lin(fourier, p["1"])


def denoiser_apply(m: Denoiser, x: torch.Tensor, time: torch.Tensor,
                   embedding: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, 1, C) noisy latent, time (B,), embedding (B, L, E),
    mask (B, L) True = valid token -> (B, 1, C).  ``features`` (B, S): the
    reference style a ``StyleTransformer1d`` needs."""
    x, time, embedding, features = cm.autocast(m, x, time, embedding, features)
    styled = hasattr(m, "to_features")
    if styled and features is None:
        raise ValueError("the StyleTransformer1d denoises with a reference style: "
                         "pass features")
    mapping = gelu(_time_embedding(m.to_time["0"], time))
    if styled:
        mapping = mapping + gelu(_lin(features, m.to_features["0"]))
    mapping = gelu(_lin(mapping, m.to_mapping["0"]))
    mapping = gelu(_lin(mapping, m.to_mapping["2"]))

    length = embedding.shape[1]
    h = torch.cat([x.expand(x.shape[0], length, x.shape[2]), embedding], dim=-1)
    style = features if styled else None
    for blk in m.blocks.values():
        h = h + mapping[:, None, :]
        h = h + _attention(blk.attention, h, m.num_heads, mask, style)
        ff = blk.feed_forward
        h = h + _lin(gelu(_lin(h, ff["0"])), ff["2"])

    if mask is None:
        h = h.mean(dim=1)
    else:
        mk = mask.to(h.dtype)[..., None]
        h = (h * mk).sum(dim=1) / torch.clamp(mk.sum(dim=1), min=1.0)
    out = m.to_out["1"]
    return linear(h, out.weight[:, :, 0], out.bias)[:, None, :]


def fixed_embedding(m: Denoiser, batch: int, length: int) -> torch.Tensor:
    """Positional fixed embedding, the CFG 'unconditional' branch
    (ref: modules.py:680-712); rows past the table repeat its last row."""
    table = m.fixed_embedding["embedding"].weight
    emb = table[:length]
    if length > table.shape[0]:
        emb = torch.cat([table, table[-1:].expand(length - table.shape[0], -1)])
    return emb[None].expand(batch, length, table.shape[1])


def denoiser_cfg_apply(m: Denoiser, x: torch.Tensor, time: torch.Tensor,
                       embedding: torch.Tensor, embedding_scale: float = 1.0,
                       mask: Optional[torch.Tensor] = None,
                       features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classifier-free-guided forward (ref: modules.py:402-427): one pass at
    scale 1, else the two branches as one doubled batch (the features
    doubled with it)."""
    if embedding_scale == 1.0:
        return denoiser_apply(m, x, time, embedding, mask, features)
    b = x.shape[0]
    fix = fixed_embedding(m, b, embedding.shape[1])

    def twice(a):
        return None if a is None else torch.cat([a, a])

    out = denoiser_apply(m, twice(x), twice(time), torch.cat([embedding, fix]),
                         twice(mask), twice(features))
    cond, uncond = out[:b], out[b:]
    return uncond + (cond - uncond) * embedding_scale
