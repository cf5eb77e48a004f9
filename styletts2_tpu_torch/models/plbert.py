"""PL-BERT: phoneme-level ALBERT encoder (ref: Utils/PLBERT/util.py:22-142).

HF ``AlbertModel`` numerics: one shared layer applied ``num_hidden_layers``
times, gelu_new, layer-norm eps 1e-12, additive ``finfo.min`` attention
masking.  Only ``last_hidden_state`` is produced.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..nn.activations import gelu_new
from ..nn.linear import linear
from ..nn.norm import layer_norm
from . import common as cm


@dataclasses.dataclass(frozen=True)
class PLBertConfig:
    vocab_size: int = 178
    embedding_size: int = 128
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    num_hidden_layers: int = 12
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1


class _AlbertLayer(nn.Module):
    def __init__(self, h: int, inter: int):
        super().__init__()
        self.attention = nn.ModuleDict({
            "query": nn.Linear(h, h), "key": nn.Linear(h, h),
            "value": nn.Linear(h, h), "dense": nn.Linear(h, h),
            "LayerNorm": nn.LayerNorm(h)})
        self.ffn = nn.Linear(h, inter)
        self.ffn_output = nn.Linear(inter, h)
        self.full_layer_layer_norm = nn.LayerNorm(h)


class PLBert(nn.Module):
    def __init__(self, cfg: PLBertConfig = PLBertConfig()):
        super().__init__()
        self.cfg = cfg
        e, h = cfg.embedding_size, cfg.hidden_size
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(cfg.vocab_size, e),
            "position_embeddings": nn.Embedding(cfg.max_position_embeddings, e),
            "token_type_embeddings": nn.Embedding(2, e),
            "LayerNorm": nn.LayerNorm(e)})
        layer = _AlbertLayer(h, cfg.intermediate_size)
        self.encoder = nn.ModuleDict({
            "embedding_hidden_mapping_in": nn.Linear(e, h),
            "albert_layer_groups": nn.ModuleDict({"0": nn.ModuleDict({
                "albert_layers": nn.ModuleDict({"0": layer})})})})


@torch.no_grad()
def grown_position_table(m: PLBert, target: int) -> torch.Tensor:
    """The position table grown to ``target`` rows by repeating the last row
    (ref: Utils/PLBERT/util.py:31-65); a new tensor, ``m`` is left alone."""
    w = m.embeddings["position_embeddings"].weight.detach()
    cur, dim = w.shape
    if target <= cur:
        return w.clone()
    return torch.cat([w, w[-1:].expand(target - cur, dim)])


def _ln(x, mod: nn.LayerNorm, eps: float):
    return layer_norm(x, mod.weight, mod.bias, eps=eps)


def _lin(x, mod: nn.Linear):
    return linear(x, mod.weight, mod.bias)


def plbert_apply(m: PLBert, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """input_ids (B, L), attention_mask (B, L) 1 = keep -> (B, L, hidden);
    ``positions`` replaces the module's position table (a grown copy)."""
    cfg = m.cfg
    eps = cfg.layer_norm_eps
    emb = m.embeddings
    length = input_ids.shape[1]
    x = cm.embedding(emb["word_embeddings"], input_ids)
    if positions is None:
        positions = emb["position_embeddings"].weight
    x = (x + positions[:length][None]
         + emb["token_type_embeddings"].weight[0][None, None, :])
    x = _ln(x, emb["LayerNorm"], eps)
    h = _lin(x, m.encoder["embedding_hidden_mapping_in"])

    bias = None
    if attention_mask is not None:
        bias = ((1.0 - attention_mask.to(h.dtype))[:, None, None, :]
                * torch.finfo(h.dtype).min)
    layer = m.encoder["albert_layer_groups"]["0"]["albert_layers"]["0"]
    for _ in range(cfg.num_hidden_layers):
        h = _albert_layer(layer, h, bias, cfg)
    return h


def _albert_layer(p: _AlbertLayer, h: torch.Tensor, bias, cfg: PLBertConfig):
    att = p.attention
    b, l, hid = h.shape
    n_heads = cfg.num_attention_heads
    d = hid // n_heads

    def heads(t):
        return t.reshape(b, l, n_heads, d).transpose(1, 2)

    q = heads(_lin(h, att["query"]))
    k = heads(_lin(h, att["key"]))
    v = heads(_lin(h, att["value"]))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if bias is not None:
        scores = scores + bias
    ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
    ctx = _lin(ctx.transpose(1, 2).reshape(b, l, hid), att["dense"])
    h = _ln(h + ctx, att["LayerNorm"], cfg.layer_norm_eps)
    f = _lin(gelu_new(_lin(h, p.ffn)), p.ffn_output)
    return _ln(h + f, p.full_layer_layer_norm, cfg.layer_norm_eps)
