"""Luna: linear unified nested attention.

Port of ``vln_magic_tpu/models/luna.py``, the counterpart of the
reference's Luna modules (reference: map_nav_src/fairseq/modules/
luna_attention.py:1-730, luna_sentence_encoder.py; models/lra/ luna
encoders), the second long-context tool of the vendored Mega fork.

Nested attention over a projected sequence P of ``proj_len`` tokens: the
pack attention contextualises P against the input (P' = Attn(P, X)), the
unpack attention reads the input against it (Y = Attn(X, P')), for
O(N * proj_len) instead of O(N^2).  Both are plain dense attentions
(``models.layers.MultiHeadAttention`` on its einsum path, no kernel).
Parameter names are the flax ones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from ._init import flax_default_init, normal_
from .layers import FeedForward, MultiHeadAttention, dropout, mask_to_bias


class LunaAttention(nn.Module):
    """One nested attention (``pack`` then ``unpack``): returns (Y, P')."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dropout: float = 0.1):
        super().__init__()
        self.pack = MultiHeadAttention(hidden_size, num_heads,
                                       dropout=dropout)
        self.unpack = MultiHeadAttention(hidden_size, num_heads,
                                         dropout=dropout)

    def forward(self, x, p, x_mask=None, deterministic=True, generator=None):
        drop = {"deterministic": deterministic, "generator": generator}
        x_bias = mask_to_bias(x_mask, x.dtype) if x_mask is not None else None
        packed, _ = self.pack(p, x, x_bias, **drop)
        # the packed context is dense: no key mask
        y, _ = self.unpack(x, packed, None, **drop)
        return y, packed


class LunaEncoderLayer(nn.Module):
    """Pre-LN Luna layer updating both streams (luna_sentence_encoder):
    x gets the attention and FFN residuals, p the packed update."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, dropout: float = 0.1,
                 eps: float = 1e-12):
        super().__init__()
        self.dropout = dropout
        self.attn = LunaAttention(hidden_size, num_heads, dropout)
        self.x_norm = nn.LayerNorm(hidden_size, eps=eps)
        self.p_norm = nn.LayerNorm(hidden_size, eps=eps)
        self.ffn = FeedForward(hidden_size, intermediate_size)
        self.ffn_norm = nn.LayerNorm(hidden_size, eps=eps)

    def forward(self, x, p, x_mask=None, deterministic=True, generator=None):
        drop = lambda t: dropout(t, self.dropout, deterministic, generator)
        y, packed = self.attn(self.x_norm(x), self.p_norm(p), x_mask,
                              deterministic, generator)
        x = x + drop(y)
        p = p + drop(packed)
        x = x + drop(self.ffn(self.ffn_norm(x)))
        return x, p


class LunaEncoder(nn.Module):
    """Stacked Luna encoder over token ids (the LRA classifier trunk):
    ``embed``, learned ``proj_tokens``, ``layer_i``, and a masked mean
    readout.  Returns (x, p, pooled).  Weights in JAX's distributions from
    ``seed``; ``device`` defaults to ``"cuda"``."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 num_layers: int = 2, num_heads: int = 4, proj_len: int = 32,
                 intermediate_ratio: int = 4, dropout: float = 0.1,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.embed = nn.Embedding(vocab_size, hidden_size)
        self.proj_tokens = nn.Parameter(torch.zeros(proj_len, hidden_size))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", LunaEncoderLayer(
                hidden_size, num_heads, hidden_size * intermediate_ratio,
                dropout))
        rng = np.random.default_rng(seed)
        flax_default_init(self, rng)
        normal_(self.proj_tokens, 0.02, rng)
        self.to(resolve_device(device))

    def forward(self, token_ids, mask=None, deterministic=True,
                generator=None):
        if mask is None:
            mask = torch.ones_like(token_ids, dtype=torch.bool)
        x = self.embed(token_ids)
        p = self.proj_tokens[None].expand(x.shape[0], -1, -1)
        for i in range(self.num_layers):
            x, p = getattr(self, f"layer_{i}")(x, p, mask, deterministic,
                                               generator)
        denom = mask.sum(-1, keepdim=True).clamp(min=1)
        pooled = (x * mask[..., None]).sum(1) / denom
        return x, p, pooled
