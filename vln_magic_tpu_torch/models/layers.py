"""Transformer building blocks, BERT/RoBERTa post-LN style.

Port of ``vln_magic_tpu/models/layers.py``.  Module attribute names
dot-join to the flax param paths (``attention.query``, ``attention_norm.
LayerNorm_0``, ...), so ``utils.weights.load_flax_params`` maps one onto
the other.

Every layer takes the reference's ``deterministic`` switch.  A
deterministic call (evaluation) applies no dropout; a training call
(``deterministic=False``) drops attention probabilities, residual branches
and embeddings as flax's ``nn.Dropout`` does, with masks drawn from the
``torch.Generator`` the caller passes down (``None``: PyTorch's default
generator).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import packed_attention

NEG_INF = -1e9


def dropout(x, rate: float, deterministic: bool, generator=None):
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``; the mask comes from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, Lk] bool -> additive attention bias [B, 1, 1, Lk]."""
    bias = torch.zeros(mask.shape, dtype=dtype, device=mask.device)
    return bias.masked_fill(~mask, NEG_INF)[:, None, None, :]


class MultiHeadAttention(nn.Module):
    """Scaled dot-product attention with an optional additive bias that
    broadcasts against [B, H, Lq, Lk].  Returns (output, head-averaged
    probabilities [B, Lq, Lk]).

    ``use_packed`` sends a deterministic call whose caller needs no map to
    ``ops.attention.packed_attention`` (the reference's ``use_pallas`` path,
    layers.py:74-105): Q/K/V go in packed, a [B|1, 1, 1, Lk] bias becomes
    the mask and any other bias a full [B, H, Lq, Lk] sprel, and zeros stand
    in for the probabilities, which the evaluation and serving loops never
    read.  ``need_maps`` keeps a deterministic call on the einsum path: the
    training rollout passes it, since it reads the maps (MAKD) and the
    gradients, and the forward-only kernel gives neither.  A training call
    (``deterministic=False``) always takes the einsum path, which drops
    probabilities and returns the map before dropout.
    """

    def __init__(self, hidden_size: int, num_heads: int,
                 use_packed: bool = False, softmax_in_dtype: bool = False,
                 logits_f32: bool = False, dropout: float = 0.0):
        super().__init__()
        self.h = num_heads
        self.hd = hidden_size // num_heads
        self.use_packed = use_packed
        self.dropout = dropout
        self.softmax_in_dtype = softmax_in_dtype
        self.logits_f32 = logits_f32
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.out = nn.Linear(hidden_size, hidden_size)

    def forward(self, q_input, kv_input, bias=None, precomputed_kv=None,
                deterministic=True, generator=None, need_maps=False):
        q = self.query(q_input)
        if precomputed_kv is not None:
            # hoisted instruction K/V (text_cross_kv), packed or [B, L, H, hd]
            k, v = precomputed_kv
        else:
            k = self.key(kv_input)
            v = self.value(kv_input)
        ctx, probs = self.attend(q, k, v, bias, deterministic, generator,
                                 need_maps)
        return self.out(ctx), probs

    def attend(self, q, k, v, bias=None, deterministic=True, generator=None,
               need_maps=False):
        """Attention of projected Q [B, Lq, H*hd] over K/V ([B, Lk, H*hd]
        or [B, Lk, H, hd]): (context [B, Lq, H*hd] before ``out``, the
        head-averaged probabilities [B, Lq, Lk] or zeros on the packed
        path).  The branch-fused trunk calls it with both branches on the
        batch axis (``models.vlnbert.BranchedTrunk``)."""
        h, hd = self.h, self.hd
        d = h * hd
        b, lq = q.shape[0], q.shape[1]
        lk = k.shape[1]

        if self.use_packed and deterministic and not need_maps:
            k = k.reshape(b, lk, d)
            v = v.reshape(b, lk, d)
            if bias is None:
                mask_bias = q.new_zeros((b, lk), dtype=torch.float32)
                sprel = None
            elif bias.shape[-2] == 1 and bias.shape[-3] == 1:
                mask_bias = bias[:, 0, 0, :].expand(b, lk).float().contiguous()
                sprel = None
            else:
                mask_bias = q.new_zeros((b, lk), dtype=torch.float32)
                sprel = bias.expand(b, h, lq, lk).float().contiguous()
            ctx = packed_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), mask_bias, sprel,
                                   num_heads=h)
            probs = q.new_zeros((), dtype=torch.float32).expand(b, lq, lk)
            return ctx, probs

        q = q.reshape(b, lq, h, hd)
        k = k.reshape(b, lk, h, hd)
        v = v.reshape(b, lk, h, hd)
        if self.logits_f32 and not self.softmax_in_dtype:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
                / math.sqrt(hd)
            if bias is not None:
                scores = scores + bias.float()
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            if bias is not None:
                scores = scores + bias.to(scores.dtype)
            if self.softmax_in_dtype:
                probs = torch.softmax(scores, dim=-1)
            else:
                probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        probs_drop = dropout(probs, self.dropout, deterministic, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs_drop, v).reshape(b, lq, d)
        return ctx, probs.mean(dim=1)


class AddNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-12,
                 dropout: float = 0.0):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=eps)
        self.dropout = dropout

    def forward(self, residual, x, deterministic=True, generator=None):
        x = dropout(x, self.dropout, deterministic, generator)
        return self.LayerNorm_0(residual + x)


class FeedForward(nn.Module):
    """Exact-erf gelu by default; ``gelu_approx`` takes the tanh form."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 gelu_approx: bool = False):
        super().__init__()
        self.approximate = "tanh" if gelu_approx else "none"
        self.intermediate = nn.Linear(hidden_size, intermediate_size)
        self.output = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x):
        return self.output(F.gelu(self.intermediate(x),
                                  approximate=self.approximate))


def _attention(cfg, packed: bool) -> MultiHeadAttention:
    return MultiHeadAttention(
        cfg.hidden_size, cfg.num_attention_heads, packed,
        cfg.softmax_compute_dtype_attn, cfg.attn_logits_f32,
        cfg.attention_dropout)


def _add_norm(cfg) -> AddNorm:
    return AddNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.hidden_dropout)


class TransformerLayer(nn.Module):
    """Post-LN self-attention encoder layer (BERT structure)."""

    def __init__(self, cfg):
        super().__init__()
        self.attention = _attention(cfg, cfg.use_pallas_attention)
        self.attention_norm = _add_norm(cfg)
        self.ffn = FeedForward(cfg.hidden_size, cfg.intermediate_size,
                               cfg.gelu_approximate)
        self.ffn_norm = _add_norm(cfg)

    def forward(self, x, mask=None, bias=None, deterministic=True,
                generator=None, need_maps=False):
        attn_bias = None
        if mask is not None:
            attn_bias = mask_to_bias(mask, x.dtype)
        if bias is not None:
            attn_bias = bias if attn_bias is None else attn_bias + bias
        drop = {"deterministic": deterministic, "generator": generator}
        attn_out, probs = self.attention(x, x, attn_bias, need_maps=need_maps,
                                         **drop)
        x = self.attention_norm(x, attn_out, **drop)
        x = self.ffn_norm(x, self.ffn(x), **drop)
        return x, probs


class CrossModalLayer(nn.Module):
    """Vision-queries-language cross attention, optional language-queries-
    vision attention (never packed, as in the reference), self-attention
    over the visual stream with an optional additive bias, FFN."""

    def __init__(self, cfg):
        super().__init__()
        packed = cfg.use_pallas_attention
        self.lang2visn = cfg.use_lang2visn_attn
        self.crossattention = _attention(cfg, packed)
        self.crossattention_norm = _add_norm(cfg)
        if self.lang2visn:
            self.lang2visn_attention = _attention(cfg, False)
            self.lang2visn_norm = _add_norm(cfg)
        self.self_attention = _attention(cfg, packed)
        self.self_norm = _add_norm(cfg)
        self.ffn = FeedForward(cfg.hidden_size, cfg.intermediate_size,
                               cfg.gelu_approximate)
        self.ffn_norm = _add_norm(cfg)

    def forward(self, visn, lang, visn_mask, lang_mask, self_bias=None,
                cross_kv=None, deterministic=True, generator=None,
                need_maps=False):
        drop = {"deterministic": deterministic, "generator": generator}
        lang_bias = mask_to_bias(lang_mask, visn.dtype)
        visn_bias = mask_to_bias(visn_mask, visn.dtype)
        x_out, x_probs = self.crossattention(visn, lang, lang_bias,
                                             precomputed_kv=cross_kv,
                                             need_maps=need_maps, **drop)
        visn = self.crossattention_norm(visn, x_out, **drop)
        if self.lang2visn:
            l_out, _ = self.lang2visn_attention(lang, visn, visn_bias, **drop)
            lang = self.lang2visn_norm(lang, l_out, **drop)
        self_attn_bias = visn_bias
        if self_bias is not None:
            self_attn_bias = self_attn_bias + self_bias
        s_out, _ = self.self_attention(visn, visn, self_attn_bias,
                                       need_maps=need_maps, **drop)
        visn = self.self_norm(visn, s_out, **drop)
        visn = self.ffn_norm(visn, self.ffn(visn), **drop)
        return visn, lang, x_probs
