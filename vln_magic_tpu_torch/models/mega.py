"""Mega-style moving-average-gated attention, the long-range toolkit.

Port of ``vln_magic_tpu/models/mega.py``, the counterpart of the
reference's vendored Mega research fork (reference: map_nav_src/fairseq/
models/mega.py:87-650, modules/moving_average_gated_attention.py:1-403,
mega_layer.py; SURVEY §5.7): chunked, linear-time, EMA-gated single-head
attention.  The EMA is the parallel scan of ``ops.ema``; chunked attention
is one batched product per chunk block ([B*C, Lc, Lc]); gating is
elementwise.  Attention never crosses a chunk boundary; the EMA carries
context across chunks.  Parameter names are the flax ones (``alpha``,
``z_proj``, ``kappa_q``, ...), so ``utils.weights`` carries JAX's weights
over.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.ema import damped_ema_scan
from ..utils.device import resolve_device
from ._init import flax_default_init, normal_, uniform_
from .layers import dropout


class MovingAverageGatedAttention(nn.Module):
    """One Mega block: damped-EMA context -> shared single-head chunked
    attention -> SiLU gating with reset/update gates."""

    def __init__(self, hidden_size: int, z_dim: int = 64,
                 v_dim: int | None = None, ema_ndim: int = 8,
                 chunk_size: int = 64, dropout: float = 0.0):
        super().__init__()
        d = hidden_size
        v = v_dim or 2 * d
        self.z_dim, self.v_dim, self.chunk_size = z_dim, v, chunk_size
        self.dropout = dropout
        self.alpha = nn.Parameter(torch.zeros(d, ema_ndim))
        self.delta = nn.Parameter(torch.zeros(d, ema_ndim))
        self.beta = nn.Parameter(torch.zeros(d, ema_ndim))
        self.eta = nn.Parameter(torch.zeros(d, ema_ndim))
        self.z_proj = nn.Linear(d, z_dim)
        self.kappa_q = nn.Parameter(torch.zeros(2, z_dim))
        self.kappa_b = nn.Parameter(torch.zeros(2, z_dim))
        self.v_proj = nn.Linear(d, v)
        self.gamma = nn.Parameter(torch.zeros(2, v))
        self.beta_g = nn.Parameter(torch.zeros(2, v))
        self.reset = nn.Linear(d, v)
        self.update = nn.Linear(d, d)
        self.h_proj = nn.Linear(v, d)
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def init_weights(self, rng: np.random.Generator) -> None:
        """JAX's initialisers, drawn from ``rng``: alpha, delta uniform(0,
        1); beta, kappa_q, gamma normal(0.02); eta normal(1); kappa_b,
        beta_g zeros."""
        flax_default_init(self, rng)
        uniform_(self.alpha, rng)
        uniform_(self.delta, rng)
        normal_(self.beta, 0.02, rng)
        normal_(self.eta, 1.0, rng)
        normal_(self.kappa_q, 0.02, rng)
        normal_(self.gamma, 0.02, rng)
        with torch.no_grad():
            self.kappa_b.zero_()
            self.beta_g.zero_()

    def forward(self, x, mask=None, causal=False, deterministic=True,
                generator=None):
        b, L, _ = x.shape
        c = min(self.chunk_size, L)
        pad = (-L) % c
        n_chunks = (L + pad) // c

        # EMA context (a parallel scan over the whole sequence)
        xin = x * mask[..., None] if mask is not None else x
        mx, _ = damped_ema_scan(xin.float(), torch.sigmoid(self.alpha),
                                torch.sigmoid(self.delta), self.beta,
                                self.eta)
        mx = mx.to(x.dtype)

        # shared single-head q/k from the EMA output, Mega's per-dim
        # scale and offset
        z = F.silu(self.z_proj(mx))
        q = z * self.kappa_q[0] + self.kappa_b[0]
        k = z * self.kappa_q[1] + self.kappa_b[1]
        v = F.silu(self.v_proj(x))

        def to_chunks(t):
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            return t.reshape(b * n_chunks, c, *t.shape[2:])

        qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
        m = mask if mask is not None else x.new_ones((b, L), dtype=torch.bool)
        mc = to_chunks(m[..., None])[..., 0]
        scores = torch.einsum("xqd,xkd->xqk", qc, kc) / math.sqrt(self.z_dim)
        bias = torch.where(mc, 0.0, -1e9)[:, None, :]
        if causal:
            cm = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
            bias = bias + torch.where(cm, 0.0, -1e9)[None]
        probs = torch.softmax(scores.float() + bias, dim=-1).to(x.dtype)
        probs = dropout(probs, self.dropout, deterministic, generator)
        ctx = torch.einsum("xqk,xkd->xqd", probs, vc)
        ctx = ctx.reshape(b, n_chunks * c, self.v_dim)[:, :L]

        # gated output: reset/update gates from the EMA stream; gamma and
        # beta_g calibrate the reset stream (row 0) and the context (row 1)
        reset = F.silu(self.reset(mx) * (1.0 + self.gamma[0])
                       + self.beta_g[0])
        update = torch.sigmoid(self.update(mx))
        h = F.silu(self.h_proj((ctx * (1.0 + self.gamma[1])
                                + self.beta_g[1]) * reset))
        return self.norm(update * h + (1.0 - update) * x)


class MegaEncoder(nn.Module):
    """Mega blocks (``mega_i``), each followed by a SiLU FFN (``ffn_up_i``,
    ``ffn_down_i``) and a residual LayerNorm (``ffn_norm_i``): a drop-in
    long-sequence encoder (the LRA role, fairseq/models/lra/).  Weights
    in JAX's distributions from ``seed``; ``device`` defaults to
    ``"cuda"`` (``None``: left on the CPU for a parent module, which
    draws the weights and places it, as ``models.lra.LRAClassifier``
    does)."""

    def __init__(self, hidden_size: int, num_layers: int = 4,
                 chunk_size: int = 64, ema_ndim: int = 8, ffn_ratio: int = 2,
                 dropout: float = 0.0, seed: int = 0, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"mega_{i}", MovingAverageGatedAttention(
                hidden_size, chunk_size=chunk_size, ema_ndim=ema_ndim,
                dropout=dropout))
            self.add_module(f"ffn_up_{i}",
                            nn.Linear(hidden_size, hidden_size * ffn_ratio))
            self.add_module(f"ffn_down_{i}",
                            nn.Linear(hidden_size * ffn_ratio, hidden_size))
            self.add_module(f"ffn_norm_{i}",
                            nn.LayerNorm(hidden_size, eps=1e-6))
        if device is not None:
            self.init_weights(np.random.default_rng(seed))
            self.to(resolve_device(device))

    def init_weights(self, rng: np.random.Generator) -> None:
        flax_default_init(self, rng)
        for i in range(self.num_layers):
            getattr(self, f"mega_{i}").init_weights(rng)

    def forward(self, x, mask=None, causal=False, deterministic=True,
                generator=None):
        for i in range(self.num_layers):
            x = getattr(self, f"mega_{i}")(x, mask, causal, deterministic,
                                           generator)
            y = getattr(self, f"ffn_down_{i}")(
                F.silu(getattr(self, f"ffn_up_{i}")(x)))
            x = getattr(self, f"ffn_norm_{i}")(x + y)
        return x
