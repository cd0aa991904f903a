"""Mega's multidimensional damped EMA as a parallel scan.

Port of ``vln_magic_tpu/ops/ema.py``, the counterpart of the fairseq
fork's sequential EMA recurrence (reference: map_nav_src/fairseq/modules/
moving_average_gated_attention.py, models/mega.py).  JAX lowers the
recurrence h_t = a * h_{t-1} + b_t to ``jax.lax.associative_scan`` (an
XLA op, not a Pallas kernel); here it is a log-depth doubling scan
(Hillis-Steele) over L with the same combine, (a1, b1) then (a2, b2) ->
(a1 a2, b1 a2 + b2): ceil(log2 L) rounds of whole-tensor products, where
a loop over L would launch L steps.
"""

from __future__ import annotations

import torch


def damped_ema_scan(x, alpha, delta, beta, eta, h0=None):
    """Mega's multidimensional damped EMA.

    x: [B, L, D] input; alpha, delta: [D, N] weights and damping in (0, 1);
    beta: [D, N] input expansion; eta: [D, N] output projection; h0: an
    optional [B, D, N] initial state.

    u_t = beta * x_t (expanded to N); h_t = (1 - alpha * delta) h_{t-1} +
    alpha * u_t; y_t = sum_N eta * h_t.  Returns (y [B, L, D], h_last
    [B, D, N])."""
    a = 1.0 - alpha * delta                                   # [D, N]
    bx = alpha * (x[..., None] * beta)                        # [B, L, D, N]
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a * h0[:, None], bx[:, 1:]], dim=1)
    A = a.expand(bx.shape)
    h = bx
    L = x.shape[1]
    s = 1
    while s < L:
        # position t combines with t - s: b_t += b_{t-s} * A_t, then
        # A_t *= A_{t-s} (the old A_t on the right of both)
        h = torch.cat([h[:, :s], h[:, :-s] * A[:, s:] + h[:, s:]], dim=1)
        A = torch.cat([A[:, :s], A[:, :-s] * A[:, s:]], dim=1)
        s *= 2
    y = (h * eta).sum(-1)
    return y, h[:, -1]


def damped_ema_reference(x, alpha, delta, beta, eta, h0=None):
    """The sequential recurrence, for tests."""
    b, L, d = x.shape
    h = (x.new_zeros((b, d, alpha.shape[1])) if h0 is None else h0)
    ys = []
    for t in range(L):
        u = x[:, t, :, None] * beta
        h = (1 - alpha * delta) * h + alpha * u
        ys.append((h * eta).sum(-1))
    return torch.stack(ys, dim=1), h
