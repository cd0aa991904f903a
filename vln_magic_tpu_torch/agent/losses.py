"""Distillation losses: MAKD feature/attention/logit losses, MKTD sample
weighting, MKRW ability weighting, and the decoupled KD (DKD) logit loss.

Port of ``vln_magic_tpu/agent/losses.py``.  All losses take
``t_sample_weights`` (MKTD per-sample weights from the teacher's CE) and
``loss_type`` ('sum' | 'mean').  ``kd_loss`` keeps torch ``KLDivLoss``'s
conventions, as the reference does: 'sum' sums every element; 'mean'
divides by the element count (the legacy 'mean', not 'batchmean').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF_CLAMP = -1e6


def _weight_and_reduce(per_sample, t_sample_weights, loss_type):
    if t_sample_weights is not None:
        w = t_sample_weights.reshape((-1,) + (1,) * (per_sample.dim() - 1))
        per_sample = per_sample * w
    if loss_type == "sum":
        return per_sample.sum()
    if loss_type == "mean":
        return per_sample.mean()
    raise ValueError(f"loss_type {loss_type}")


def _clamp_logits(x):
    """-inf and the -1e9 masks both become -1e6 (reference kd_loss.py)."""
    x = torch.where(torch.isneginf(x), NEG_INF_CLAMP, x)
    return x.clamp(min=NEG_INF_CLAMP)


def mse_loss(s_inputs, t_inputs, t_sample_weights=None, loss_type="sum", **_):
    """Elementwise squared error."""
    return _weight_and_reduce((s_inputs - t_inputs) ** 2, t_sample_weights,
                              loss_type)


def kd_loss(student_logits, teacher_logits, temperature=1.0,
            t_sample_weights=None, loss_type="sum", **_):
    """Temperature-scaled KL(teacher || student) over the last axis."""
    s = _clamp_logits(student_logits)
    t = _clamp_logits(teacher_logits)
    p_t = torch.softmax(t / temperature, dim=-1)
    log_p_s = torch.log_softmax(s / temperature, dim=-1)
    log_p_t = torch.log(p_t.clamp(min=1e-12))
    pointwise = p_t * (log_p_t - log_p_s)
    scale = temperature ** 2
    if t_sample_weights is None:
        return _weight_and_reduce(pointwise, None, loss_type) * scale
    return _weight_and_reduce(pointwise.sum(dim=-1), t_sample_weights,
                              loss_type) * scale


def dkd_loss(student_logits, teacher_logits, target, temperature=1.0,
             alpha=1.0, beta=8.0, t_sample_weights=None, loss_type="sum", **_):
    """Decoupled KD: target-class KD (TCKD, binary KL over {target, rest})
    weighted by ``alpha`` + non-target-class KD (NCKD, KL over the other
    classes) weighted by ``beta``.  ``target`` indexes the last axis."""
    s = _clamp_logits(student_logits)
    t = _clamp_logits(teacher_logits)
    onehot = F.one_hot(target, s.shape[-1]).to(s.dtype)
    p_s = torch.softmax(s / temperature, dim=-1)
    p_t = torch.softmax(t / temperature, dim=-1)

    pt_s = (p_s * onehot).sum(-1)
    pt_t = (p_t * onehot).sum(-1)
    b_s = torch.stack([pt_s, 1 - pt_s], -1).clamp(1e-12, 1.0)
    b_t = torch.stack([pt_t, 1 - pt_t], -1).clamp(1e-12, 1.0)
    tckd = (b_t * (torch.log(b_t) - torch.log(b_s))).sum(-1)

    is_target = onehot > 0
    masked_s = torch.where(is_target, NEG_INF_CLAMP, s) / temperature
    masked_t = torch.where(is_target, NEG_INF_CLAMP, t) / temperature
    pn_t = torch.softmax(masked_t, dim=-1)
    log_pn_s = torch.log_softmax(masked_s, dim=-1)
    log_pn_t = torch.log(pn_t.clamp(min=1e-12))
    nckd = (pn_t * (log_pn_t - log_pn_s)).sum(-1)

    per_sample = (alpha * tckd + beta * nckd) * (temperature ** 2)
    return _weight_and_reduce(per_sample, t_sample_weights, loss_type)


# ----- MKTD: teacher loss -> per-sample transfer weights -----

def exponential_decay(t_sample_losses, decay_rate=0.1):
    """w = exp(-decay * loss)."""
    return torch.exp(-decay_rate * t_sample_losses)


def invert_normalized_losses(t_sample_losses, eps=1e-8, **_):
    """1 - min-max normalised loss."""
    lo, hi = t_sample_losses.min(), t_sample_losses.max()
    return 1.0 - (t_sample_losses - lo) / (hi - lo).clamp(min=eps)


def mktd_sample_weights(per_sample_ce, method="exp", decay=0.7):
    if method == "exp":
        return exponential_decay(per_sample_ce, decay)
    if method == "norm":
        return invert_normalized_losses(per_sample_ce)
    raise ValueError(method)


# ----- MKRW: randomised per-step ability weights -----

def mkrw_weights(generator, num_abilities=5, temp=1.0, device="cpu"):
    """softmax(N(0, 1) / temp) * K: one random reweighting of the K
    meta-abilities, drawn from ``generator`` (on ``device``)."""
    z = torch.randn(num_abilities, generator=generator, device=device)
    return torch.softmax(z / temp, dim=0) * num_abilities


def grad_softmax_weights(ability_grads, temp=1.0):
    """Gradient-magnitude-driven ability weights for the 'grad' mode:
    softmax(-grads / temp) * K."""
    g = -torch.as_tensor(ability_grads)
    return torch.softmax(g / temp, dim=0) * g.shape[0]


def masked_softmax_ce(logits, targets, ignore_id=-100):
    """Per-sample cross entropy with ignore-index semantics: (ce, valid)."""
    valid = targets != ignore_id
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, targets.clamp(min=0)[:, None])[:, 0]
    return ce * valid, valid
