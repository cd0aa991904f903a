"""MAKD per-step loss assembly (meta-ability knowledge distillation).

Port of ``vln_magic_tpu/agent/distill.py``: five meta-abilities {txt, img,
local, global, action}, each with feature losses (student embeddings
projected to the teacher's width), attention-map losses (per layer,
head-averaged, on the first min(depth) layers) and a logit loss (KD or
DKD) on the fused action scores, weighted by MKRW ability weights and MKTD
per-sample weights.

Roles:
  't2s': distil the teacher into the student; the student's tensors are
         projected by the student's KD heads; the teacher's are detached.
  's2t': ICoD's reverse loss, training the teacher toward the projected,
         detached student; ``loss_type`` is forced to 'mean'.

``.detach()`` stands exactly where the reference has ``stop_gradient``.
The ability weight vector is ordered (txt, img, local, global, action), and
its consumption keeps the reference's index quirk: ``ability_weights[2]``
weighs the GLOBAL losses and ``[3]`` the LOCAL ones.  The img /2 halving
applies only in learned-weight and non-adaptive modes.
"""

from __future__ import annotations

import torch

from ..config import DistillConfig
from . import losses as L

ABILITIES = ("txt", "img", "local", "global", "action")
KD_LOSS_NAMES = ("txt_emb_loss", "txt_attn_loss", "img_emb_loss",
                 "avg_img_emb_loss", "img_attn_loss", "local_emb_loss",
                 "local_attn_loss", "global_emb_loss", "global_attn_loss",
                 "predict_loss")


def zero_kd_losses(device="cpu"):
    return {k: torch.zeros((), device=device) for k in KD_LOSS_NAMES}


def _feat_fn(cfg: DistillConfig):
    return L.mse_loss if cfg.feat_loss == "mse" else L.kd_loss


def _attn_fn(cfg: DistillConfig):
    return L.mse_loss if cfg.attn_loss == "mse" else L.kd_loss


def makd_step_losses(cfg: DistillConfig, t_step, s_outs, t_outs, project,
                     nav_targets, ability_weights, sample_weights,
                     learned_weights=None, role="t2s", ignore_id=-100):
    """One step's KD loss contributions, a dict over ``KD_LOSS_NAMES``.

    ``t_step``: the step index (an int).  ``project(name, x)``: the
    projection head ``name`` of the student, the model with the smaller
    hidden size, in both roles (in 's2t' the projected side is the detached
    target).  ``ability_weights``: [5] MKRW weights or None;
    ``learned_weights``: [5] softplus ability weights (learned-weight mode);
    ``sample_weights``: [B] MKTD weights or None.
    """
    loss_type = "mean" if role == "s2t" else cfg.loss_type
    temp = cfg.temperature
    some = next(iter(s_outs.values()))
    out = zero_kd_losses(some.device)

    def w(learned_i, rw_i=None):
        if learned_weights is not None:
            return learned_weights[learned_i]
        if ability_weights is not None:
            return ability_weights[rw_i if rw_i is not None else learned_i]
        return 1.0

    img_div = 1.0 if (learned_weights is None
                      and ability_weights is not None) else 2.0

    def pair(name, s_x, t_x):
        """(student-side tensor, detached target) for feature losses."""
        if role == "t2s":
            return project(name, s_x), t_x.detach()
        return s_x, project(name, t_x).detach()

    def attn_pair(s_a, t_a):
        layers = min(s_a.shape[1], t_a.shape[1])
        return s_a[:, :layers], t_a[:, :layers].detach()

    feat = _feat_fn(cfg)
    attn = _attn_fn(cfg)
    kw = {"t_sample_weights": sample_weights, "loss_type": loss_type}

    # 1. txt: contributes at t == 0 only
    if "txt" in cfg.ability_types and t_step == 0:
        if not cfg.no_feat:
            s_e, t_e = pair("txt_emb_w", s_outs["txt_embeds"],
                            t_outs["txt_embeds"])
            out["txt_emb_loss"] = w(0) * feat(s_e, t_e, temperature=temp,
                                              **kw)
        if not cfg.no_attn:
            s_a, t_a = attn_pair(s_outs["txt_attns"], t_outs["txt_attns"])
            out["txt_attn_loss"] = w(0) * attn(s_a, t_a, temperature=temp,
                                               **kw)

    # 2. img: pano embeddings, fused embedding (each /2), attention maps
    if "img" in cfg.ability_types:
        if not cfg.no_feat:
            s_e, t_e = pair("kdl_img_w", s_outs["pano_embeds"],
                            t_outs["pano_embeds"])
            out["img_emb_loss"] = w(1) * feat(
                s_e, t_e, temperature=temp, **kw) / img_div
            s_f, t_f = pair("kdl_avg_img_w", s_outs["pano_fused_embeds"],
                            t_outs["pano_fused_embeds"])
            out["avg_img_emb_loss"] = w(1) * feat(
                s_f, t_f, temperature=temp, **kw) / img_div
        if not cfg.no_attn:
            s_a, t_a = attn_pair(s_outs["img_attns"], t_outs["img_attns"])
            out["img_attn_loss"] = w(1) * attn(s_a, t_a, temperature=temp,
                                               **kw)

    # 3. local / global cross-modal embeddings and attention maps, with the
    # reference's RW index quirk (w(2, 3) for local, w(3, 2) for global)
    for ability, key, head, idx in (("local", "vp", "local_cross_w", (2, 3)),
                                    ("global", "gmap", "global_cross_w",
                                     (3, 2))):
        if ability not in cfg.ability_types:
            continue
        if not cfg.no_feat:
            s_e, t_e = pair(head, s_outs[f"{key}_embeds"],
                            t_outs[f"{key}_embeds"])
            out[f"{ability}_emb_loss"] = w(*idx) * feat(s_e, t_e, **kw)
        if not cfg.no_attn:
            s_a, t_a = attn_pair(s_outs[f"{key}_attns"],
                                 t_outs[f"{key}_attns"])
            out[f"{ability}_attn_loss"] = w(*idx) * attn(s_a, t_a, **kw)

    # 4. action: logit KD / DKD on the fused navigation scores
    if ("action" in cfg.ability_types and not cfg.no_logit
            and nav_targets is not None):
        s_l = s_outs["fused_logits"]
        t_l = t_outs["fused_logits"].detach()
        if cfg.logit_loss == "dkd":
            tgt = torch.where(nav_targets == ignore_id, 0, nav_targets)
            out["predict_loss"] = w(4) * L.dkd_loss(
                s_l, t_l, tgt, temperature=temp, alpha=cfg.dkd_alpha,
                beta=cfg.dkd_beta, **kw)
        else:
            out["predict_loss"] = w(4) * L.kd_loss(s_l, t_l,
                                                   temperature=temp, **kw)
    return out


def add_losses(acc, new):
    return {k: acc[k] + new[k] for k in acc}


def total_kd_loss(kd: dict):
    return sum(kd.values())
