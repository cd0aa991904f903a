"""Pretraining model: the navigator trunk plus the proxy-task heads.

Port of ``vln_magic_tpu/pretrain/model.py``.  One trunk (the port's
``DualScaleVLNBert`` as the submodule ``bert``) and the task heads:

  mlm — masked language modeling over the instruction, decoder tied to the
        word embedding (the masking happens in the data layer)
  mrc — masked region classification: class distributions of masked views
        at the final step, KL against soft targets
  sap — single-step action prediction on a partial path: the navigation
        head's global / local / fused logits
  og  — object grounding at the final viewpoint (REVERIE)
  cfp — contrastive feature pooling: L2-normalized pooled {txt, gmap, vp,
        fused} embeddings for InfoNCE

Attribute names dot-join to the flax param paths (``params.bert.…``,
``params.mlm_head.transform.kernel``, ``params.cfp_txt_pool.…``), so
``utils.weights.load_flax_params`` and ``export_flax_params`` carry weights
between the packages unchanged.  The per-step panoramas of a path are folded
into the batch axis ([B, S, P, D] -> [B*S, P, D]) for one panorama forward.

The model is f32, as JAX's pretraining model is (its ``dtype`` defaults to
float32 and the JAX trainer builds it without one).  ``deterministic=False``
turns dropout on with masks from ``generator``; a deterministic call of a
model built with ``use_pallas_attention`` takes the packed kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.vlnbert import DualScaleVLNBert
from ..utils.device import resolve_device


class MLMHead(nn.Module):
    """Linear -> gelu -> LayerNorm, then logits against the (tied) word
    embedding plus a bias the head holds itself."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden, word_embedding):
        x = self.norm(F.gelu(self.transform(hidden)))
        return x @ word_embedding.t() + self.bias


class GlocalTextPathCMTPretrain(nn.Module):
    """The trunk and the task heads.  ``obj_feat_size`` is the object
    feature width of ``og`` (JAX infers it from the first batch: the object
    store's width, else the world's feature width); ``device`` defaults to
    ``"cuda"``."""

    def __init__(self, cfg: ModelConfig, image_prob_size: int = 1000,
                 obj_feat_size: int | None = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        c = self.cfg = cfg
        d = c.hidden_size
        self.bert = DualScaleVLNBert(c, device=device)
        self.mlm_head = MLMHead(c)
        self.mrc_head = nn.Linear(d, image_prob_size)
        self.og_obj_proj = nn.Linear(obj_feat_size or c.image_feat_size, d)
        self.og_loc_proj = nn.Linear(c.angle_feat_size + 3, d)
        self.og_state_proj = nn.Linear(d, d)
        self.cfp_txt_pool = nn.Linear(d, d)
        self.cfp_gmap_pool = nn.Linear(d, d)
        self.cfp_vp_pool = nn.Linear(d, d)
        self.cfp_fused_pool = nn.Linear(2 * d, d)
        self.to(device)
        self.eval()

    # ----- trunk -----

    def encode_text(self, batch, deterministic=True, generator=None):
        return self.bert.language(batch["txt_ids"], batch["txt_masks"],
                                  deterministic, generator)

    def encode_panoramas(self, batch, deterministic=True, generator=None):
        """[B, S, P, ...] per-step panoramas through the pano encoder in one
        folded batch; returns per-step token embeds and fused embeds."""
        v = batch["traj_view_fts"]
        b, s = v.shape[:2]
        fold = lambda x: x.reshape((b * s,) + x.shape[2:])
        pano_embeds, pano_fused, _ = self.bert.panorama(
            fold(v), fold(batch["traj_loc_fts"]),
            fold(batch["traj_nav_types"]), fold(batch["traj_pano_masks"]),
            deterministic, generator)
        return (pano_embeds.reshape(b, s, *pano_embeds.shape[1:]),
                pano_fused.reshape(b, s, -1))

    @staticmethod
    def build_gmap_embeds(batch, pano_embeds, pano_fused):
        """Per-token image embeddings of the gmap sequence: a visited node
        takes its step's fused panorama, a frontier node the candidate view
        where it was first seen.  ``gmap_src_step``/``gmap_src_slot`` are
        [B, G] (slot -1: the step's fused embedding; step -1: no token, a
        zero row); both are clamped to 0 before the gathers and masked
        after."""
        src_step = batch["gmap_src_step"].long()
        slot = batch["gmap_src_slot"].long()
        step = src_step.clamp(min=0)
        bi = torch.arange(step.shape[0], device=step.device)[:, None]
        from_view = pano_embeds[bi, step, slot.clamp(min=0)]
        from_fused = pano_fused[bi, step]
        emb = torch.where((slot >= 0)[..., None], from_view, from_fused)
        return emb * (src_step >= 0)[..., None]

    def encode_path(self, batch, deterministic=True, generator=None):
        txt_embeds, _ = self.encode_text(batch, deterministic, generator)
        pano_embeds, pano_fused = self.encode_panoramas(batch, deterministic,
                                                        generator)
        gmap_img_embeds = self.build_gmap_embeds(batch, pano_embeds,
                                                 pano_fused)
        last_pano = self._final_step(batch, pano_embeds)     # [B, P, D]
        vp_img_embeds = torch.cat(
            [last_pano.new_zeros((last_pano.shape[0], 2, last_pano.shape[2])),
             last_pano], dim=1)
        outs = self.bert.navigation(
            txt_embeds, batch["txt_masks"], gmap_img_embeds,
            batch["gmap_step_ids"], batch["gmap_pos_fts"], batch["gmap_masks"],
            batch["gmap_visited_masks"], batch["gmap_pair_dists"],
            vp_img_embeds, batch["vp_pos_fts"], batch["vp_masks"],
            batch["vp_nav_masks"], batch["gmap_local_slot"].long(),
            batch["vp_cand_visited"], deterministic=deterministic,
            generator=generator)
        outs["txt_embeds"] = txt_embeds
        outs["pano_embeds"] = pano_embeds
        outs["pano_fused_embeds"] = pano_fused
        return outs

    @staticmethod
    def _final_step(batch, per_step):
        """``per_step[b, final_step[b]]``; the builder's final step is always
        a real step (0 <= final_step < S)."""
        final = batch["final_step"].long()
        return per_step[torch.arange(final.shape[0], device=final.device),
                        final]

    # ----- task forwards (the reference's model(batch, task=...) modes) -----

    def mlm(self, batch, deterministic=True, generator=None):
        """[B, L, vocab] logits at every instruction position."""
        txt_embeds, _ = self.encode_text(batch, deterministic, generator)
        return self.mlm_head(txt_embeds,
                             self.bert.lang_encoder.word_embeddings.weight)

    def mrc(self, batch, deterministic=True, generator=None):
        """[B, P, image_prob_size] class logits of the final step's views."""
        outs = self.encode_path(batch, deterministic, generator)
        return self.mrc_head(self._final_step(batch, outs["pano_embeds"]))

    def sap(self, batch, deterministic=True, generator=None):
        outs = self.encode_path(batch, deterministic, generator)
        return {k: outs[k] for k in
                ("global_logits", "local_logits", "fused_logits")}

    def og(self, batch, deterministic=True, generator=None):
        """Object logits at the final viewpoint against the fused
        cross-modal state (-1e9 on padded objects)."""
        outs = self.encode_path(batch, deterministic, generator)
        obj = self.og_obj_proj(batch["obj_fts"])
        if "obj_loc_fts" in batch:
            obj = obj + self.og_loc_proj(batch["obj_loc_fts"])
        state = self.og_state_proj(outs["vp_embeds"][:, 0]
                                   + outs["txt_embeds"][:, 0])
        logits = torch.einsum("bod,bd->bo", obj, state)
        return logits.masked_fill(~batch["obj_masks"], -1e9)

    def cfp(self, batch, deterministic=True, generator=None):
        """L2-normalized pooled embeddings ``txt``, ``gmap``, ``vp`` and
        ``fused``."""
        outs = self.encode_path(batch, deterministic, generator)
        g0, v0 = outs["gmap_embeds"][:, 0], outs["vp_embeds"][:, 0]
        pooled = {"txt": self.cfp_txt_pool(outs["txt_embeds"][:, 0]),
                  "gmap": self.cfp_gmap_pool(g0),
                  "vp": self.cfp_vp_pool(v0),
                  "fused": self.cfp_fused_pool(torch.cat([g0, v0], -1))}
        return {k: x / torch.linalg.vector_norm(
                    x, dim=-1, keepdim=True).clamp(min=1e-8)
                for k, x in pooled.items()}

    def bert_kd_project(self, name, x):
        return self.bert.kd_project(name, x)


# ----- losses (plain functions of the head outputs) -----

def _masked_mean_ce(logits, labels, ignore_id=-100):
    """Cross entropy over the last axis, summed over the positions whose
    label is not ``ignore_id`` and divided by their count (at least 1);
    returns (loss, valid)."""
    valid = labels != ignore_id
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return (ce * valid).sum() / valid.sum().clamp(min=1), valid


def mlm_loss(logits, labels, ignore_id=-100):
    return _masked_mean_ce(logits, labels, ignore_id)


def mrc_loss(pred_logits, soft_targets, mask):
    """KL(soft_targets || pred) over the masked view positions."""
    logp = torch.log_softmax(pred_logits, dim=-1)
    p = soft_targets
    kl = (p * (torch.log(p.clamp(min=1e-12)) - logp)).sum(-1) * mask
    return kl.sum() / mask.sum().clamp(min=1)


def sap_loss(logits, labels, ignore_id=-100):
    return _masked_mean_ce(logits, labels, ignore_id)[0]


def cfp_loss(embeds, temperature=1.0):
    """Bidirectional InfoNCE between ``txt`` and each of ``gmap``, ``vp``
    and ``fused``, averaged over the three."""
    txt = embeds["txt"]
    labels = torch.arange(txt.shape[0], device=txt.device)[:, None]
    total = 0.0
    for key in ("gmap", "vp", "fused"):
        sim = txt @ embeds[key].t() / temperature
        lp1 = torch.log_softmax(sim, dim=-1)
        lp2 = torch.log_softmax(sim.t(), dim=-1)
        total = total - (lp1.gather(1, labels).mean()
                         + lp2.gather(1, labels).mean()) / 2
    return total / 3.0
