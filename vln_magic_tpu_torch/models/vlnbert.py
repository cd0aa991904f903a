"""DualScaleVLNBert — the navigator model, in PyTorch.

Port of ``vln_magic_tpu/models/vlnbert.py``: the modes ``language``,
``panorama``, ``text_cross_kv`` and ``navigation``, the knowledge-
distillation projection heads and learned ability weights (``kd_project``,
``kd_ability_weights``), and the ``Critic`` value head.  The module tree
dot-joins to the flax param paths.

Parameters live in ``dtype``; every mode casts its float inputs to it, as
flax's Dense layers do with their inputs.  Evaluation holds them in the
compute dtype.  Training holds f32 master weights and runs the modes under
``torch.autocast`` for bf16 compute (``agent.trainer``).  The modes record
autograd's graph whenever grad mode is on: evaluation callers run them
under ``torch.no_grad()``.  ``deterministic=False`` turns dropout on, with
masks from ``generator``; ``need_maps`` keeps attention off the
forward-only packed kernel, for a caller that reads the attention maps or
the gradients (``models.layers.MultiHeadAttention``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..utils.device import resolve_device
from .layers import NEG_INF, CrossModalLayer, TransformerLayer, dropout

# ModelConfig switches this slice does not port, with the value it supports
UNPORTED = {"do_back_txt": False, "do_back_img": False,
            "do_front_txt": False, "do_front_img": False,
            "do_front_his": False, "fuse_branches": False}
# softplus^-1(1.0): the learned ability weights' initial value
KD_WEIGHT_INIT = 0.5413
KD_HEADS = ("txt_emb_w", "vp_txt_w", "gmap_txt_w", "local_cross_w",
            "global_cross_w", "kdl_img_w", "kdl_avg_img_w")
ABILITY_WEIGHTS = ("txt", "img", "local", "global", "predict")


def refuse_unported(cfg: ModelConfig):
    for name, ok in UNPORTED.items():
        if getattr(cfg, name) != ok:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(cfg, name)!r} is not ported to "
                "vln_magic_tpu_torch yet (see ROADMAP.md)")


def _numbered(parent: nn.Module, prefix: str, n: int, make) -> list:
    """Register ``n`` submodules as ``{prefix}_{i}`` (the flax names) and
    return them as a plain list, which registers nothing twice."""
    mods = []
    for i in range(n):
        mod = make()
        parent.add_module(f"{prefix}_{i}", mod)
        mods.append(mod)
    return mods


class LanguageEncoder(nn.Module):
    """RoBERTa-style embeddings (positions start at pad_token_id + 1) +
    ``num_l_layers`` transformer layers."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(max(cfg.type_vocab_size, 1), d)
        self.emb_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = _numbered(self, "layer", cfg.num_l_layers,
                                lambda: TransformerLayer(cfg))

    def forward(self, txt_ids, txt_masks, deterministic=True, generator=None,
                need_maps=False):
        c = self.cfg
        if txt_ids.shape[1] + c.pad_token_id + 1 > c.max_position_embeddings:
            raise ValueError(
                f"instruction length {txt_ids.shape[1]} overflows the "
                f"position table ({c.max_position_embeddings}); raise "
                "max_position_embeddings or lower max_instr_len")
        positions = torch.arange(txt_ids.shape[1], device=txt_ids.device)
        x = (self.word_embeddings(txt_ids)
             + self.position_embeddings(positions + c.pad_token_id + 1)[None]
             + self.token_type_embeddings(torch.zeros_like(txt_ids)))
        x = dropout(self.emb_norm(x), c.hidden_dropout, deterministic,
                    generator)
        attns = []
        for layer in self.layers:
            x, probs = layer(x, txt_masks, deterministic=deterministic,
                             generator=generator, need_maps=need_maps)
            attns.append(probs)
        return x, torch.stack(attns, dim=1)


class PanoEncoder(nn.Module):
    """View features + location features + nav-type embedding,
    ``num_pano_layers`` of self-attention, adaptive (or mean) pooling."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.img_proj = nn.Linear(cfg.image_feat_size, d)
        self.img_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.loc_proj = nn.Linear(cfg.loc_feat_size, d)
        self.loc_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.nav_type_embedding = nn.Embedding(3, d)
        self.fuse_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = _numbered(self, "layer", cfg.num_pano_layers,
                                lambda: TransformerLayer(cfg))
        if cfg.adaptive_pano_fusion:
            self.fusion_score = nn.Linear(d, 1)

    def forward(self, view_img_fts, loc_fts, nav_types, pano_masks,
                deterministic=True, generator=None, need_maps=False):
        img = self.img_norm(self.img_proj(view_img_fts))
        loc = self.loc_norm(self.loc_proj(loc_fts))
        x = self.fuse_norm(img + loc + self.nav_type_embedding(nav_types))
        x = dropout(x, self.cfg.hidden_dropout, deterministic, generator)
        attns = []
        for layer in self.layers:
            x, probs = layer(x, pano_masks, deterministic=deterministic,
                             generator=generator, need_maps=need_maps)
            attns.append(probs)
        if self.cfg.adaptive_pano_fusion:
            score = self.fusion_score(x)[..., 0]
            score = score.masked_fill(~pano_masks, NEG_INF)
            w = torch.softmax(score.float(), dim=-1).to(x.dtype)
            fused = torch.einsum("bp,bpd->bd", w, x)
        else:
            denom = pano_masks.sum(-1, keepdim=True).clamp(min=1)
            fused = (x * pano_masks[..., None]).sum(1) / denom
        return x, fused, torch.stack(attns, dim=1)


class CrossModalEncoder(nn.Module):
    """``num_x_layers`` cross-modal layers over one visual stream; with
    ``sprels`` the pairwise graph distances become a per-head additive bias
    on the visual self-attention."""

    def __init__(self, cfg: ModelConfig, sprels: bool = False):
        super().__init__()
        self.sprels = sprels
        if sprels:
            self.sprel_linear = nn.Linear(1, cfg.num_attention_heads)
        self.layers = _numbered(self, "layer", cfg.num_x_layers,
                                lambda: CrossModalLayer(cfg))

    def forward(self, visn, lang, visn_mask, lang_mask, pair_dists=None,
                cross_kvs=None, deterministic=True, generator=None,
                need_maps=False):
        self_bias = None
        if self.sprels and pair_dists is not None:
            x = (1.0 / (1.0 + pair_dists[..., None])).to(visn.dtype)
            self_bias = self.sprel_linear(x).permute(0, 3, 1, 2)
        attns = []
        for i, layer in enumerate(self.layers):
            visn, lang, probs = layer(
                visn, lang, visn_mask, lang_mask, self_bias,
                cross_kvs[i] if cross_kvs is not None else None,
                deterministic, generator, need_maps)
            attns.append(probs)
        return visn, torch.stack(attns, dim=1)


class ClsPrediction(nn.Module):
    """Scalar scoring head: Linear -> gelu -> LayerNorm -> Linear(1)."""

    def __init__(self, hidden_size: int, eps: float = 1e-12):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.norm = nn.LayerNorm(hidden_size, eps=eps)
        self.score = nn.Linear(hidden_size, 1)

    def forward(self, x):
        return self.score(self.norm(F.gelu(self.dense(x))))[..., 0]


class DualScaleVLNBert(nn.Module):
    """The navigator.  ``dtype`` is the compute dtype (parameters are held
    in it); ``device`` defaults to ``"cuda"``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        refuse_unported(cfg)
        c = self.cfg = cfg
        d = c.hidden_size
        self.dtype = dtype
        self.lang_encoder = LanguageEncoder(c)
        self.pano_encoder = PanoEncoder(c)
        self.local_encoder = CrossModalEncoder(c, sprels=False)
        self.global_encoder = CrossModalEncoder(c, sprels=c.graph_sprels)
        self.gmap_step_embedding = nn.Embedding(c.max_action_steps, d)
        self.gmap_pos_proj = nn.Linear(c.gmap_pos_size, d)
        self.gmap_input_norm = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.vp_pos_proj = nn.Linear(c.vp_pos_size, d)
        self.vp_input_norm = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.global_sap_head = ClsPrediction(d, c.layer_norm_eps)
        self.local_sap_head = ClsPrediction(d, c.layer_norm_eps)
        if c.glocal_fuse:
            # flax creates the gate's params only where it is called
            self.sap_fuse_linear = ClsPrediction(2 * d, c.layer_norm_eps)
        self.cls_fuse = nn.Linear(2 * d, d)
        if c.kd_heads:
            # the 7 projection heads and 5 learned ability weights of the
            # reference checkpoint contract (vlnbert.py:292-305)
            for name in KD_HEADS:
                setattr(self, name, nn.Linear(d, c.kd_target_size))
            for name in ABILITY_WEIGHTS:
                setattr(self, f"kdl_{name}_weight",
                        nn.Parameter(torch.tensor(KD_WEIGHT_INIT)))
        self.to(device=resolve_device(device), dtype=dtype)
        self.eval()

    def _f(self, x):
        return x.to(self.dtype)

    def language(self, txt_ids, txt_masks, deterministic=True,
                 generator=None, need_maps=False):
        return self.lang_encoder(txt_ids, txt_masks, deterministic, generator,
                                 need_maps)

    def panorama(self, view_img_fts, loc_fts, nav_types, pano_masks,
                 deterministic=True, generator=None, need_maps=False):
        return self.pano_encoder(self._f(view_img_fts), self._f(loc_fts),
                                 nav_types, pano_masks, deterministic,
                                 generator, need_maps)

    def kd_project(self, name, x):
        """The projection head ``name`` (one of ``KD_HEADS``) applied to
        ``x``."""
        return getattr(self, name)(self._f(x))

    def kd_ability_weights(self):
        """softplus of the learned per-ability weights, in the order
        [txt, img, local, global, predict] (vlnbert.py:580-588)."""
        return torch.stack([F.softplus(getattr(self, f"kdl_{n}_weight"))
                            for n in ABILITY_WEIGHTS])

    def text_cross_kv(self, txt_embeds):
        """Instruction K/V of every cross layer whose language input is
        loop-invariant (layer 0; all layers without lang2visn), head-split
        to [B, L, H, hd]; ``None`` for the others."""
        c = self.cfg
        n_hoist = 1 if c.use_lang2visn_attn else c.num_x_layers
        h = c.num_attention_heads
        split = lambda y: y.reshape(y.shape[0], y.shape[1], h, -1)
        out = {}
        for branch, enc in (("global", self.global_encoder),
                            ("local", self.local_encoder)):
            kvs = []
            for i, layer in enumerate(enc.layers):
                if i < n_hoist:
                    att = layer.crossattention
                    kvs.append((split(att.key(txt_embeds)),
                                split(att.value(txt_embeds))))
                else:
                    kvs.append(None)
            out[branch] = kvs
        return out

    def navigation(self, txt_embeds, txt_masks, gmap_img_embeds,
                   gmap_step_ids, gmap_pos_fts, gmap_masks,
                   gmap_visited_masks, gmap_pair_dists, vp_img_embeds,
                   vp_pos_fts, vp_masks, vp_nav_masks, gmap_local_slot,
                   vp_cand_visited, txt_cross_kvs=None, deterministic=True,
                   generator=None, need_maps=False):
        """Dual-scale cross-modal forward + dynamic action fusion (token
        layouts as in the reference: gmap [stop], [mem], visited...,
        frontier...; vp [stop], [mem], pano views...)."""
        c = self.cfg
        gmap_embeds = self.gmap_input_norm(
            self._f(gmap_img_embeds)
            + self.gmap_step_embedding(gmap_step_ids)
            + self.gmap_pos_proj(self._f(gmap_pos_fts)))
        vp_embeds = self.vp_input_norm(
            self._f(vp_img_embeds) + self.vp_pos_proj(self._f(vp_pos_fts)))
        kvs = txt_cross_kvs or {}
        drop = {"deterministic": deterministic, "generator": generator,
                "need_maps": need_maps}
        gmap_embeds, gmap_attns = self.global_encoder(
            gmap_embeds, txt_embeds, gmap_masks, txt_masks, gmap_pair_dists,
            cross_kvs=kvs.get("global"), **drop)
        vp_embeds, vp_attns = self.local_encoder(
            vp_embeds, txt_embeds, vp_masks, txt_masks, None,
            cross_kvs=kvs.get("local"), **drop)
        global_scores = self.global_sap_head(gmap_embeds)
        local_scores = self.local_sap_head(vp_embeds)

        b = gmap_embeds.shape[0]
        if c.glocal_fuse:
            fuse = torch.sigmoid(self.sap_fuse_linear(
                torch.cat([gmap_embeds[:, 0], vp_embeds[:, 0]], -1)))[:, None]
        else:
            fuse = gmap_embeds.new_full((b, 1), 0.5)
        global_logits = (global_scores * fuse).masked_fill(
            ~(gmap_masks & ~gmap_visited_masks), NEG_INF)
        local_logits = (local_scores * (1.0 - fuse)).masked_fill(
            ~vp_nav_masks, NEG_INF)

        # backtrack logit: sum of local scores of already-visited candidates
        safe_local = local_logits.masked_fill(~vp_nav_masks, 0.0)
        bw_logits = (safe_local * vp_cand_visited).sum(-1)

        has_slot = gmap_local_slot >= 0
        local_for_gmap = safe_local.gather(1, gmap_local_slot.clamp(min=0))
        g_idx = torch.arange(global_logits.shape[1],
                             device=global_logits.device)[None, :]
        frontier = gmap_masks & ~gmap_visited_masks & (g_idx > 0)
        zero = global_logits.new_zeros(())
        add = torch.where(has_slot & frontier, local_for_gmap,
                          torch.where(frontier, bw_logits[:, None], zero))
        add[:, 0] = add[:, 0] + safe_local[:, 0]
        fused_logits = torch.where(global_logits > NEG_INF / 2,
                                   global_logits + add,
                                   global_logits.new_full((), NEG_INF))

        cls_embeds = self.cls_fuse(
            torch.cat([gmap_embeds[:, 0], vp_embeds[:, 0]], -1))
        return {
            "gmap_embeds": gmap_embeds, "vp_embeds": vp_embeds,
            "gmap_attns": gmap_attns, "vp_attns": vp_attns,
            "global_logits": global_logits, "local_logits": local_logits,
            "fused_logits": fused_logits, "fuse_weights": fuse[:, 0],
            "cls_embeds": cls_embeds,
        }


class Critic(nn.Module):
    """Value head (vlnbert.py:675-686): Linear -> relu -> Linear(1).  The
    trainer builds one, as the reference agent does; only the A2C branch,
    not ported yet, trains it."""

    def __init__(self, hidden_size: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_size, hidden_size // 2)
        self.Dense_1 = nn.Linear(hidden_size // 2, 1)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, state):
        return self.Dense_1(F.relu(self.Dense_0(state)))[..., 0]
