"""DualScaleVLNBert — the navigator model, in PyTorch.

Port of ``vln_magic_tpu/models/vlnbert.py``: the modes ``language``,
``panorama``, ``text_cross_kv``, ``navigation`` and ``extract_cfp``, the
causal-intervention heads (``ZdictAttention``: the text and image
backdoors, the text, viewpoint and map frontdoors), the branch-fused
cross-modal trunk (``fuse_branches``), the knowledge-distillation
projection heads and learned ability weights (``kd_project``,
``kd_ability_weights``), and the ``Critic`` value head.  The module tree
dot-joins to the flax param paths.  Each intervention head's call is a
program span (``utils.profiling.span``): ``intervention.backdoor_txt``
(both text backdoors), ``intervention.frontdoor_txt``,
``intervention.backdoor_img``, ``intervention.frontdoor_vp`` and
``intervention.frontdoor_gmap``.

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
from ..utils.profiling import span
from ..parallel.sharding import parallel_linear
from .layers import (NEG_INF, CrossModalLayer, MultiHeadAttention,
                     TransformerLayer, dropout, mask_to_bias)

# softplus^-1(1.0): the learned ability weights' initial value
KD_WEIGHT_INIT = 0.5413
KD_HEADS = ("txt_emb_w", "vp_txt_w", "gmap_txt_w", "local_cross_w",
            "global_cross_w", "kdl_img_w", "kdl_avg_img_w")
ABILITY_WEIGHTS = ("txt", "img", "local", "global", "predict")


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


class ZdictAttention(nn.Module):
    """Causal-intervention attention over a dictionary of confounder
    features [B, N, ``z_size``] (backdoor z-dicts, frontdoor CFP
    exemplars).  The stream queries the projected dictionary; priors p(z)
    [B, N, 1] add ``log(max(p, 1e-8))`` to the scores, so a padded row
    (p 0) weighs exp(-18.42), never exp(-inf).  ``do_add_method`` ``door``
    adds the result through a learned sigmoid gate, ``add`` directly; then
    LayerNorm.  Its attention never takes the packed kernel, as in JAX.
    flax infers ``z_proj``'s input width; here the caller names it."""

    def __init__(self, cfg: ModelConfig, z_size: int):
        super().__init__()
        d = cfg.hidden_size
        self.door = cfg.do_add_method == "door"
        self.z_proj = nn.Linear(z_size, d)
        self.attention = MultiHeadAttention(d, cfg.num_attention_heads,
                                            dropout=cfg.attention_dropout)
        if self.door:
            self.gate = nn.Linear(2 * d, d)
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x, z_feats, z_pzs=None, deterministic=True,
                generator=None):
        z = self.z_proj(z_feats.to(self.z_proj.weight.dtype))
        bias = None
        if z_pzs is not None:
            bias = torch.log(z_pzs[..., 0].float().clamp(min=1e-8))[
                :, None, None, :]
        out, _ = self.attention(x, z, bias, deterministic=deterministic,
                                generator=generator)
        if self.door:
            x = x + torch.sigmoid(self.gate(torch.cat([x, out], -1))) * out
        else:
            x = x + out
        return self.norm(x)


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
        if cfg.do_back_img:
            self.img_backdoor = ZdictAttention(cfg, cfg.image_feat_size)
        self.layers = _numbered(self, "layer", cfg.num_pano_layers,
                                lambda: TransformerLayer(cfg))
        if cfg.adaptive_pano_fusion:
            self.fusion_score = nn.Linear(d, 1)

    def forward(self, view_img_fts, loc_fts, nav_types, pano_masks,
                deterministic=True, generator=None, need_maps=False,
                z_img_feats=None, z_img_pzs=None):
        img = self.img_norm(self.img_proj(view_img_fts))
        loc = self.loc_norm(self.loc_proj(loc_fts))
        x = self.fuse_norm(img + loc + self.nav_type_embedding(nav_types))
        x = dropout(x, self.cfg.hidden_dropout, deterministic, generator)
        if self.cfg.do_back_img and z_img_feats is not None:
            with span("intervention.backdoor_img"):
                x = self.img_backdoor(x, z_img_feats, z_img_pzs,
                                      deterministic, generator)
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


def _bf16_softplus(w: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` of a bf16 value, ``max(w, 0) + log1p(exp(-|w|))``
    with every op rounded to bf16 as XLA rounds it, in an f32 tensor (the
    rounding is explicit, since ``Trainer``'s ``_PromoteBf16`` runs each op
    in f32)."""
    r = lambda x: x.to(torch.bfloat16).float()
    w = r(w)
    return r(torch.clamp(w, min=0) + r(torch.log1p(r(torch.exp(-w.abs())))))


class DualScaleVLNBert(nn.Module):
    """The navigator.  ``dtype`` is the compute dtype (parameters are held
    in it); ``device`` defaults to ``"cuda"``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
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
        # the intervention heads; frontdoor dictionaries arrive at the CFP
        # projection width (kd_target_size with the KD heads, else hidden)
        front = c.kd_target_size if c.kd_heads else d
        if c.do_back_txt:
            self.txt_backdoor_direction = ZdictAttention(c, d)
            self.txt_backdoor_landmark = ZdictAttention(c, d)
        if c.do_front_txt:
            self.txt_frontdoor = ZdictAttention(c, front)
        if c.do_front_img:
            self.vp_frontdoor = ZdictAttention(c, front)
        if c.do_front_his:
            self.gmap_frontdoor = ZdictAttention(c, front)
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
        self._stacked = None            # the fused trunk's weights (key, dict)
        # set while the trainer swaps bf16 copies in for the masters
        # (``Trainer._bf16_weights``), where ``.dtype`` may read f32
        self.bf16_weights = False

    def _f(self, x):
        return x.to(self.dtype)

    def language(self, txt_ids, txt_masks, deterministic=True,
                 generator=None, need_maps=False, instr_zdict=None,
                 front_txt_feats=None):
        """Text embeddings and per-layer maps; with ``do_back_txt`` the
        direction then landmark backdoors over ``instr_zdict``
        (``{direction,landmark}_{features,pzs}``, [B, N, ...]), with
        ``do_front_txt`` the frontdoor over ``front_txt_feats``.  ``None``
        skips a head."""
        c = self.cfg
        x, attns = self.lang_encoder(txt_ids, txt_masks, deterministic,
                                     generator, need_maps)
        drop = {"deterministic": deterministic, "generator": generator}
        if c.do_back_txt and instr_zdict is not None:
            with span("intervention.backdoor_txt"):
                x = self.txt_backdoor_direction(
                    x, instr_zdict["direction_features"],
                    instr_zdict.get("direction_pzs"), **drop)
                x = self.txt_backdoor_landmark(
                    x, instr_zdict["landmark_features"],
                    instr_zdict.get("landmark_pzs"), **drop)
        if c.do_front_txt and front_txt_feats is not None:
            with span("intervention.frontdoor_txt"):
                x = self.txt_frontdoor(x, front_txt_feats, None, **drop)
        return x, attns

    def panorama(self, view_img_fts, loc_fts, nav_types, pano_masks,
                 deterministic=True, generator=None, need_maps=False,
                 z_img_feats=None, z_img_pzs=None):
        """``z_img_feats`` [B, N, image_feat_size] and ``z_img_pzs``: the
        image backdoor's dictionary (``do_back_img``), before the layers."""
        return self.pano_encoder(self._f(view_img_fts), self._f(loc_fts),
                                 nav_types, pano_masks, deterministic,
                                 generator, need_maps, z_img_feats, z_img_pzs)

    def kd_project(self, name, x):
        """The projection head ``name`` (one of ``KD_HEADS``) applied to
        ``x``."""
        return getattr(self, name)(self._f(x))

    def kd_ability_weights(self):
        """softplus of the learned per-ability weights, in the order
        [txt, img, local, global, predict] (vlnbert.py:580-588).  On bf16
        weight copies (``bf16_weights``) it is JAX's softplus of a bf16
        parameter (``_bf16_softplus``)."""
        ws = [getattr(self, f"kdl_{n}_weight") for n in ABILITY_WEIGHTS]
        act = _bf16_softplus if self.bf16_weights else F.softplus
        return torch.stack([act(w) for w in ws])

    def text_cross_kv(self, txt_embeds):
        """Instruction K/V of every cross layer whose language input is
        loop-invariant (layer 0; all layers without lang2visn), head-split
        to [B, L, H, hd]; ``None`` for the others."""
        c = self.cfg
        n_hoist = 1 if c.use_lang2visn_attn else c.num_x_layers
        out = {}
        for branch, enc in (("global", self.global_encoder),
                            ("local", self.local_encoder)):
            kvs = []
            for i, layer in enumerate(enc.layers):
                if i < n_hoist:
                    att = layer.crossattention
                    # the layer's heads (its local heads on a mesh)
                    split = lambda y, h=att.h: y.reshape(
                        y.shape[0], y.shape[1], h, -1)
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
                   generator=None, need_maps=False, front_vp_feats=None,
                   front_gmap_feats=None):
        """Dual-scale cross-modal forward + dynamic action fusion (token
        layouts as in the reference: gmap [stop], [mem], visited...,
        frontier...; vp [stop], [mem], pano views...).  ``front_gmap_feats``
        and ``front_vp_feats`` feed the map and viewpoint frontdoors
        (``do_front_his``, ``do_front_img``).  Under ``fuse_branches`` both
        encoders run as one trunk (``_branched_encoders``), which projects
        the instruction K/V in place: ``txt_cross_kvs`` is not read."""
        c = self.cfg
        gmap_embeds = self.gmap_input_norm(
            self._f(gmap_img_embeds)
            + self.gmap_step_embedding(gmap_step_ids)
            + self.gmap_pos_proj(self._f(gmap_pos_fts)))
        zdrop = {"deterministic": deterministic, "generator": generator}
        if c.do_front_his and front_gmap_feats is not None:
            with span("intervention.frontdoor_gmap"):
                gmap_embeds = self.gmap_frontdoor(
                    gmap_embeds, front_gmap_feats, None, **zdrop)
        vp_embeds = self.vp_input_norm(
            self._f(vp_img_embeds) + self.vp_pos_proj(self._f(vp_pos_fts)))
        if c.do_front_img and front_vp_feats is not None:
            with span("intervention.frontdoor_vp"):
                vp_embeds = self.vp_frontdoor(vp_embeds, front_vp_feats,
                                              None, **zdrop)
        drop = {"deterministic": deterministic, "generator": generator,
                "need_maps": need_maps}
        if c.fuse_branches:
            (gmap_embeds, vp_embeds, gmap_attns, vp_attns, global_scores,
             local_scores) = self._branched_encoders(
                gmap_embeds, vp_embeds, txt_embeds, gmap_masks, vp_masks,
                txt_masks, gmap_pair_dists, **drop)
        else:
            kvs = txt_cross_kvs or {}
            gmap_embeds, gmap_attns = self.global_encoder(
                gmap_embeds, txt_embeds, gmap_masks, txt_masks,
                gmap_pair_dists, cross_kvs=kvs.get("global"), **drop)
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

    # ---- the branch-fused trunk (fuse_branches) -------------------------

    def _branch_weights(self):
        """The two encoders' per-layer parameters and the two SAP heads',
        stacked on a leading branch axis (global, local): ``{"layer_i":
        {name: [2, ...]}, "head": {name: [2, ...]}}``.  With autograd
        recording (training) they are stacked on every call, so gradients
        reach both encoders.  Otherwise they are stacked once and reused
        until a parameter changes: the key holds each source's storage and
        version counter, which an in-place update (``load_flax_params``,
        an optimizer step, ``load_state_dict``) bumps and ``to()`` replaces."""
        pairs = {f"layer_{i}": (g, l) for i, (g, l) in enumerate(
            zip(self.global_encoder.layers, self.local_encoder.layers))}
        pairs["head"] = (self.global_sap_head, self.local_sap_head)
        named = {k: (dict(g.named_parameters()), dict(l.named_parameters()))
                 for k, (g, l) in pairs.items()}
        grads = torch.is_grad_enabled() and any(
            p.requires_grad for g, _ in named.values() for p in g.values())
        if not grads:
            key = tuple((p.data_ptr(), p._version) for g, l in named.values()
                        for n in g for p in (g[n], l[n]))
            if self._stacked is not None and self._stacked[0] == key:
                return self._stacked[1]
        stacked = {k: {n: torch.stack([g[n], l[n]]) for n in g}
                   for k, (g, l) in named.items()}
        if not grads:
            self._stacked = (key, stacked)
        return stacked

    def _branched_encoders(self, gmap_x, vp_x, lang, gmap_mask, vp_mask,
                           lang_mask, pair_dists, deterministic=True,
                           generator=None, need_maps=False):
        """The global and local cross-modal encoders and SAP heads as one
        computation over branch-stacked weights (JAX's
        ``_branched_encoders``): the vp stream is padded to L = max(G, P)
        (masks make the padding inert), every product runs as one batched
        product over the branch axis, and each attention takes both
        branches at batch 2B: one ``packed_attention`` launch where the
        unfused trunk makes two.  The self-attention bias is [2, B, H, L,
        L]: the global branch's graph sprels (``global_encoder.
        sprel_linear``), zeros for the local branch.  Math per branch is
        ``CrossModalEncoder``'s.  Returns (gmap embeds, vp embeds, their
        cross-attention maps, global scores, local scores)."""
        c = self.cfg
        b, g_len, p_len = gmap_x.shape[0], gmap_x.shape[1], vp_x.shape[1]
        L, h = max(g_len, p_len), c.num_attention_heads
        pad = lambda x: F.pad(x, (0, 0) * (x.dim() - 2) + (0, L - x.shape[1]))
        visn = torch.stack([pad(gmap_x), pad(vp_x)])            # [2, B, L, d]
        vmask = torch.stack([pad(gmap_mask), pad(vp_mask)])      # [2, B, L]
        rel = visn.new_zeros((b, h, L, L))
        if c.graph_sprels and pair_dists is not None:
            x = (1.0 / (1.0 + pair_dists[..., None])).to(visn.dtype)
            rel = self.global_encoder.sprel_linear(x).permute(0, 3, 1, 2)
            rel = F.pad(rel, (0, L - g_len, 0, L - g_len))
        w = self._branch_weights()
        drop = {"deterministic": deterministic, "generator": generator}
        lang_bias = mask_to_bias(lang_mask, visn.dtype).repeat(2, 1, 1, 1)
        visn_bias = mask_to_bias(vmask.flatten(0, 1), visn.dtype)
        # every layer's self-attention bias: the masks plus the sprels
        self_bias = visn_bias + torch.stack(
            [rel, torch.zeros_like(rel)]).flatten(0, 1)
        lang_s = lang[None].expand(2, *lang.shape)
        attns = []
        for i, layer in enumerate(self.global_encoder.layers):
            p = w[f"layer_{i}"]
            # a mesh's split of each linear (parallel.shard_params)
            lin = lambda x, name, layer=layer: parallel_linear(
                x, p[name + ".weight"], p[name + ".bias"],
                getattr(layer.get_submodule(name), "tp", None),
                _branch_linear)
            add_norm = lambda res, x, name: _branch_layer_norm(
                res + dropout(x, c.hidden_dropout, deterministic, generator,
                              batch_dim=1),
                p[name + ".LayerNorm_0.weight"],
                p[name + ".LayerNorm_0.bias"], c.layer_norm_eps)

            def attention(mod, name, q_in, kv_in, bias, maps):
                q = lin(q_in, name + ".query").flatten(0, 1)
                k = lin(kv_in, name + ".key").flatten(0, 1)
                v = lin(kv_in, name + ".value").flatten(0, 1)
                ctx, probs = mod.attend(q, k, v, bias, need_maps=maps,
                                        branches=2, **drop)
                return lin(ctx.unflatten(0, (2, b)), name + ".out"), probs

            x_out, x_probs = attention(layer.crossattention, "crossattention",
                                       visn, lang_s, lang_bias, need_maps)
            visn = add_norm(visn, x_out, "crossattention_norm")
            if layer.lang2visn:
                l_out, _ = attention(layer.lang2visn_attention,
                                     "lang2visn_attention", lang_s, visn,
                                     visn_bias, False)
                lang_s = add_norm(lang_s, l_out, "lang2visn_norm")
            s_out, _ = attention(layer.self_attention, "self_attention", visn,
                                 visn, self_bias, need_maps)
            visn = add_norm(visn, s_out, "self_norm")
            ff = lin(F.gelu(lin(visn, "ffn.intermediate"),
                            approximate=layer.ffn.approximate), "ffn.output")
            visn = add_norm(visn, ff, "ffn_norm")
            attns.append(x_probs.unflatten(0, (2, b)))
        attns = torch.stack(attns, dim=2)                # [2, B, nl, L, Lt]
        hp = w["head"]
        y = F.gelu(_branch_linear(visn, hp["dense.weight"], hp["dense.bias"]))
        y = _branch_layer_norm(y, hp["norm.weight"], hp["norm.bias"],
                               c.layer_norm_eps)
        scores = _branch_linear(y, hp["score.weight"], hp["score.bias"])[..., 0]
        return (visn[0, :, :g_len], visn[1, :, :p_len],
                attns[0][:, :, :g_len], attns[1][:, :, :p_len],
                scores[0, :, :g_len], scores[1, :, :p_len])

    # ---- mode: extract_cfp_features -------------------------------------

    def extract_cfp(self, txt_embeds, gmap_embeds, vp_embeds):
        """Pooled trajectory features for the frontdoor dictionaries: the
        [CLS]/[STOP] tokens through ``txt_emb_w``/``gmap_txt_w``/
        ``vp_txt_w`` when the model has the KD heads (raw otherwise), each
        scaled to unit length (norm floored at 1e-8)."""
        txt, gmap, vp = txt_embeds[:, 0], gmap_embeds[:, 0], vp_embeds[:, 0]
        if self.cfg.kd_heads:
            txt = self.txt_emb_w(self._f(txt))
            gmap = self.gmap_txt_w(self._f(gmap))
            vp = self.vp_txt_w(self._f(vp))
        norm = lambda x: x / torch.linalg.norm(
            x, dim=-1, keepdim=True).clamp(min=1e-8)
        return {"txt": norm(txt), "gmap": norm(gmap), "vp": norm(vp)}


def _branch_linear(x, weight, bias):
    """``nn.Linear`` per branch: ``x`` [2, ..., in] with ``weight`` [2, out,
    in] and ``bias`` [2, out] (or ``None``), as one batched product."""
    x2, w = x.reshape(2, -1, x.shape[-1]), weight.transpose(1, 2)
    y = (torch.bmm(x2, w) if bias is None
         else torch.baddbmm(bias[:, None, :], x2, w))
    return y.reshape(*x.shape[:-1], weight.shape[1])


def _branch_layer_norm(x, weight, bias, eps):
    """``nn.LayerNorm`` per branch over the last axis of [2, ..., d]."""
    shape = (2,) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return (F.layer_norm(x, x.shape[-1:], eps=eps) * weight.reshape(shape)
            + bias.reshape(shape))


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
