"""The dual-scale navigator (VLN-DUET / VLN-MAGIC) as plain PyTorch.

A functional forward over a dict of weights in flax's layout (Dense
kernels [in, out], embeddings [rows, width]), one episode at a time and
over the valid tokens only, so no padding or masking enters it: the
instruction encoder (RoBERTa embeddings, post-LN BERT layers), the
panorama encoder (view + angle features + navigation type, self-attention
layers, learned pooling), and the navigation step, in which a global
cross-modal encoder over the map's nodes (with a per-head bias from pair
distances) and a local one over the current panorama score the actions,
fused by a learned gate (reference: ``map_nav_src/models/vilmodel.py``,
``pretrain_src/config/r2r_magic_model_config.json``).

``precision`` ``"f32"`` is the reference; ``"fp8"`` rounds every operand
of every matrix product (weights, linear layers' inputs, the attention's
Q, K, V and probabilities) to float8 e4m3 with one scale per tensor, the
control of the correctness check.  Nothing here imports the program.

This is the base navigator, the module of every configuration that names
no other (``portbench.harness``).  A configuration whose model adds heads
brings a module of its own that subclasses ``Navigator`` and overrides
``language`` or the three points where the tokens enter the layers
(``pano_input``, ``gmap_input``, ``vp_input``), reading its fixed inputs
from ``self.inputs``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-12


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Every weight of the navigator at ``cfg``'s widths, by flax name, in
    flax's layout: the names a checkpoint of the reference model carries."""
    d, ff = cfg["hidden_size"], cfg["hidden_size"] * cfg["mlp_ratio"]
    out = {}

    def dense(name, n_in, n_out):
        out[f"{name}.kernel"] = (n_in, n_out)
        out[f"{name}.bias"] = (n_out,)

    def norm(name, width=d):
        out[f"{name}.scale"] = (width,)
        out[f"{name}.bias"] = (width,)

    def attention(name):
        for p in ("query", "key", "value", "out"):
            dense(f"{name}.{p}", d, d)

    def ffn(name):
        dense(f"{name}.ffn.intermediate", d, ff)
        dense(f"{name}.ffn.output", ff, d)
        norm(f"{name}.ffn_norm.LayerNorm_0")

    def layer(name):
        attention(f"{name}.attention")
        norm(f"{name}.attention_norm.LayerNorm_0")
        ffn(name)

    def cross_layer(name):
        for a in ("crossattention", "lang2visn_attention", "self_attention"):
            attention(f"{name}.{a}")
        for n in ("crossattention_norm", "lang2visn_norm", "self_norm"):
            norm(f"{name}.{n}.LayerNorm_0")
        ffn(name)

    def head(name, width):
        dense(f"{name}.dense", width, width)
        norm(f"{name}.norm", width)
        dense(f"{name}.score", width, 1)

    p = "params"
    if cfg.get("kd_heads"):
        for w in ("txt", "img", "local", "global", "predict"):
            out[f"{p}.kdl_{w}_weight"] = ()
        for w in ("txt_emb_w", "vp_txt_w", "gmap_txt_w", "local_cross_w",
                  "global_cross_w", "kdl_img_w", "kdl_avg_img_w"):
            dense(f"{p}.{w}", d, cfg["kd_target_size"])
    le = f"{p}.lang_encoder"
    out[f"{le}.word_embeddings.embedding"] = (cfg["vocab_size"], d)
    out[f"{le}.position_embeddings.embedding"] = (
        cfg["max_position_embeddings"], d)
    out[f"{le}.token_type_embeddings.embedding"] = (cfg["type_vocab_size"], d)
    norm(f"{le}.emb_norm")
    for i in range(cfg["num_l_layers"]):
        layer(f"{le}.layer_{i}")
    pe = f"{p}.pano_encoder"
    dense(f"{pe}.img_proj", cfg["image_feat_size"], d)
    norm(f"{pe}.img_norm")
    dense(f"{pe}.loc_proj", cfg["angle_feat_size"] + 3, d)
    norm(f"{pe}.loc_norm")
    out[f"{pe}.nav_type_embedding.embedding"] = (3, d)
    norm(f"{pe}.fuse_norm")
    for i in range(cfg["num_pano_layers"]):
        layer(f"{pe}.layer_{i}")
    dense(f"{pe}.fusion_score", d, 1)
    for enc in ("local_encoder", "global_encoder"):
        for i in range(cfg["num_x_layers"]):
            cross_layer(f"{p}.{enc}.layer_{i}")
    dense(f"{p}.global_encoder.sprel_linear", 1, cfg["num_attention_heads"])
    out[f"{p}.gmap_step_embedding.embedding"] = (cfg["max_action_steps"], d)
    dense(f"{p}.gmap_pos_proj", 7, d)
    norm(f"{p}.gmap_input_norm")
    dense(f"{p}.vp_pos_proj", 14, d)
    norm(f"{p}.vp_input_norm")
    head(f"{p}.global_sap_head", d)
    head(f"{p}.local_sap_head", d)
    head(f"{p}.sap_fuse_linear", 2 * d)
    dense(f"{p}.cls_fuse", 2 * d, d)
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor."""
    scale = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Navigator:
    """The reference forward.  ``weights``: flax name -> f32 tensor;
    ``inputs``: the configuration's fixed inputs besides its weights (the
    module's ``inputs(cfg)``, as handed to the program), which the base
    navigator has none of."""

    def __init__(self, cfg: dict, weights: dict, precision: str = "f32",
                 inputs: dict | None = None):
        self.cfg = cfg
        self.inputs = inputs or {}
        self.h = cfg["num_attention_heads"]
        self.fp8 = precision == "fp8"
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.w = {k: (_fp8(v) if self.fp8 and v.dim() == 2 else v)
                  for k, v in weights.items()}

    # ---- blocks ---------------------------------------------------------

    def low(self, x):
        """``x`` as a matrix product's operand in this precision."""
        return _fp8(x) if self.fp8 else x

    def lin(self, name, x):
        return self.low(x) @ self.w[f"{name}.kernel"] + self.w[f"{name}.bias"]

    def norm(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.scale"],
                            self.w[f"{name}.bias"], LN_EPS)

    def attend(self, name, q_in, kv_in, bias=None):
        """Multi-head attention of [Lq, d] over [Lk, d]; ``bias`` [H, Lq,
        Lk] or None."""
        h = self.h
        q = self.lin(f"{name}.query", q_in)
        k = self.lin(f"{name}.key", kv_in)
        v = self.lin(f"{name}.value", kv_in)
        hd = q.shape[-1] // h
        split = lambda x: self.low(x).reshape(x.shape[0], h, hd).transpose(
            0, 1)
        s = split(q) @ split(k).transpose(1, 2) / math.sqrt(hd)
        if bias is not None:
            s = s + bias
        ctx = self.low(torch.softmax(s, dim=-1)) @ split(v)
        return self.lin(f"{name}.out", ctx.transpose(0, 1).reshape(
            q.shape[0], -1))

    def ffn(self, name, x):
        y = self.lin(f"{name}.ffn.output",
                     F.gelu(self.lin(f"{name}.ffn.intermediate", x)))
        return self.norm(f"{name}.ffn_norm.LayerNorm_0", x + y)

    def self_layer(self, name, x):
        x = self.norm(f"{name}.attention_norm.LayerNorm_0",
                      x + self.attend(f"{name}.attention", x, x))
        return self.ffn(name, x)

    def cross_layer(self, name, visn, lang, self_bias=None):
        visn = self.norm(f"{name}.crossattention_norm.LayerNorm_0",
                         visn + self.attend(f"{name}.crossattention", visn,
                                            lang))
        lang = self.norm(f"{name}.lang2visn_norm.LayerNorm_0",
                         lang + self.attend(f"{name}.lang2visn_attention",
                                            lang, visn))
        visn = self.norm(f"{name}.self_norm.LayerNorm_0",
                         visn + self.attend(f"{name}.self_attention", visn,
                                            visn, self_bias))
        return self.ffn(name, visn), lang

    def head(self, name, x):
        y = self.norm(f"{name}.norm", F.gelu(self.lin(f"{name}.dense", x)))
        return self.lin(f"{name}.score", y)[..., 0]

    def emb(self, name, ids):
        return self.w[f"{name}.embedding"][ids]

    # ---- the three parts ------------------------------------------------

    def language(self, ids: torch.Tensor) -> torch.Tensor:
        """[L] token ids (every one valid) -> [L, d]."""
        c, le = self.cfg, "params.lang_encoder"
        pos = torch.arange(len(ids), device=ids.device) + c["pad_token_id"] + 1
        x = (self.emb(f"{le}.word_embeddings", ids)
             + self.emb(f"{le}.position_embeddings", pos)
             + self.emb(f"{le}.token_type_embeddings",
                        torch.zeros_like(ids)))
        x = self.norm(f"{le}.emb_norm", x)
        for i in range(c["num_l_layers"]):
            x = self.self_layer(f"{le}.layer_{i}", x)
        return x

    def panorama(self, img, loc, nav_type):
        """The valid panorama tokens (candidates, then views no candidate
        occupies): image features [P, D], location features [P, 7] and
        navigation types [P] -> (token embeddings [P, d], pooled [d])."""
        pe = "params.pano_encoder"
        x = self.pano_input(img, loc, nav_type)
        for i in range(self.cfg["num_pano_layers"]):
            x = self.self_layer(f"{pe}.layer_{i}", x)
        w = torch.softmax(self.lin(f"{pe}.fusion_score", x)[:, 0], dim=0)
        return x, w @ x

    def pano_input(self, img, loc, nav_type):
        """The panorama's tokens [P, d] as they enter its layers."""
        pe = "params.pano_encoder"
        return self.norm(f"{pe}.fuse_norm",
                         self.norm(f"{pe}.img_norm",
                                   self.lin(f"{pe}.img_proj", img))
                         + self.norm(f"{pe}.loc_norm",
                                     self.lin(f"{pe}.loc_proj", loc))
                         + self.emb(f"{pe}.nav_type_embedding", nav_type))

    def gmap_input(self, gmap_img, gmap_step, gmap_pos):
        """The map's tokens [G, d] as they enter the global branch."""
        p = "params"
        return self.norm(f"{p}.gmap_input_norm",
                         gmap_img + self.emb(f"{p}.gmap_step_embedding",
                                             gmap_step)
                         + self.lin(f"{p}.gmap_pos_proj", gmap_pos))

    def vp_input(self, vp_img, vp_pos):
        """The viewpoint's tokens [V, d] as they enter the local branch."""
        p = "params"
        return self.norm(f"{p}.vp_input_norm",
                         vp_img + self.lin(f"{p}.vp_pos_proj", vp_pos))

    def navigation(self, txt, gmap_img, gmap_step, gmap_pos, pair_dist,
                   vp_img, vp_pos):
        """One decision.  gmap tokens: [stop], then the observed nodes; vp
        tokens: [stop], [mem], then the valid panorama tokens.
        Returns (gmap scores [G], vp scores [V], the fusion gate, [MEM]
        for the next step)."""
        p, c = "params", self.cfg
        g = self.gmap_input(gmap_img, gmap_step, gmap_pos)
        v = self.vp_input(vp_img, vp_pos)
        sprel = self.lin(f"{p}.global_encoder.sprel_linear",
                         (1.0 / (1.0 + pair_dist))[..., None])
        sprel = sprel.permute(2, 0, 1)
        lang_g = lang_v = txt
        for i in range(c["num_x_layers"]):
            g, lang_g = self.cross_layer(f"{p}.global_encoder.layer_{i}", g,
                                         lang_g, sprel)
            v, lang_v = self.cross_layer(f"{p}.local_encoder.layer_{i}", v,
                                         lang_v)
        g_scores = self.head(f"{p}.global_sap_head", g)
        v_scores = self.head(f"{p}.local_sap_head", v)
        both = torch.cat([g[0], v[0]])
        fuse = torch.sigmoid(self.head(f"{p}.sap_fuse_linear", both))
        return g_scores, v_scores, fuse, self.lin(f"{p}.cls_fuse", both)
