"""GOAT's navigator (Wang et al., "Vision-and-Language Navigation via
Causal Learning", CVPR 2024, github.com/CrystalSixone/VLN-GOAT), the
teacher that VLN-MAGIC distills, as plain PyTorch: the dual-scale
navigator (``reference.model``) with its five causal-intervention heads.

Each head is an attention of a token stream over a dictionary of
confounders: every token queries the projected dictionary ``z_proj(z)``
(multi-head, the scores biased by ``log(max(p, 1e-8))`` where the
dictionary has priors p(z), so a padded row at p 0 weighs exp(-18.42)),
the result ``a`` is added through a learned gate, ``x + sigmoid(gate([x,
a])) * a`` (``do_add_method`` ``door``; ``add``: ``x + a``), then
LayerNorm.  The heads enter at three places:

- the instruction, after its encoder: the direction backdoor, then the
  landmark backdoor (81 rows each, with priors), then the text frontdoor
  (``do_back_txt``, ``do_front_txt``);
- the panorama, after ``fuse_norm`` and before its layers: the image
  backdoor over 50 CLIP rows with priors, ``image_z_dict_clip_50.tsv``
  (``do_back_img``);
- the map and viewpoint tokens, as they enter the global and local
  branches: the map and viewpoint frontdoors (``do_front_his``,
  ``do_front_img``).

The frontdoors' dictionaries are 24 k-means exemplars of the navigator's
own trajectory features (``--front_n_clusters``), at ``kd_target_size``
with the KD heads, else the hidden size; they carry no priors.

Where the equations come from: VLN-MAGIC omitted its model code
(``SURVEY.md`` §0.1), so they are written to the program's
``ZdictAttention`` and where it calls each head.  The reference's
``do_back_txt_type`` and ``do_back_img_type`` select nothing in the program
or in the JAX package; every backdoor is the attention above.

The dictionaries are the configuration's fixed input (``inputs``), drawn
from its ``weights_seed`` in the layout of the program's
``build_rollout_zdicts``: no public dictionary is in the repository.
Loaded as ``reference.goat``; nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model

DIRECTION_ROWS = 81     # the backdoors' tables, padded to 81 rows at p 0
DIRECTION_WORDS = 26    # the reference's direction words
LANDMARK_ROWS = 81
IMAGE_ROWS = 50         # image_z_dict_clip_50.tsv
FRONT_ROWS = 24         # --front_n_clusters
# the scale of the rows of the instruction's three dictionaries (the
# direction, landmark and text frontdoor tables); the others are at the
# view features' unit scale.  At weights N(0, 0.02) the instruction barely
# moves a decision: at scale 1 (and 3) a withheld text dictionary read
# within the program's own spread on goat-t768, at 10 it reads as far
# above as a withheld image dictionary (PERF.md §6)
TEXT_SCALE = 10.0

TXT_BACK = ("params.txt_backdoor_direction", "params.txt_backdoor_landmark")
TXT_FRONT = "params.txt_frontdoor"
IMG_BACK = "params.pano_encoder.img_backdoor"
VP_FRONT = "params.vp_frontdoor"
GMAP_FRONT = "params.gmap_frontdoor"


def _front_width(m: dict) -> int:
    return m["kd_target_size"] if m.get("kd_heads") else m["hidden_size"]


def heads(m: dict) -> list[tuple[str, int, int]]:
    """(flax name, dictionary width, dictionary rows) of every head ``m``
    turns on."""
    d, f = m["hidden_size"], _front_width(m)
    out = []
    if m.get("do_back_txt"):
        out += [(TXT_BACK[0], d, DIRECTION_ROWS), (TXT_BACK[1], d,
                                                   LANDMARK_ROWS)]
    if m.get("do_front_txt"):
        out.append((TXT_FRONT, f, FRONT_ROWS))
    if m.get("do_back_img"):
        out.append((IMG_BACK, m["image_feat_size"], IMAGE_ROWS))
    if m.get("do_front_img"):
        out.append((VP_FRONT, f, FRONT_ROWS))
    if m.get("do_front_his"):
        out.append((GMAP_FRONT, f, FRONT_ROWS))
    return out


def _door(m: dict) -> bool:
    return m.get("do_add_method", "door") == "door"


def param_shapes(m: dict) -> dict[str, tuple]:
    d = m["hidden_size"]
    out = model.param_shapes(m)
    for head, width, _ in heads(m):
        dense = [("z_proj", width)] + [(f"attention.{p}", d) for p in (
            "query", "key", "value", "out")]
        if _door(m):
            dense.append(("gate", 2 * d))
        for name, n_in in dense:
            out[f"{head}.{name}.kernel"] = (n_in, d)
            out[f"{head}.{name}.bias"] = (d,)
        out[f"{head}.norm.scale"] = (d,)
        out[f"{head}.norm.bias"] = (d,)
    return out


def _zipf(rows: int, real: int) -> np.ndarray:
    """Priors [rows, 1]: Zipf over the first ``real`` rows, 0 after."""
    p = np.zeros((rows, 1), np.float32)
    p[:real, 0] = 1.0 / np.arange(1, real + 1)
    return p / p.sum()


def inputs(cfg: dict) -> dict:
    """The student's dictionaries of every head the configuration turns on,
    as ``build_rollout_zdicts`` lays them out: each real row a standard
    normal draw (as the traffic's view features are; the instruction's
    tables ``TEXT_SCALE`` times that), priors Zipf over the real rows; the
    direction table 26 real rows (the direction words) and 55 of zeros at
    p 0."""
    m = cfg["model"]
    rng = np.random.default_rng([cfg["weights_seed"], 1])
    draw = lambda rows, width: rng.standard_normal((rows, width),
                                                   dtype=np.float32)
    text = lambda rows, width: TEXT_SCALE * draw(rows, width)
    d, f = m["hidden_size"], _front_width(m)
    z = {}
    if m.get("do_back_txt"):
        direction = np.zeros((DIRECTION_ROWS, d), np.float32)
        direction[:DIRECTION_WORDS] = text(DIRECTION_WORDS, d)
        z["instr_zdict"] = {
            "direction_features": direction,
            "direction_pzs": _zipf(DIRECTION_ROWS, DIRECTION_WORDS),
            "landmark_features": text(LANDMARK_ROWS, d),
            "landmark_pzs": _zipf(LANDMARK_ROWS, LANDMARK_ROWS)}
    if m.get("do_back_img"):
        z["z_img_feats"] = draw(IMAGE_ROWS, m["image_feat_size"])
        z["z_img_pzs"] = _zipf(IMAGE_ROWS, IMAGE_ROWS)
    for flag, key, rows in (("do_front_txt", "front_txt_feats", text),
                            ("do_front_img", "front_vp_feats", draw),
                            ("do_front_his", "front_gmap_feats", draw)):
        if m.get(flag):
            z[key] = rows(FRONT_ROWS, f)
    return {"zdicts": {"student": z}}


class Navigator(model.Navigator):
    """The base navigator with the heads its configuration turns on, over
    the dictionaries of ``inputs``."""

    def __init__(self, cfg, weights, precision="f32", inputs=None):
        super().__init__(cfg, weights, precision, inputs)
        dev = next(iter(weights.values())).device
        z = self.inputs.get("zdicts", {}).get("student", {})
        flat = dict(z.get("instr_zdict", {}), **{
            k: v for k, v in z.items() if k != "instr_zdict"})
        self.z = {k: torch.as_tensor(v, device=dev) for k, v in flat.items()}

    def intervene(self, head, x, feats, pzs=None):
        """``x`` [N, d] after the head over the dictionary ``feats`` [K, D]
        (priors ``pzs`` [K, 1] or None)."""
        z = self.lin(f"{head}.z_proj", feats)
        bias = None if pzs is None else torch.log(pzs[:, 0].clamp(min=1e-8))
        a = self.attend(f"{head}.attention", x, z, bias)
        if _door(self.cfg):
            a = torch.sigmoid(self.lin(f"{head}.gate",
                                       torch.cat([x, a], -1))) * a
        return self.norm(f"{head}.norm", x + a)

    def language(self, ids):
        x = super().language(ids)
        if self.cfg.get("do_back_txt"):
            for head, kind in zip(TXT_BACK, ("direction", "landmark")):
                x = self.intervene(head, x, self.z[f"{kind}_features"],
                                   self.z[f"{kind}_pzs"])
        if self.cfg.get("do_front_txt"):
            x = self.intervene(TXT_FRONT, x, self.z["front_txt_feats"])
        return x

    def pano_input(self, img, loc, nav_type):
        x = super().pano_input(img, loc, nav_type)
        if self.cfg.get("do_back_img"):
            x = self.intervene(IMG_BACK, x, self.z["z_img_feats"],
                               self.z["z_img_pzs"])
        return x

    def gmap_input(self, gmap_img, gmap_step, gmap_pos):
        x = super().gmap_input(gmap_img, gmap_step, gmap_pos)
        if self.cfg.get("do_front_his"):
            x = self.intervene(GMAP_FRONT, x, self.z["front_gmap_feats"])
        return x

    def vp_input(self, vp_img, vp_pos):
        x = super().vp_input(vp_img, vp_pos)
        if self.cfg.get("do_front_img"):
            x = self.intervene(VP_FRONT, x, self.z["front_vp_feats"])
        return x


# ---- FLOPs ------------------------------------------------------------
# ``portbench.flops``'s convention (2 FLOPs a multiply-add, products only,
# at the padded shapes), restated here, since a configuration's module
# replaces those counts whole and loads nothing of the harness; then the
# heads.  A head over N tokens and K rows: Q and O (4 N d^2), the gate
# (4 N d^2, ``door``), scores and values (4 N K d), a step for the panorama's, viewpoint's and
# map's heads; each dictionary's own projections (z_proj, then K and V:
# 2 K D d + 4 K d^2) once an episode, with the instruction's heads.

def _self_layers(n_layers, n, d):
    return n_layers * (24 * n * d * d + 4 * n * n * d)


def _cross_layers(n_layers, n, lang, d):
    per = (4 * n * d * d + 4 * n * lang * d
           + 4 * lang * d * d + 4 * n * d * d + 4 * lang * n * d
           + 8 * n * d * d + 4 * n * n * d + 16 * n * d * d)
    return n_layers * per + (n_layers - 1) * 4 * lang * d * d


def _head(m, n, rows):
    d = m["hidden_size"]
    return (8 if _door(m) else 4) * n * d * d + 4 * n * rows * d


def instruction_flops(m: dict, lang: int) -> float:
    """One instruction: its encoding, its hoisted layer-0 K/V (both
    branches), the instruction's heads and every dictionary's
    projections."""
    d = m["hidden_size"]
    base = _self_layers(m["num_l_layers"], lang, d) + 2 * 4 * lang * d * d
    on = heads(m)
    txt = sum(_head(m, lang, rows) for head, _, rows in on
              if head in TXT_BACK + (TXT_FRONT,))
    dicts = sum(2 * rows * width * d + 4 * rows * d * d
                for _, width, rows in on)
    return base + txt + dicts


def step_flops(m: dict, lang: int, gmap: int, pano: int) -> float:
    """One episode-step: the panorama, the global branch over ``gmap``
    tokens and the local one over ``pano`` + 2, the scoring heads and the
    fusion; then the image backdoor over the panorama's tokens and the
    viewpoint and map frontdoors over their branches' tokens."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    vp = pano + 2
    pano_f = (2 * pano * (m["image_feat_size"] + m["angle_feat_size"] + 3)
              * d + _self_layers(m["num_pano_layers"], pano, d)
              + 2 * pano * d)
    nav = (2 * gmap * 7 * d + 2 * vp * 14 * d + 2 * gmap * gmap * h
           + _cross_layers(m["num_x_layers"], gmap, lang, d)
           + _cross_layers(m["num_x_layers"], vp, lang, d)
           + (2 * d * d + 2 * d) * (gmap + vp)
           + 2 * (2 * d) ** 2 + 2 * 2 * d + 2 * 2 * d * d)
    tokens = {IMG_BACK: pano, VP_FRONT: vp, GMAP_FRONT: gmap}
    heads_f = sum(_head(m, tokens[head], rows) for head, _, rows in heads(m)
                  if head in tokens)
    return pano_f + nav + heads_f
