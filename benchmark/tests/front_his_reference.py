"""The reference of a navigator with GOAT's map frontdoor (``do_front_his``),
a configuration's own module as the benchmark's tests add one: the base
navigator (``reference.model``), and where the map's tokens enter the
global branch, the causal intervention over a dictionary of confounder
exemplars (the port's ``ZdictAttention``): every token attends over the
projected dictionary, the result is added through a learned sigmoid gate
(``do_add_method`` ``door``), then LayerNorm.

The dictionary is the configuration's fixed input: ``ROWS`` exemplars at
the frontdoor's width (``kd_target_size`` with the KD heads, else the
hidden size), drawn from the configuration's ``weights_seed`` and handed to
the program as ``zdicts``.  Loaded as ``reference.front_his``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model

HEAD = "params.gmap_frontdoor"
ROWS = 24           # the navigation CLI's --front_n_clusters default


def _width(m: dict) -> int:
    return m["kd_target_size"] if m.get("kd_heads") else m["hidden_size"]


def param_shapes(m: dict) -> dict[str, tuple]:
    d = m["hidden_size"]
    out = model.param_shapes(m)
    for name, n_in in (("z_proj", _width(m)), ("attention.query", d),
                       ("attention.key", d), ("attention.value", d),
                       ("attention.out", d), ("gate", 2 * d)):
        out[f"{HEAD}.{name}.kernel"] = (n_in, d)
        out[f"{HEAD}.{name}.bias"] = (d,)
    out[f"{HEAD}.norm.scale"] = (d,)
    out[f"{HEAD}.norm.bias"] = (d,)
    return out


def inputs(cfg: dict) -> dict:
    rng = np.random.default_rng([cfg["weights_seed"], 1])
    feats = rng.standard_normal((ROWS, _width(cfg["model"])),
                                dtype=np.float32)
    return {"zdicts": {"student": {"front_gmap_feats": feats}}}


class Navigator(model.Navigator):

    def __init__(self, cfg, weights, precision="f32", inputs=None):
        super().__init__(cfg, weights, precision, inputs)
        feats = self.inputs["zdicts"]["student"]["front_gmap_feats"]
        self.front = torch.as_tensor(
            feats, device=weights[f"{HEAD}.z_proj.kernel"].device)

    def gmap_input(self, gmap_img, gmap_step, gmap_pos):
        x = super().gmap_input(gmap_img, gmap_step, gmap_pos)
        out = self.attend(f"{HEAD}.attention", x,
                          self.lin(f"{HEAD}.z_proj", self.front))
        gate = torch.sigmoid(self.lin(f"{HEAD}.gate",
                                      torch.cat([x, out], -1)))
        return self.norm(f"{HEAD}.norm", x + gate * out)
