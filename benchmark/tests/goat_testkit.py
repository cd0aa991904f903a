"""GOAT in the benchmark's tests: a tiny copy of the ``goat-t768``
configuration (the tiny model with all five causal-intervention heads and
the module ``reference/goat.py``) added to a tiny benchmark, and the
program's dictionaries with one of them withheld."""

from __future__ import annotations

import json
import os

import numpy as np
from portbench_testkit import REAL

HEADS = {"do_back_txt": True, "do_back_img": True, "do_front_txt": True,
         "do_front_img": True, "do_front_his": True,
         "do_add_method": "door"}
# the six dictionaries, each as the program is handed it
DICTS = ("direction", "landmark", "image", "front_txt", "front_vp",
         "front_gmap")

# the tiny GOAT cells' limits, set on the CPU from 21 (eval) and 24 (serve)
# seeds at 0.5 s, every episode of the window replayed: the program read at
# most 0.00185 / 2.07e-5 (eval) and 0.00140 / 5.40e-5 (serve); the control
# at least 0.00268 / 6.03e-5 (eval), and 0 on 4 serve seeds of 24, whose
# windows left it no free decision
GOAT_LIMITS = {
    "eval": {"logit_gap": 0.004, "mean_logit_gap": 3.5e-5,
             "bad_trajectories": 0, "metric_mismatches": 0},
    "serve": {"logit_gap": 0.003, "mean_logit_gap": 1.1e-4,
              "bad_decisions": 0},
}
# the dictionaries whose withholding the tiny eval cell sees on every seed
# tried (4): at the tiny widths (hidden 32, weights N(0, 0.02)) the
# instruction hardly moves a decision, so a withheld text dictionary reads
# the program's own gaps, and the map frontdoor's, and every one in the
# serve cell's short windows, read under the limits on some seeds; all six
# are held to goat-t768's limits on the card
SEEN_WITHHELD = ("image", "front_vp")


def add_goat(path: str) -> None:
    """Add to the tiny copy whose ``BENCHMARK.json`` is ``path``, as new
    files and new entries only, the configuration ``tiny-goat`` (the tiny
    model with GOAT's five heads, naming ``reference/goat.py``, which the
    copy holds) and its cells ``tiny-goat.eval`` and ``tiny-goat.serve``:
    the tiny mixes with every episode of the window replayed, the tiny
    cells' metrics, limits of their own."""
    bench = os.path.join(os.path.dirname(path), "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(HEADS)
    cfg["reference"] = "goat"
    # a seed whose random model walks until it is stopped, as the tiny
    # cells' own does
    cfg["weights_seed"] = 3
    with open(os.path.join(bench, "configs", "tiny-goat.json"), "w") as f:
        json.dump(cfg, f)
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-goat", "source": "tiny",
                            "file": "benchmark/configs/tiny-goat.json",
                            "reduced": [], "why": "a test"})
    for kind in REAL:
        name = f"tiny-goat.{kind}"
        with open(os.path.join(bench, "traffic", f"{kind}.json")) as f:
            mix = dict(json.load(f), check_episodes=64, check_longest=8)
        with open(os.path.join(bench, "traffic", f"{kind}-all.json"),
                  "w") as f:
            json.dump(mix, f)
        spec["workloads"].append({"name": name, "config": "tiny-goat",
                                  "traffic": f"{kind}-all", "chips": 1,
                                  "why": "a test"})
        with open(os.path.join(bench, "limits", f"{name}.json"), "w") as f:
            json.dump(GOAT_LIMITS[kind], f)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if f"tiny.{kind}" in m.get("workloads", []):
                m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)


def withheld(zdicts: dict, which: str) -> dict:
    """The program's ``zdicts`` with the dictionary ``which`` (one of
    ``DICTS``) withheld.  The image backdoor and the frontdoors lose their
    entry, so the program skips the head; the two text backdoors run as a
    pair over ``instr_zdict``, so one of them is handed the table the port
    builds for a kind with no rows (``load_backdoor_tsv``: one row of
    zeros at p 1)."""
    z = dict(zdicts["student"])
    if which in ("direction", "landmark"):
        instr = dict(z["instr_zdict"])
        width = instr[f"{which}_features"].shape[1]
        instr[f"{which}_features"] = np.zeros((1, width), np.float32)
        instr[f"{which}_pzs"] = np.ones((1, 1), np.float32)
        z["instr_zdict"] = instr
    elif which == "image":
        del z["z_img_feats"], z["z_img_pzs"]
    else:
        del z[which + "_feats"]
    return {**zdicts, "student": z}
