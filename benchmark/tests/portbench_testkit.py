"""Shared pieces of the benchmark's own tests: the benchmark's directory on
``sys.path`` and a tiny copy of the benchmark (its ``BENCHMARK.json``,
configurations, references, traffic and limits) that runs on the CPU in
seconds."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_MODEL = {"vocab_size": 1000, "num_l_layers": 1, "num_pano_layers": 1,
              "num_x_layers": 2, "mlp_ratio": 4,
              "max_position_embeddings": 514, "type_vocab_size": 1,
              "max_action_steps": 100, "pad_token_id": 1,
              "image_feat_size": 16, "angle_feat_size": 4,
              "use_pallas_attention": True, "hidden_size": 32,
              "num_attention_heads": 2, "kd_heads": True,
              "kd_target_size": 48}
TINY_MIX = {"scans": 2, "nodes_per_scan": 30, "feat_dim": 16,
            "max_candidates": 8,
            "max_action_len": 6, "instr_len": 20, "check_episodes": 8,
            "check_longest": 2}
EVAL_MIX = dict(TINY_MIX, batch=8, max_gmap_len=24, warmup_waves=1,
                profile_waves=1, check_waves=2)
SERVE_MIX = dict(TINY_MIX, slots=4, max_gmap_len=34, warmup_ticks=2,
                 profile_ticks=2)
# the real cell whose limits and per-layer metrics each tiny cell takes
REAL = {"eval": "magic-s128.eval", "serve": "magic-s128.serve64"}


def real_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_benchmark(tmp_path, dtype: str = "bfloat16") -> str:
    """A benchmark directory under ``tmp_path`` holding the tiny cells
    ``tiny.eval`` and ``tiny.serve`` (the real mixes at tiny sizes, the
    real limits and metric readers), laid out as the real one; returns the
    path of its ``BENCHMARK.json``."""
    root = str(tmp_path)
    bench = os.path.join(root, "benchmark")
    for sub in ("metrics", "reference"):
        shutil.copytree(os.path.join(BENCH_DIR, sub),
                        os.path.join(bench, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub))
    dump = lambda obj, *parts: json.dump(
        obj, open(os.path.join(bench, *parts), "w"))
    dump({"source": "tiny", "reduced": [], "compute_dtype": dtype,
          "weights_seed": 2, "model": TINY_MODEL}, "configs", "tiny.json")
    real = real_spec()
    with open(os.path.join(BENCH_DIR, "traffic", "eval.json")) as f:
        dump(dict(json.load(f), **EVAL_MIX), "traffic", "eval.json")
    with open(os.path.join(BENCH_DIR, "traffic", "serve64.json")) as f:
        dump(dict(json.load(f), **SERVE_MIX), "traffic", "serve.json")
    workloads = []
    for kind, real_name in REAL.items():
        name = f"tiny.{kind}"
        workloads.append({"name": name, "config": "tiny", "traffic": kind,
                          "chips": 1, "why": "a test"})
        shutil.copy(os.path.join(BENCH_DIR, "limits", f"{real_name}.json"),
                    os.path.join(bench, "limits", f"{name}.json"))
    rename = {real_name: f"tiny.{kind}" for kind, real_name in REAL.items()}
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]
                              if w in rename]
    real["configs"] = [{"name": "tiny", "source": "tiny",
                        "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "a test"}]
    real["workloads"] = workloads
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(real, f, indent=1)
    return path


# the tiny frontdoor cells' limits, set on the CPU from 12 seeds a cell at
# 0.5 s, every episode of the window replayed: the program read at most
# 0.00179 / 1.69e-5 (eval) and 8e-5 / 1.4e-6 (serve), the control and the
# program handed no dictionary at least 0.0047 / 6.07e-5 (eval) and
# 0.00092 / 2.08e-5 (serve; the control read 0 on one seed)
FRONT_LIMITS = {
    "eval": {"logit_gap": 0.0035, "mean_logit_gap": 3.5e-5,
             "bad_trajectories": 0, "metric_mismatches": 0},
    "serve": {"logit_gap": 0.0005, "mean_logit_gap": 6e-6,
              "bad_decisions": 0},
}


def add_front_his(path: str) -> None:
    """Add to the tiny copy whose ``BENCHMARK.json`` is ``path``, as new
    files and new entries only, the configuration ``tiny-front`` (the tiny
    model with GOAT's map frontdoor, ``do_front_his``), the reference
    module it names (``reference/front_his.py``, from
    ``front_his_reference.py`` here) and its cells ``tiny-front.eval`` and
    ``tiny-front.serve``: the tiny mixes with every episode of the window
    replayed, the tiny cells' metrics, limits of their own."""
    bench = os.path.join(os.path.dirname(path), "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["model"]["do_front_his"] = True
    cfg["reference"] = "front_his"
    # the head's weights shift the draw; this seed's random model walks
    # until it is stopped, as the tiny cells' own does (seed 2 here stops
    # most episodes at once, leaving nothing free to compare)
    cfg["weights_seed"] = 3
    with open(os.path.join(bench, "configs", "tiny-front.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(BENCH_DIR, "tests", "front_his_reference.py"),
                os.path.join(bench, "reference", "front_his.py"))
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-front", "source": "tiny",
                            "file": "benchmark/configs/tiny-front.json",
                            "reduced": [], "why": "a test"})
    for kind in REAL:
        name = f"tiny-front.{kind}"
        with open(os.path.join(bench, "traffic", f"{kind}.json")) as f:
            mix = dict(json.load(f), check_episodes=64, check_longest=8)
        with open(os.path.join(bench, "traffic", f"{kind}-all.json"),
                  "w") as f:
            json.dump(mix, f)
        spec["workloads"].append({"name": name, "config": "tiny-front",
                                  "traffic": f"{kind}-all", "chips": 1,
                                  "why": "a test"})
        with open(os.path.join(bench, "limits", f"{name}.json"), "w") as f:
            json.dump(FRONT_LIMITS[kind], f)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if f"tiny.{kind}" in m.get("workloads", []):
                m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)


def run_tiny(path: str, workload: str, seed: int = 2 ** 31 + 7,
             seconds: float = 0.5, trace: bool = False,
             control: bool = False) -> dict:
    """One CPU run of a tiny cell, as ``run.py`` makes one on the card."""
    import time

    import torch

    from portbench.harness import Spec, execute

    torch.manual_seed(0)
    spec = Spec(path, os.path.join(os.path.dirname(path), "benchmark"))
    return execute(spec, workload, seed, seconds, trace, "cpu",
                   time.perf_counter(), control)
