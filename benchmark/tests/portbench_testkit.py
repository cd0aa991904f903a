"""Shared pieces of the benchmark's own tests: the benchmark's directory on
``sys.path`` and a tiny copy of the benchmark (its ``BENCHMARK.json``,
configurations, traffic and limits) that runs on the CPU in seconds."""

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
    shutil.copytree(os.path.join(BENCH_DIR, "metrics"),
                    os.path.join(bench, "metrics"))
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
