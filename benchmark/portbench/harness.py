"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell's
configuration, traffic and metrics; the files under ``benchmark/`` are
found by those names:

- ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives): the
  model's widths as the program runs them, and its compute type; its
  optional key ``"reference"`` names the configuration's module,
  ``reference/<module>.py`` (absent: ``model``, the base navigator);
- ``reference/<module>.py``: the plain reference of a configuration's
  model, loaded as ``reference.<module>`` (so it may import the base
  modules relatively; otherwise only ``numpy``, ``torch`` and ``math``).
  It gives ``param_shapes(model_cfg)``, the flax names and shapes of every
  weight (``portbench.weights.draw`` draws these), and
  ``Navigator(model_cfg, weights, precision="f32", inputs=None)`` with
  ``language``, ``panorama`` and ``navigation`` as ``reference/replay.py``
  calls them (a subclass of ``reference.model.Navigator``).  Optionally
  ``inputs(cfg)``: the configuration's fixed inputs besides its weights,
  numpy arrays drawn from a seed in the configuration file, as keyword
  arguments of the program's public API (``Navigator.evaluate`` and
  ``NavFleet`` both take ``zdicts``), drawn once in set-up and handed to
  the program and to the reference alike; and ``instruction_flops(m,
  lang)`` and ``step_flops(m, lang, gmap, pano)``, which replace
  ``portbench.flops.instruction`` and ``.step`` in the windows' counts;
- ``traffic/<traffic>.json``: a mix's parameters; its ``kind`` names the
  driver (``portbench.cells.DRIVERS``);
- ``limits/<workload>.json``: the limit of each number the correctness
  check compares;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(run)`` that returns a number or None; a metric named
  ``<family>.<kind>`` with no file of its own is read by
  ``metrics/<family>.py``, one reader for every kind of cell.

A new configuration (with its own reference where its model adds to the
base navigator), mix, cell or per-layer metric is new files and new
entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from .cells import DRIVERS
from .check import judge, reference_gaps

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Spec:
    """``BENCHMARK.json`` and the files it leads to."""

    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json"),
                 bench_dir: str = BENCH_DIR):
        with open(path) as f:
            self.data = json.load(f)
        self.root = os.path.dirname(os.path.abspath(path))
        self.dir = bench_dir

    def _json(self, *parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return self._json(self.root, entry["file"])

    def reference(self, config: str):
        """The configuration's reference module (``reference/<module>.py``,
        the configuration file's ``"reference"``, else ``model``)."""
        name = self.config(config).get("reference", "model")
        return _load(f"reference.{name}",
                     os.path.join(self.dir, "reference", f"{name}.py"))

    def traffic(self, name: str) -> dict:
        return self._json(self.dir, "traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json(self.dir, "limits", f"{workload}.json")

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The cell's per-layer metrics: those that list it, and those with
        no ``workloads`` key whose ``moves`` metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str):
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        if not os.path.exists(path) and "." in metric:
            path = os.path.join(self.dir, "metrics",
                                f"{metric.rsplit('.', 1)[0]}.py")
        return _load("portbench_metric_" + metric.replace(".", "_")
                     .replace("-", "_"), path).read


def _load(name: str, path: str):
    """The module at ``path``, run as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What a metric reader reads: the cell's parameters, the window's
    numbers, the profiled stretch (``--trace 1``) and the shapes of the
    packed-attention calls made in it."""

    def __init__(self, workload, cfg, mix, window, profile, packed_calls):
        self.workload, self.cfg, self.mix = workload, cfg, mix
        self.window, self.profile = window, profile
        self.packed_calls = packed_calls


def execute(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
            device, started: float, control: bool = False) -> dict:
    """Set up, warm up, measure, read the trace, check; the result's line
    as a dict (``started``: the process's start, on ``time.perf_counter``'s
    clock).  With ``control`` the line also holds, under ``"control"``, the
    same check of the control: the reference in fp8 put in the program's
    place, its own choice at each of the program's decisions judged against
    the cell's limits, beside the program's exact counts (the benchmark's
    own runs never run it; ``benchmark/readings.py`` does)."""
    w = spec.workload(name)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    ref = spec.reference(w["config"])
    t_build = time.perf_counter()
    cell = DRIVERS[mix["kind"]](cfg, mix, seed, device, ref)
    t_warm = time.perf_counter()
    cell.warmup()
    # what set-up made lives to the end: keep the collector off it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started
    print(f"setup: {t_build - started:.3f} s to start, "
          f"{t_warm - t_build:.3f} s to build, "
          f"{started + setup_s - t_warm:.3f} s to warm up", file=sys.stderr)
    window = cell.window(seconds)
    window["setup_s"] = setup_s
    profile = cell.profile() if trace else None
    if hasattr(cell, "close"):
        cell.close()
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(name, cfg, mix, window, profile, cell.packed_calls)
    metrics = {}
    for m in (spec.per_layer(name) if trace else spec.end_to_end(name)):
        value = (spec.reader(m["name"])(run) if trace
                 else window[m["name"]])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.free()

    record = cell.record
    gaps = reference_gaps(record, cfg, ref, cell.host_weights, cell.inputs,
                          mix, seed, device, control)
    counts = record.counts(np.random.default_rng([seed, 4]))
    limits = spec.limits(name)
    correct, checks = judge({**gaps, **counts}, limits)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["wall_s"]
    out = {"correct": correct, "attempted": len(record.episodes),
           "failed": record.bad, "metrics": metrics, "device": dev}
    if profile is not None:
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    if control:
        ok, ctrl = judge({**gaps["control"], **counts}, limits)
        out["control"] = {"correct": ok, "checks": ctrl}
    out["checks"] = checks
    gc.unfreeze()
    return out
