"""The window's arithmetic: a stall inside the window moves each end-to-end
metric, the decision tail is taken over every decision, and the FLOPs are
counted by the configuration's module where it gives counts of its own."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch
from portbench_testkit import tiny_benchmark


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# a configuration's module that gives FLOP counts of its own
COUNTED = ('"""The base navigator, counted otherwise."""\n\n'
           'from .model import Navigator, param_shapes  # noqa: F401\n\n\n'
           'def instruction_flops(m, lang):\n    return 1000 * lang\n\n\n'
           'def step_flops(m, lang, gmap, pano):\n'
           '    return 7 * gmap + pano\n')


def _cell(tmp_path, kind, reference=None):
    """A warmed-up tiny cell; ``reference``: the source of a module that the
    tiny configuration names, written into the tiny copy."""
    from portbench.cells import DRIVERS
    from portbench.harness import Spec

    path = tiny_benchmark(tmp_path)
    bench = os.path.join(os.path.dirname(path), "benchmark")
    if reference is not None:
        with open(os.path.join(bench, "reference", "counted.py"), "w") as f:
            f.write(reference)
        cfg_path = os.path.join(bench, "configs", "tiny.json")
        with open(cfg_path) as f:
            cfg = dict(json.load(f), reference="counted")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
    spec = Spec(path, bench)
    w = spec.workload(f"tiny.{kind}")
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    cell = DRIVERS[kind](cfg, mix, 5, "cpu", spec.reference(w["config"]))
    cell.warmup()
    return cell


def _stalled(obj, name, monkeypatch, every, seconds):
    """``obj.name`` sleeps ``seconds`` on every ``every``-th call."""
    real = getattr(type(obj), name)
    calls = []

    def slow(self, *a, **k):
        calls.append(1)
        if len(calls) % every == 0:
            time.sleep(seconds)
        return real(self, *a, **k)

    monkeypatch.setattr(type(obj), name, slow)


def test_a_stall_in_the_window_lowers_eval_steps_per_s(tmp_path,
                                                      monkeypatch):
    cell = _cell(tmp_path, "eval")
    clean = cell.window(1.0)
    _stalled(cell.program, "evaluate", monkeypatch, 1, 0.2)
    stalled = cell.window(1.0)
    per_wave = lambda w: w["window_s"] / w["units"]
    assert per_wave(stalled) > per_wave(clean) + 0.15
    assert stalled["eval_steps_per_s"] < clean["eval_steps_per_s"]
    # every wave that started in the window counts, to the end of the last
    assert stalled["window_s"] >= 1.0


@pytest.mark.parametrize("call,every", [("step", 5), ("finish", 1),
                                        ("join", 1)])
def test_a_stall_in_the_window_raises_decision_ms_p95(tmp_path, monkeypatch,
                                                     call, every):
    """A stall in the tick or in a session's restart (``finish`` of the
    ended episode, ``join`` of the next) is waited by the round's every
    decision."""
    cell = _cell(tmp_path, "serve")
    clean = cell.window(1.0)
    cell.latency_ms.clear()
    _stalled(cell.program, call, monkeypatch, every, 0.3)
    stalled = cell.window(2.0)
    assert clean["decision_ms_p95"] < 300.0 <= stalled["decision_ms_p95"]


def test_the_tail_is_over_every_decision(tmp_path):
    cell = _cell(tmp_path, "serve")
    out = cell.window(1.0)
    assert out["decisions"] == out["units"] * cell.slots
    assert len(cell.latency_ms) == out["decisions"]
    assert out["decision_ms_p95"] == pytest.approx(
        float(np.percentile(cell.latency_ms, 95)))


@pytest.mark.parametrize("kind", ("eval", "serve"))
def test_the_window_counts_flops_by_the_configurations_module(tmp_path,
                                                             kind):
    cell = _cell(tmp_path, kind, COUNTED)
    joins = getattr(cell, "joins", 0)
    out = cell.window(0.5)
    mix = cell.mix
    step = 7 * mix["max_gmap_len"] + mix["max_candidates"] + 36
    instr = 1000 * mix["instr_len"]
    if kind == "eval":
        want = out["units"] * mix["batch"] * (
            instr + mix["max_action_len"] * step)
    else:
        want = out["units"] * cell.slots * step + (cell.joins - joins) * instr
    assert out["flops"] == want
