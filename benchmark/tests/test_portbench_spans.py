"""The readers of the program's spans (``portbench.spans`` and the
metrics that use it) on synthetic spans and kernels, an idle gap that an
issue-only span covers only in part among them; the spans taken once a
run; and each tiny cell's traced run reading all of them."""

from __future__ import annotations

from collections import namedtuple
from types import SimpleNamespace

import pytest
import torch
from portbench_testkit import run_tiny, tiny_benchmark

from portbench.harness import Spec
from portbench.spans import idle_inside, recorded
from vln_magic_tpu_torch.utils import profiling

METRICS = {"eval": ("eval.issue_ms_per_step", "eval.tail_ms_per_wave",
                    "device.issue_idle_ms.eval"),
           "serve": ("serve.ingest_ms_per_round",
                     "serve.restart_ms_per_round",
                     "device.issue_idle_ms.serve")}
# what the readers read of a span
Span = namedtuple("Span", "name start_ns end_ns")
# kernels (us): busy [0, 4], [6, 8], [20, 35], [50, 60]; idle (4, 6),
# (8, 20), (35, 50)
KERNELS = [("k", 0.0, 4.0), ("k", 6.0, 8.0), ("k", 20.0, 30.0),
           ("k", 29.0, 35.0), ("k", 50.0, 60.0)]


def synthetic(kind, spans, units=2):
    """A run whose profiled stretch held ``KERNELS`` and ``spans`` (name,
    start us, end us)."""
    run = SimpleNamespace(
        mix={"kind": kind, "max_action_len": 3},
        profile={"kernels": KERNELS, "units": units})
    run.program_spans = [Span(name, int(s * 1e3), int(e * 1e3))
                         for name, s, e in spans]
    return run


def read(name, run):
    return Spec().reader(name)(run)


def test_idle_inside_counts_only_the_covered_part_of_each_gap():
    assert idle_inside(KERNELS, []) == 0.0
    assert idle_inside(KERNELS, [(0.0, 60.0)]) == 2 + 12 + 15
    # one span across a gap's end, one inside a busy stretch, one across
    # a gap's start, and two that overlap each other
    assert idle_inside(KERNELS, [(2.0, 7.0), (21.0, 24.0), (40.0, 70.0),
                                 (10.0, 15.0), (12.0, 25.0)]) == 2 + 10 + 10


def test_eval_readers():
    run = synthetic("eval", [
        ("eval.wave", 0.0, 60.0), ("rollout.language", 2.0, 7.0),
        ("rollout.step", 10.0, 25.0), ("rollout.observe", 12.0, 18.0),
        ("rollout.step", 40.0, 70.0), ("eval.trajectories", 36.0, 39.0),
        ("eval.score", 60.0, 64.0)])
    # (15 + 30) us over 2 waves x 3 steps
    assert read("eval.issue_ms_per_step", run) == pytest.approx(0.0075)
    assert read("eval.tail_ms_per_wave", run) == pytest.approx(0.0035)
    # the language's 2 us of gap (4, 6), the first step's 10 of (8, 20),
    # the second's 10 of (35, 50); not the trajectories' 3 of (35, 50)
    assert read("device.issue_idle_ms.eval", run) == pytest.approx(0.011)


def test_serve_readers():
    run = synthetic("serve", [
        ("fleet.finish", 0.0, 9.0), ("fleet.walk", 1.0, 5.0),
        ("fleet.fetch", 5.0, 9.0), ("fleet.join", 9.0, 19.0),
        ("fleet.language", 10.0, 18.0), ("fleet.step", 19.0, 64.0),
        ("fleet.ingest", 19.0, 22.0), ("fleet.upload", 22.0, 23.0),
        ("fleet.decide", 23.0, 45.0), ("fleet.fetch", 45.0, 55.0),
        ("fleet.record", 55.0, 64.0)], units=1)
    assert read("serve.restart_ms_per_round", run) == pytest.approx(0.019)
    assert read("serve.ingest_ms_per_round", run) == pytest.approx(0.012)
    # the walk's 1 us of gap (4, 6), the language's 8 of (8, 20), the
    # decision's 10 of (35, 50); not the fetches' nor the ingest's
    assert read("device.issue_idle_ms.serve", run) == pytest.approx(0.019)


@pytest.mark.parametrize("kind", ("eval", "serve"))
def test_nothing_to_read_without_spans(kind):
    run = synthetic(kind, [])
    run.program_spans = None
    for name in METRICS[kind]:
        assert read(name, run) is None


def test_the_spans_are_taken_once_a_run():
    profiling.reset()
    with profiling.recording():
        with profiling.span("eval.wave"):
            pass
    first, second = SimpleNamespace(), SimpleNamespace()
    assert [s.name for s in recorded(first)] == ["eval.wave"]
    assert profiling.recorded() == []
    assert [s.name for s in recorded(first)] == ["eval.wave"]
    assert recorded(second) is None


@pytest.mark.parametrize("kind", ("eval", "serve"))
def test_a_traced_tiny_run_reads_every_span_metric(tmp_path, kind):
    torch.set_num_threads(1)
    out = run_tiny(tiny_benchmark(tmp_path), f"tiny.{kind}", trace=True)
    assert out["correct"], out["checks"]
    for name in METRICS[kind]:
        assert out["metrics"][name]["value"] >= 0, name
        assert out["metrics"][name]["unit"] == "ms"
    # every wave issues steps, every round ingests; a round may restart
    # no robot
    assert out["metrics"][METRICS[kind][0]]["value"] > 0
