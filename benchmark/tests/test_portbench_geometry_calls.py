"""The reader of ``serve.geometry_calls_per_round``: the ``fleet.geometry``
spans counted per round on synthetic runs, nothing read without spans or
without a span of that name (a program that folds its edges one at a
time), and a tiny cell's traced run making at most one call a round."""

from __future__ import annotations

from collections import namedtuple
from types import SimpleNamespace

import pytest
import torch
from portbench_testkit import run_tiny, tiny_benchmark

from portbench.harness import Spec

NAME = "serve.geometry_calls_per_round"
Span = namedtuple("Span", "name start_ns end_ns")


def synthetic(spans, units):
    run = SimpleNamespace(mix={"kind": "serve"},
                          profile={"kernels": [], "units": units})
    run.program_spans = None if spans is None else [
        Span(name, s, e) for name, s, e in spans]
    return run


def read(run):
    return Spec().reader(NAME)(run)


@pytest.mark.parametrize("spans, units, want", [
    # one batched call in each of two ticks
    ([("fleet.step", 0, 30), ("fleet.ingest", 1, 10),
      ("fleet.geometry", 2, 5), ("fleet.step", 30, 60),
      ("fleet.ingest", 31, 40), ("fleet.geometry", 32, 36)], 2, 1.0),
    # a tick with no edge to fold makes none
    ([("fleet.step", 0, 30), ("fleet.ingest", 1, 10),
      ("fleet.geometry", 2, 5), ("fleet.step", 30, 60),
      ("fleet.ingest", 31, 40)], 2, 0.5),
])
def test_the_calls_are_counted_per_round(spans, units, want):
    assert read(synthetic(spans, units)) == pytest.approx(want)


@pytest.mark.parametrize("spans", [
    None, [("fleet.step", 0, 30), ("fleet.ingest", 1, 10)]],
    ids=["no spans", "no geometry span"])
def test_nothing_to_read_without_a_geometry_span(spans):
    assert read(synthetic(spans, 2)) is None


def test_a_traced_tiny_serve_run_makes_at_most_one_call_a_round(tmp_path):
    torch.set_num_threads(1)
    out = run_tiny(tiny_benchmark(tmp_path), "tiny.serve", trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"][NAME]
    assert got["unit"] == "calls"
    assert 0 < got["value"] <= 1.0
