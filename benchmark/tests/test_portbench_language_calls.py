"""The reader of ``serve.language_calls_per_round``: the ``fleet.language``
spans counted per round on synthetic runs, whether a round encodes in each
join or once in its tick, nothing read without spans, and a tiny cell's
traced run encoding at most once a round."""

from __future__ import annotations

from collections import namedtuple
from types import SimpleNamespace

import pytest
import torch
from portbench_testkit import run_tiny, tiny_benchmark

from portbench.harness import Spec

NAME = "serve.language_calls_per_round"
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
    # one encoding in each of three joins, over two rounds
    ([("fleet.join", 0, 9), ("fleet.language", 1, 8),
      ("fleet.join", 9, 19), ("fleet.language", 10, 18),
      ("fleet.step", 19, 40), ("fleet.decide", 20, 30),
      ("fleet.join", 40, 50), ("fleet.language", 41, 49),
      ("fleet.step", 50, 70)], 2, 1.5),
    # the joins encode nothing; one round's tick encodes them, the
    # other's has nothing pending
    ([("fleet.join", 0, 2), ("fleet.join", 2, 4), ("fleet.step", 4, 30),
      ("fleet.language", 6, 12), ("fleet.decide", 12, 28),
      ("fleet.step", 30, 50), ("fleet.decide", 32, 48)], 2, 0.5),
    ([("fleet.step", 0, 10), ("fleet.decide", 1, 9)], 1, 0.0),
])
def test_the_encodings_are_counted_per_round(spans, units, want):
    assert read(synthetic(spans, units)) == pytest.approx(want)


def test_nothing_to_read_without_spans():
    assert read(synthetic(None, 2)) is None


def test_a_traced_tiny_serve_run_encodes_at_most_once_a_round(tmp_path):
    torch.set_num_threads(1)
    out = run_tiny(tiny_benchmark(tmp_path), "tiny.serve", trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"][NAME]
    assert got["unit"] == "calls"
    assert 0 <= got["value"] <= 1.0
