"""Reading a profiled stretch: busy time and idle share from intervals, the
longest idle gaps named by the host's span and op, the frozen roofline
bound against ``chip_smoke.py``'s, and the per-layer readers."""

from __future__ import annotations

import types

import pytest
import torch
from portbench_testkit import ROOT

from portbench import trace


def _reader(name):
    """The reader the harness finds for the metric ``name``."""
    from portbench.harness import Spec

    return Spec().reader(name)


def test_busy_time_is_the_union_of_intervals():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.busy_us([]) == 0


def test_idle_share_against_the_unprofiled_wall():
    run = types.SimpleNamespace(
        profile={"busy_s": 0.5, "units": 2},
        window={"unit_wall_s": 1.0})
    assert _reader("device.idle.eval")(run) == pytest.approx(75.0)
    assert _reader("device.idle.serve")(run) == pytest.approx(75.0)


def test_idle_gaps_are_named_by_span_and_innermost_op():
    dev = [("k1", 0.0, 10.0), ("k2", 12.0, 20.0), ("k3", 60.0, 61.0)]
    host = [("portbench.eval.wave", -5.0, 70.0), ("aten::nonzero", 15.0, 65.0),
            ("cudaStreamSynchronize", 18.0, 64.0), ("aten::add", 0.0, 1.0)]
    gaps = trace._idle_gaps(dev, host, top=10)
    assert gaps[0] == ["portbench.eval.wave / cudaStreamSynchronize",
                       pytest.approx(40e-6)]
    assert gaps[1][1] == pytest.approx(2e-6)
    assert len(gaps) == 2


def test_bound_is_chip_smokes_at_the_path_shapes():
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    for _, lq, lk, sprel, _ in chip_smoke.PATH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = (256, 2, lq, lk, 64, dtype, sprel)
            assert trace.bound(*args) == chip_smoke.bound(*args)


def test_roofline_reader_reads_the_recorded_calls():
    calls = [(256, 2, 128, 200, 64, torch.bfloat16, False)] * 3
    need_ms = 3 * trace.bound(*calls[0])[0]
    run = types.SimpleNamespace(
        profile={"kernels": [("packed_attention_tc_kernel<64, 13>", 0.0,
                              need_ms * 1e3 * 2), ("gemm", 0.0, 5.0)]},
        packed_calls=calls)
    assert _reader("packed_attention_roofline.eval")(run) == pytest.approx(
        50.0)
    run.packed_calls = []
    assert _reader("packed_attention_roofline.serve")(run) is None


def test_mfu_reader():
    run = types.SimpleNamespace(window={"flops": 989e12, "window_s": 10.0})
    assert _reader("mfu.eval")(run) == pytest.approx(10.0)
    assert _reader("mfu.serve")(run) == pytest.approx(10.0)


def test_every_per_layer_metric_finds_its_reader():
    from portbench.harness import Spec

    spec = Spec()
    for m in spec.data["per_layer"]:
        assert callable(spec.reader(m["name"])), m["name"]
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_family.eval")
