"""The port's mesh, long-context models and utilities on the card: one
process over NCCL at world size 1 (a train step and a decode equal to the
same trainer and navigator without a mesh), two gloo ranks on the one card
at dp 2 and at mp 2 (two sgd steps equal to one process on the card, the
tests/test_multichip.py tolerances), the golden long-context fixture
(``chip_smoke.golden_long_context``, JAX's values) in f32, and a profiler
trace that names the packed kernel.

These tests need an NVIDIA GPU; elsewhere they skip.  They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.join(ROOT, "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)
import torch_mesh_worker as W  # noqa: E402
from test_torch_mesh import _assert_close, _free_port  # noqa: E402


@pytest.fixture(autouse=True)
def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def on_card(monkeypatch):
    monkeypatch.setattr(W, "DEVICE", "cuda")


def test_world1_nccl_mesh_equals_no_mesh(on_card, monkeypatch):
    """``make_mesh`` over NCCL at world size 1: a train step's loss and
    parameters and a decode equal the same without a mesh."""
    import torch.distributed as dist

    from vln_magic_tpu_torch import parallel

    ref = W.train_steps(None, n_steps=1)
    ref_eval = W.evaluate(None)
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    parallel.init_distributed("cuda")
    try:
        mesh = parallel.make_mesh(mp=1)
        assert (mesh.backend, dist.get_backend()) == ("nccl", "nccl")
        _, metrics, params, t_params = W.train_steps(mesh, n_steps=1)
        avg, traj = W.evaluate(mesh)
    finally:
        dist.destroy_process_group()
    # the same computation; the card's atomics may order its sums apart
    for m_ref, m in zip(ref[1], metrics):
        assert m["loss"] == pytest.approx(m_ref["loss"], rel=1e-4)
    _assert_close({k: v.cpu() for k, v in params.items()},
                  {k: v.cpu() for k, v in ref[2].items()})
    assert traj == ref_eval[1]
    for k, v in ref_eval[0].items():
        assert avg[k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("case", ["dp2", "mp2"])
def test_two_gloo_ranks_on_one_card(case, tmp_path, on_card):
    """Two ranks on the one card over gloo (CUDA tensors): two sgd steps
    at dp 2 and at mp 2 equal one process on the card."""
    from test_torch_mesh import run_group

    _, ref_metrics, ref_params, ref_t = W.train_steps(None)
    ranks = run_group(case, 2, tmp_path, device="cuda")
    for out in ranks:
        for m_ref, m in zip(ref_metrics, out["metrics"]):
            assert m["loss"] == pytest.approx(m_ref["loss"], rel=1e-4)
    host = lambda d: {k: v.cpu() for k, v in d.items()}
    _assert_close(ranks[0]["params"], host(ref_params))
    _assert_close(ranks[0]["t_params"], host(ref_t))


def test_golden_long_context_on_card():
    import chip_smoke as cs

    errs = cs.golden_long_context("cuda")
    assert max(errs.values()) <= cs.LONG_CONTEXT_TOL


def test_trace_names_the_packed_kernel(tmp_path):
    from vln_magic_tpu_torch.ops.attention import packed_attention
    from vln_magic_tpu_torch.utils.profiling import (StepTimer,
                                                     device_memory_stats,
                                                     trace)

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 16, 128, generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    mask = torch.zeros(4, 16, device="cuda")
    packed_attention(q, k, v, mask, num_heads=2)        # build, warm
    timer = StepTimer(warmup=0)
    with trace(str(tmp_path)), timer:
        packed_attention(q, k, v, mask, num_heads=2)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("packed_attention" in e.get("name", "")
               for e in events if e.get("cat") == "kernel")
    assert timer.mean > 0
    stats = device_memory_stats()["cuda:0"]
    assert stats["bytes_limit"] > stats["peak_bytes_in_use"] > 0
