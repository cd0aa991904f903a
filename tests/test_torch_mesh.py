"""The port's mesh (vln_magic_tpu_torch.parallel) held against the port's
one process, in gloo process groups on the CPU: two sgd steps at dp 2 and
at mp 2 (losses and both models' parameters, ICoD, default dropout on),
``compute_grads`` under adamw at dp 2 x mp 2 (four processes) and at mp 2
with heads that do not divide, a dp 2 evaluation, three
``PretrainTrainer.fit`` steps at dp 2 and at mp 2, the indivisible batch,
``check_params_in_sync``, and a ``.pt`` saved at mp 2 restored into one
process.  The tolerances are tests/test_multichip.py's (f32
reduction-order slack).  The one process is held against JAX by the other
test files, so nothing here runs JAX.

Each group of ranks runs ``tests/torch_mesh_worker.py`` once and writes
its results; the one-process references run here."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(case: str, world: int, out_dir, device="cpu") -> list[dict]:
    """``world`` worker processes of ``case`` on ``device``; their results
    by rank."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r),
                               str(world), port, str(out_dir), device],
                              env=env)
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * world, f"{case}: exit codes {rcs}"
    return [torch.load(os.path.join(out_dir, f"{case}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def dp2(out_dir):
    return run_group("dp2", 2, out_dir)


@pytest.fixture(scope="module")
def mp2(out_dir):
    return run_group("mp2", 2, out_dir)


@pytest.fixture(scope="module")
def single_steps():
    _, metrics, params, t_params = W.train_steps(None)
    return metrics, params, t_params


def _assert_close(a: dict, b: dict, rtol=2e-4, atol=2e-6):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k].float().numpy(), b[k].float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", ["dp2", "mp2"])
def test_two_steps_match_one_process(case, request, single_steps):
    """Two MAKD + ICoD sgd steps with dropout on, at dp 2 and at mp 2
    (Megatron splits, 1 head a rank), equal one process's on the same
    global batch: per-step losses on every rank, both models' params."""
    ranks = request.getfixturevalue(case)
    ref_metrics, ref_params, ref_t = single_steps
    for out in ranks:
        for m_ref, m in zip(ref_metrics, out["metrics"]):
            assert m["loss"] == pytest.approx(m_ref["loss"], rel=1e-4)
            assert m["grad_norm"] == pytest.approx(m_ref["grad_norm"],
                                                   rel=1e-3)
            assert sorted(m) == sorted(m_ref)
    _assert_close(ranks[0]["params"], ref_params)
    _assert_close(ranks[0]["t_params"], ref_t)


def test_mp2_splits_and_stays_in_sync(mp2, single_steps):
    """At mp 2 the column/row/vocab leaves hold half their rows or
    columns on each rank (the test is not vacuous), and every rank's
    whole model is the same."""
    shapes = mp2[0]["shapes"]
    full = {k: tuple(v.shape) for k, v in single_steps[1].items()}
    halved = [k for k in shapes if shapes[k] != full[k]]
    assert "lang_encoder.word_embeddings.weight" in halved
    assert "lang_encoder.layer_0.attention.query.weight" in halved
    assert "lang_encoder.layer_0.ffn.output.weight" in halved
    assert all(int(np.prod(shapes[k])) * 2 == int(np.prod(full[k]))
               for k in halved)
    assert all(out["in_sync"] for out in mp2)


def test_dp2_mp2_adamw_grads_match_one_process(out_dir):
    """``compute_grads`` under adamw at dp 2 x mp 2 (four processes):
    the objective and both partitions' gradients, whole leaves."""
    loss_ref, grads_ref = W.adamw_grads(None)
    ranks = run_group("dp2mp2", 4, out_dir)
    for out in ranks:
        assert out["loss"] == pytest.approx(loss_ref, rel=1e-4)
    assert sorted(ranks[0]["grads"]) == ["params", "t_params"]
    for part in ("params", "t_params"):
        _assert_close(ranks[0]["grads"][part], grads_ref[part],
                      rtol=5e-4, atol=1e-4)
        _assert_close(ranks[3]["grads"][part], ranks[0]["grads"][part],
                      rtol=0, atol=0)


def test_dp2_eval_matches_one_process(dp2):
    """A dp 2 greedy decode: identical trajectories and metrics within
    1e-5 on every rank."""
    avg_ref, traj_ref = W.evaluate(None)
    for out in dp2:
        assert out["traj"] == traj_ref
        for k, v in avg_ref.items():
            assert out["avg"][k] == pytest.approx(v, rel=1e-5), k


@pytest.fixture(scope="module")
def single_pretrain():
    return W.pretrain_fit(None)


@pytest.mark.parametrize("case", ["dp2", "mp2"])
def test_pretrain_fit_matches_one_process(case, request, single_pretrain):
    """Three ``PretrainTrainer.fit`` steps (mlm, sap) at dp 2 and at mp 2
    (the tied MLM decoder over a vocab-parallel embedding): the same
    tasks, losses within 2e-4, the student's params."""
    hist_ref, params_ref = single_pretrain
    ranks = request.getfixturevalue(case)
    for out in ranks:
        assert [h["task"] for h in out["hist"]] == \
            [h["task"] for h in hist_ref]
        for h_ref, h in zip(hist_ref, out["hist"]):
            assert h["loss"] == pytest.approx(h_ref["loss"], rel=2e-4)
    _assert_close(ranks[0]["pt_params"], params_ref)


def test_mp2_heads_indivisible_match_one_process(mp2):
    """Three heads at mp 2 (hidden 48): Q/K/V split by column and gathered
    whole, the row-parallel ``out`` fed its slice; ``compute_grads``
    equals one process's."""
    loss_ref, grads_ref = W.adamw_grads(None, heads=3)
    for out in mp2:
        assert out["odd_loss"] == pytest.approx(loss_ref, rel=1e-4)
    for part in ("params", "t_params"):
        _assert_close(mp2[0]["odd_grads"][part], grads_ref[part],
                      rtol=5e-4, atol=1e-4)


def test_indivisible_batch_raises(mp2):
    """``use_mesh`` of the trainer, the navigator and the pretrainer on a
    global batch of 7 at dp 2 raises ``ValueError`` ("divisible")."""
    for out in mp2:
        assert len(out["indivisible"]) == 3
        assert all("divisible" in e for e in out["indivisible"])


def test_check_params_in_sync(dp2):
    """Equal after dp 2 steps on every rank; one rank's drift is seen by
    all."""
    assert [out["in_sync"] for out in dp2] == [True, True]
    assert [out["drifted_in_sync"] for out in dp2] == [False, False]


def test_mp2_checkpoint_restores_into_one_process(mp2, out_dir):
    """The student saved at mp 2 (``Trainer.save``, whole leaves written
    by rank 0) loads into one process with every leaf, and decodes as the
    mp 2 mesh decoded it."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.utils.checkpoint import \
        restore_reference_checkpoint

    cfg, world, items = W.setup()
    nav = Navigator(cfg, world, seed=3, device="cpu")
    _, missing, unexpected = restore_reference_checkpoint(
        nav.model, os.path.join(out_dir, "mp2_student.pt"))
    assert missing == [] and unexpected == []
    _assert_close({k: v.detach() for k, v in nav.model.state_dict().items()},
                  mp2[0]["params"], rtol=0, atol=0)
    (avg, _), preds = nav.evaluate(items)
    assert [p["trajectory"] for p in preds] == mp2[0]["traj"]
    for k, v in avg.items():
        assert mp2[0]["avg"][k] == pytest.approx(v, rel=1e-5), k
