"""The A2C step of the port (``train_alg`` other than imitation or dagger:
a teacher-forced rollout at ``ml_weight`` with frozen-teacher
distillation, then a sampled rollout that trains the policy and the critic
on discounted distance-progress returns) held against vln_magic_tpu's
through one JAX ``compute_grads``: the objective to 1e-5 relative, the
student's and the critic's partition norms and leaves to 1e-4.  Both
packages' ``select_action`` take ``sample`` as ``argmax`` for the run
(``chip_smoke._SampleAsArgmax``), so their draws agree.
"""

import numpy as np
import pytest
import torch

import jax

from chip_smoke import GOLDEN_OPTIONS_SPEC as SPEC, _SampleAsArgmax
from test_torch_train_options import (check_against, check_fixture,
                                      jax_options_trainer,
                                      port_options_trainer, run_arrays)
from vln_magic_tpu.agent import rollout as jax_rollout
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch.agent import rollout as port_rollout


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_a2c_run(run="a2c"):
    """JAX's ``compute_grads`` of the A2C run (or ``run``, another A2C run
    of the spec): (objective, grads of the student and the critic)."""
    tr, items = jax_options_trainer(run)
    with _SampleAsArgmax(jax_rollout.Rollout):
        loss, (grads, c_grads) = tr.compute_grads(
            items, jax.random.PRNGKey(SPEC["seed"]))
    return float(loss), {"params": flatten_params(grads),
                         "critic_params": flatten_params(c_grads)}


@pytest.fixture(scope="module")
def jax_a2c():
    loss, grads = jax_a2c_run()
    return {"loss": loss, "grads": grads,
            "arrays": run_arrays("a2c", loss, grads)}


def test_a2c_fixture_is_a_fresh_jax_run(jax_a2c):
    check_fixture(jax_a2c["arrays"])


def test_a2c_compute_grads_matches_jax(jax_a2c):
    tr, items = port_options_trainer("a2c")
    with _SampleAsArgmax(port_rollout.Rollout):
        loss, grads = tr.compute_grads(items, seed=SPEC["seed"])
    assert sorted(grads) == ["critic_params", "params"]
    check_against(loss, grads, jax_a2c["loss"], jax_a2c["grads"])


def test_a2c_step_trains_the_policy_and_the_critic():
    """One ``train_step`` with sampled draws: JAX's metric names, finite
    values, the student and the critic moved and the frozen teacher not."""
    tr, items = port_options_trainer("a2c")
    before = {name: [p.detach().clone() for p in m.parameters()]
              for name, m in (("model", tr.model), ("critic", tr.critic),
                              ("teacher", tr.teacher_model))}
    m = tr.train_step(items)
    assert sorted(m) == ["grad_norm", "il/gmap_overflow", "il/kdl_loss",
                         "il/ml_loss", "loss", "rl/loss"]
    assert all(np.isfinite(v) for v in m.values()) and m["grad_norm"] > 0
    moved = {name: any(not torch.equal(a, p) for a, p in zip(
        ps, getattr(tr, name if name != "teacher" else "teacher_model")
        .parameters())) for name, ps in before.items()}
    assert moved == {"model": True, "critic": True, "teacher": False}
