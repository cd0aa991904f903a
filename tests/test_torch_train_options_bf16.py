"""bf16 weight-gradient sums (``grads_dtype="bfloat16"``) in the port held
against vln_magic_tpu's on the options spec's ``a2c_bf16`` run: the A2C
step with a frozen distilling teacher and the learned ability weights, in
f32 compute.  JAX casts the student's and the teacher's parameters to bf16
for the step and takes the ability weights' softplus in bf16; the port
swaps bf16 copies of both models' masters in (``Trainer._bf16_weights``)
and rounds the softplus as XLA does.  The objective is held to 1e-6
relative; the gradients to 1e-2 relative L2, since the bf16 sums of the
two packages run in different orders.  Both packages take ``sample`` as
``argmax`` (``chip_smoke._SampleAsArgmax``).
"""

import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN_OPTIONS_SPEC as SPEC, _SampleAsArgmax
from test_torch_train_options import check_fixture, port_options_trainer
from test_torch_train_options_rl import jax_a2c_run
from vln_magic_tpu_torch.agent import rollout as port_rollout

RUN = "a2c_bf16"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_bf16():
    from test_torch_train_options import run_arrays

    loss, grads = jax_a2c_run(RUN)
    return {"loss": loss, "grads": grads,
            "arrays": run_arrays(RUN, loss, grads)}


def rel_l2(got: dict, want: dict) -> float:
    """Relative L2 distance of two flat gradient dicts over all leaves."""
    assert sorted(got) == sorted(want)
    num = sum(float(np.sum(np.square(np.asarray(got[k], np.float64)
                                     - np.asarray(want[k], np.float64))))
              for k in want)
    den = sum(float(np.sum(np.square(np.asarray(want[k], np.float64))))
              for k in want)
    return float(np.sqrt(num / den))


def test_a2c_bf16_fixture_is_a_fresh_jax_run(jax_bf16):
    check_fixture(jax_bf16["arrays"])


def test_bf16_grads_compute_grads_matches_jax(jax_bf16):
    tr, items = port_options_trainer(RUN)
    assert tr.cfg.train.grads_dtype == "bfloat16"
    assert not tr.icod and tr.teacher_model is not None
    with _SampleAsArgmax(port_rollout.Rollout):
        loss, grads = tr.compute_grads(items, seed=SPEC["seed"])
    assert sorted(grads) == ["critic_params", "params"]
    np.testing.assert_allclose(float(loss), jax_bf16["loss"], rtol=1e-6)
    for part in ("params", "critic_params"):
        got = {k: v.numpy() for k, v in grads[part].items()}
        assert rel_l2(got, jax_bf16["grads"][part]) < 1e-2, part
    # the masters are back, f32, and the frozen teacher took no gradient
    for m in (tr.model, tr.teacher_model):
        assert not m.bf16_weights
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert all(p.grad is None for p in tr.teacher_model.parameters())


def test_bf16_softplus_is_jax_bf16_softplus():
    """The ability weights' softplus on bf16 copies, against
    ``jax.nn.softplus`` of the bf16 values: equal bit for bit."""
    import jax.numpy as jnp
    from jax import nn as jnn

    from vln_magic_tpu_torch.models.vlnbert import _bf16_softplus

    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 4
    want = np.asarray(jnn.softplus(jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    np.testing.assert_array_equal(_bf16_softplus(torch.from_numpy(x))
                                  .numpy(), want)
