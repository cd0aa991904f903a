"""The ``grad`` ability weights of the port: ``Trainer.update_ability_grads``
(one teacher-forced, deterministic KD backward per ability on the einsum
attention path, EMA 0.5) held against vln_magic_tpu's on the fused run's
trainer (the five norms to 1e-4 relative), the EMA, and the norms in the
train state.  The rollout's use of them (``grad_softmax_weights``) is held
to JAX in ``test_torch_train_options.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_train_options import (check_fixture, jax_options_trainer,
                                      port_options_trainer)
from vln_magic_tpu_torch.agent.trainer import ABILITY_EMA
from vln_magic_tpu_torch.models import layers as port_layers


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_ability_norms():
    """JAX's ``update_ability_grads`` from zeros: 0.5 x the five norms."""
    tr, items = jax_options_trainer("fused")
    return np.asarray(tr.update_ability_grads(items), np.float32)


def ability_arrays() -> dict:
    return {"ability_grads": jax_ability_norms()}


@pytest.fixture(scope="module")
def jax_norms():
    return jax_ability_norms()


def test_ability_fixture_is_a_fresh_jax_run(jax_norms):
    check_fixture({"ability_grads": jax_norms})


def test_update_ability_grads_matches_jax(jax_norms, monkeypatch):
    """The norms, on the einsum path (no ``packed_attention`` call even
    with the packed kernel switched on), and the EMA of a second call."""
    tr, items = port_options_trainer("fused",
                                     {"use_pallas_attention": True})
    calls = []
    monkeypatch.setattr(port_layers, "packed_attention",
                        lambda *a, **k: calls.append(1))
    first = tr.update_ability_grads(items)
    assert not calls
    np.testing.assert_allclose(first, jax_norms, rtol=1e-4)
    second = tr.update_ability_grads(items)
    # first = (1 - ema) x norms, so second = ema x first + norms x (1 - ema)
    np.testing.assert_allclose(second, (1 + ABILITY_EMA) * first, rtol=1e-6)
    assert second.dtype == np.float32


def test_train_state_carries_the_ability_grads(tmp_path):
    """``save_state``/``load_state`` keep the norms and the critic's
    optimizer state."""
    tr, items = port_options_trainer("fused")
    tr.ability_grads = np.asarray([1, 2, 3, 4, 5], np.float32)
    tr.c_opt.count = 3
    tr.save_state(str(tmp_path))
    fresh, _ = port_options_trainer("fused")
    assert fresh.load_state(str(tmp_path))
    np.testing.assert_array_equal(fresh.ability_grads, tr.ability_grads)
    assert fresh.c_opt.count == 3
