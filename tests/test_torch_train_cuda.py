"""The port's training on the card: the golden JAX training step in f32,
one full-width bf16 MAKD + ICoD DAgger step, and the packed kernel's
wrapper refusing inputs that require grad (it has no backward).

These tests need an NVIDIA GPU and the CUDA toolkit (``nvcc``); elsewhere
they skip.  They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

The golden step and the full-width configuration are ``chip_smoke.py``'s
(phases 9 and 8), imported from the repository's root.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from vln_magic_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def chip_smoke(cuda):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_golden_training_step_matches_jax(chip_smoke):
    """The objective to 1e-5, the gradient norms and leaves to 1e-4
    (``chip_smoke.golden_train_step`` raises past them), TF32 off."""
    errs = chip_smoke.golden_train_step("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert errs["loss_rel"] <= 1e-5
    assert max(errs.values()) <= 1e-4


def test_full_width_bf16_step_has_finite_losses(chip_smoke, cuda):
    from vln_magic_tpu_torch.agent.trainer import Trainer
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    world = make_synthetic_world(num_scans=3, nodes_per_scan=320,
                                 feat_dim=768, seed=0)
    tr = Trainer(chip_smoke.train_config(), world, device=cuda)
    rng = np.random.default_rng(0)
    items = make_synthetic_instructions(world, chip_smoke.TRAIN_BATCH, rng,
                                        min_path=4, max_path=7)
    chip_smoke._reset_launches()
    m = tr.train_step(items)
    assert all(math.isfinite(v) for v in m.values()), m
    assert m["grad_norm"] > 0 and m["il/kdl_loss"] > 0
    assert chip_smoke._launches() == {"packed_attention": 0,
                                      "fused_attention": 0}


def test_packed_attention_refuses_inputs_that_require_grad(cuda):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = t(2, 8, 128), t(2, 16, 128), t(2, 16, 128)
    mask = torch.zeros((2, 16), device=cuda)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.packed_attention(q, k, v, mask, num_heads=2)
    with torch.no_grad():       # evaluation: no graph, the kernel runs
        out = attention.packed_attention(q, k, v, mask, num_heads=2)
    assert out.shape == q.shape and torch.isfinite(out).all()
