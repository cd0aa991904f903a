"""The port's training on the card: the golden JAX training step in f32,
one full-width bf16 MAKD + ICoD DAgger step, a deterministic distillation
rollout with a packed student, and the packed kernel's wrapper refusing
inputs that require grad (it has no backward).

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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _deterministic_distillation(device):
    """A deterministic distillation rollout with a packed student (tiny
    shapes, random weights from seeds) on ``device``: its aux."""
    from vln_magic_tpu_torch.agent.navigator import (episodes_from_items,
                                                     pad_instructions)
    from vln_magic_tpu_torch.agent.rollout import Rollout, Tables
    from vln_magic_tpu_torch.config import (DistillConfig, EnvConfig,
                                            ModelConfig)
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
    from vln_magic_tpu_torch.utils.weights import init_params

    world = make_synthetic_world(num_scans=1, nodes_per_scan=14, feat_dim=16,
                                 seed=9)
    items = make_synthetic_instructions(world, 4, np.random.default_rng(2),
                                        vocab_size=300, min_path=2,
                                        max_path=4)
    models = []
    for seed, hidden, kd, packed in ((1, 32, 64, True), (2, 64, 32, False)):
        m = DualScaleVLNBert(ModelConfig(
            vocab_size=300, hidden_size=hidden, num_attention_heads=2,
            num_l_layers=1, num_pano_layers=1, num_x_layers=1,
            image_feat_size=16, max_position_embeddings=64, kd_heads=True,
            kd_target_size=kd, hidden_dropout=0.0, attention_dropout=0.0,
            use_pallas_attention=packed), device=device)
        init_params(m, seed)
        models.append(m)
    tables = Tables.from_world(world.tables, device)
    ro = Rollout(tables, EnvConfig(max_action_len=5, max_gmap_len=16,
                                   max_instr_len=32), *models)
    state = episodes_from_items(tables, items, 32, teacher_size=64)
    ids, masks = pad_instructions(items, 32)
    return ro.run(state, torch.from_numpy(ids).to(device),
                  torch.from_numpy(masks).to(device), "teacher",
                  train_ml=1.0, deterministic=True,
                  distill=DistillConfig(train_kdl=True))


def test_deterministic_distillation_with_a_packed_student_runs(cuda):
    """A packed student's deterministic distillation rollout used to raise
    on the card (the packed kernel has no backward).  Its training
    forwards now keep attention off the kernel: no launch, the losses
    equal the CPU run's to 1e-4 relative (TF32 off) and the backward
    runs."""
    attention.packed_attention.launches = 0
    got = _deterministic_distillation(cuda)
    assert attention.packed_attention.launches == 0
    want = _deterministic_distillation("cpu")
    for k, v in want["kd_losses"].items():
        g = got["kd_losses"][k].item()
        w = v.item()
        assert math.isfinite(g) and abs(g - w) <= 1e-4 * abs(w) + 1e-7, k
    assert got["kd_losses"]["txt_attn_loss"].item() > 0
    (got["ml_loss"] + sum(got["kd_losses"].values())).backward()


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
