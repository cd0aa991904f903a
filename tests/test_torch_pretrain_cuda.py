"""The port's pretraining on the card: the golden JAX pretraining step in
f32 with the teacher on the packed kernel's SIMT route, and one step of
each task with its launches counted.

These tests need an NVIDIA GPU and the CUDA toolkit (``nvcc``); elsewhere
they skip.  They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pretrain_cuda.py

The golden step is ``chip_smoke.py``'s (phase 12), imported from the
repository's root.
"""

import math
import os
import sys

import pytest
import torch

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
def chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_golden_pretraining_step_matches_jax(chip_smoke):
    """Every metric to 1e-5, the gradient norms and post-step leaves to
    1e-4 (``golden_pretrain_step`` raises past them), TF32 off; the
    teacher's objective launches the packed kernel once a layer, on the
    SIMT route."""
    from vln_magic_tpu_torch.ops.attention import packed_attention

    chip_smoke._reset_launches()
    errs = chip_smoke.golden_pretrain_step("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert max(v for k, v in errs.items()
               if not k.startswith("launches")) <= 1e-4
    assert {k: v for k, v in errs.items() if k.startswith("launches")} == {
        "launches/mlm": 1, "launches/mrc": 6, "launches/sap": 6,
        "launches/cfp": 6, "launches/og": 6}
    assert packed_attention.tc_launches == 0


def test_each_task_step_launches_the_simt_kernel_in_the_teacher(chip_smoke):
    """A step of each task at full depth (narrow widths): finite metrics,
    6 packed launches for mlm and 20 for a path task, from the teacher's
    forward (the student's training forward takes none), all SIMT; a
    validate batch of each task the same from the student."""
    import dataclasses

    import numpy as np

    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer

    cfg = chip_smoke.pretrain_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, hidden_size=32,
                                       image_feat_size=16, kd_target_size=64),
        teacher_model=dataclasses.replace(cfg.teacher_model, hidden_size=64,
                                          num_attention_heads=2,
                                          image_feat_size=16,
                                          kd_target_size=32),
        train=dataclasses.replace(cfg.train, batch_size=4))
    world = make_synthetic_world(num_scans=1, nodes_per_scan=30, feat_dim=16,
                                 seed=0)
    tr = PretrainTrainer(cfg, world, device="cuda")
    items = make_synthetic_instructions(world, 8, np.random.default_rng(0),
                                        min_path=3, max_path=6,
                                        vocab_size=cfg.model.vocab_size)
    for task in ("mlm", "mrc", "sap", "cfp", "og"):
        batch = tr._fill(task, getattr(tr.builder, f"{task}_batch")(items[:4]))
        chip_smoke._reset_launches()
        m = tr.train_step(task, batch)
        assert all(math.isfinite(v) for v in m.values()), (task, m)
        assert chip_smoke._simt_launches(
            task, chip_smoke.PRETRAIN_LAUNCHES[task])
    chip_smoke._reset_launches()
    val = tr.validate(items, batch_size=4, num_batches=1)
    assert all(math.isfinite(v) for v in val.values())
    chip_smoke._simt_launches("validate", sum(
        chip_smoke.PRETRAIN_LAUNCHES[t] for t in ("mlm", "mrc", "sap", "cfp")))
