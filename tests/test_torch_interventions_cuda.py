"""The interventions and the branch-fused trunk on the card: the intervention
fixture (tests/fixtures/golden_interventions_5.npz, JAX's weights of a
small MAGIC-S with all five heads and its dictionaries) in f32, its fused
logits within 1e-5 of JAX's and its decode's actions equal; a fused-branch
decode of tests/fixtures/golden_params_777.npz in f32 (the packed kernel's
SIMT route) giving tests/golden_decode.json; and every ``packed_attention``
call of a bf16 fused-branch decode (both branches at batch 2B) held to the
plain version on the same tensors, on the tensor-core route.

These tests need an NVIDIA GPU; elsewhere they skip.  They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_interventions_cuda.py

The checks are ``chip_smoke.py``'s (phase 14), imported from the
repository's root.
"""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_golden_interventions_on_the_card(chip_smoke):
    got = chip_smoke.golden_interventions("cuda")
    assert got["actions_equal"] and got["max_abs_err"] < chip_smoke.F32_TOL
    # f32: the kernel ran, on the SIMT route
    assert got["kernel_launches"] > 0 and got["tc_launches"] == 0


def test_fused_branch_golden_decode_on_the_card(chip_smoke):
    got = chip_smoke.golden_fused_decode("cuda")
    assert got["match"] and got["tc_launches"] == 0
    # 2 language launches, then 1 panorama + 2 layers x (cross + self) a step
    assert got["kernel_launches"] == 2 + 8 * (1 + 2 * 2)


def test_bf16_fused_branch_packed_calls_match_the_plain_version(chip_smoke):
    rows = chip_smoke.fused_branch_kernel_check(batch=8, t_steps=3)
    assert rows and all(r["max_abs_err"] <= chip_smoke.BF16_TOL
                        and r["exact_limit_used"] <= 1.0 for r in rows)
    # both branches at batch 2B: the cross and the sprel self-attention
    assert {(r["B"], r["sprel"]) for r in rows} >= {(16, False), (16, True)}
