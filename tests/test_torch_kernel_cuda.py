"""The CUDA kernels (packed and fused attention) against their plain
PyTorch versions, and the decodes that run them, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit (``nvcc``); elsewhere
they skip.  They import no JAX, so they also run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances: 2e-5 absolute in f32 (sums in another order) and 5e-2 in bf16,
as tests/test_ops.py uses for the TPU kernels.  Both kernels are also held
to their own arithmetic, the plain version on the f32 upcast of the same
inputs: out within one bf16 rounding of P and one of out
(``attention.packed_attention_error``, ``attention.fused_attention_error``),
and the fused kernel's map within 2e-5 in both dtypes.
"""

import json
import os

import numpy as np
import pytest
import torch

from vln_magic_tpu_torch.ops import attention, build

pytestmark = pytest.mark.cuda
HERE = os.path.dirname(__file__)
TOLS = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


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
def no_plain(monkeypatch):
    """A CUDA tensor must never reach the plain version."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    plain = attention.packed_attention_reference
    monkeypatch.setattr(attention, "packed_attention_reference", refuse)
    return plain


def _inputs(dev, b, h, lq, lk, hd, sprel, dtype, seed, masked_row=False):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    d = h * hd
    q, k, v = (t(b, l, d).to(dtype) for l in (lq, lk, lk))
    mask = torch.zeros((b, lk), device=dev)
    mask[:, -max(1, lk // 8):] = -1e9
    if masked_row:
        mask[b - 1] = -1e9
    return q, k, v, mask, t(b, h, lq, lk) if sprel else None


# (B, H, Lq, Lk, hd, sprel, fully masked row): main-path widths at a small
# batch, an odd batch, the ungrouped layout, RxR's 250 keys, hd 128; then
# the fragment edges of the tensor-core route: Lq 1, 15, 17, 63, 65 (64-row
# tiles, 16-row warps), Lk 1, 9, 16, 17, 255, 256 (16-key chunks, the 256
# limit), hd 16/32/128; Lk 257 takes the SIMT route in bf16 too
CASES = [(4, 2, 200, 200, 64, False, False),
         (4, 2, 128, 128, 64, True, False),
         (3, 2, 37, 45, 64, True, True),
         (4, 4, 8, 8, 16, False, False),
         (2, 3, 20, 250, 32, False, True),
         (2, 1, 5, 33, 128, True, False),
         (1, 2, 1, 1, 64, True, False),
         (2, 2, 15, 9, 32, True, False),
         (3, 4, 17, 17, 16, False, True),
         (2, 2, 63, 16, 64, True, False),
         (2, 1, 65, 255, 128, True, True),
         (1, 2, 64, 256, 64, True, False),
         (2, 2, 20, 257, 64, True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,lq,lk,hd,sprel,masked", CASES)
def test_kernel_matches_plain(cuda, no_plain, monkeypatch, dtype, b, h, lq,
                              lk, hd, sprel, masked):
    q, k, v, mask, sp = _inputs(cuda, b, h, lq, lk, hd, sprel, dtype,
                                seed=lq + lk, masked_row=masked)
    before = attention.packed_attention.launches
    tc_before = attention.packed_attention.tc_launches
    got = attention.packed_attention(q, k, v, mask, sp, num_heads=h)
    torch.cuda.synchronize()
    assert attention.packed_attention.launches == before + 1
    tensor_cores = dtype == torch.bfloat16 and lk <= attention.MAX_TC_KEYS
    assert attention.packed_attention.tc_launches == tc_before + tensor_cores
    want = no_plain(q, k, v, mask, sp, h)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOLS[dtype], err
    monkeypatch.setattr(attention, "packed_attention_reference", no_plain)
    exact_err, used = attention.packed_attention_error(
        q, k, v, mask, sp, h, got, atol=TOLS[torch.float32])
    assert used <= 1.0, (exact_err, used)


def test_kernel_rejects_an_unsupported_head_dim(cuda, no_plain):
    q, k, v, mask, _ = _inputs(cuda, 2, 2, 4, 4, 12, False, torch.float32, 0)
    with pytest.raises(ValueError, match="head dim"):
        attention.packed_attention(q, k, v, mask, None, num_heads=2)


def _fused_inputs(dev, b, h, lq, lk, hd, full_bias, dtype, seed,
                  masked_row=False):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    q, k, v = (t(b, h, l, hd).to(dtype) for l in (lq, lk, lk))
    bias = t(b, h, lq, lk) if full_bias else t(b, 1, 1, lk)
    bias[..., -max(1, lk // 8):] = -1e9
    if masked_row:
        bias[b - 1] = -1e9
    return q, k, v, bias


# (B, H, Lq, Lk, hd, full bias, fully masked row): MAGIC-S and teacher head
# layouts at a small batch, an odd batch, hd 16/32/128, RxR's 250 keys; then
# the edges of the tensor-core route: every key bucket (Lk 1, 17, 32, 33,
# 200, 208, 209, 255, 256 around the 2/4/8/13/16-chunk buckets), Lq 1, 15,
# 17, 65 (16-row blocks), H 1, 3, 12, odd B, odd Lk (scalar bias and map);
# then grids of at least 264 32-row blocks at hd 64, which take 32-row
# blocks (Lq 33: a row tile wholly past Lq)
FUSED_CASES = [(4, 2, 128, 128, 64, True, False),
               (4, 2, 52, 200, 64, False, False),
               (2, 12, 200, 200, 64, False, False),
               (3, 2, 37, 45, 64, True, True),
               (3, 4, 8, 8, 16, False, False),
               (2, 3, 20, 250, 32, False, True),
               (2, 1, 5, 33, 128, True, False),
               (2, 2, 5, 1, 64, False, False),
               (3, 3, 17, 17, 32, True, False),
               (2, 1, 15, 32, 16, False, True),
               (1, 2, 1, 33, 64, True, False),
               (2, 2, 65, 200, 64, True, False),
               (3, 12, 17, 208, 64, False, False),
               (2, 2, 20, 209, 128, True, True),
               (2, 3, 16, 255, 32, True, False),
               (1, 2, 64, 256, 64, True, False),
               (264, 2, 20, 200, 64, True, True),
               (132, 2, 33, 45, 64, False, False),
               (132, 1, 50, 255, 64, True, False),
               (264, 3, 17, 128, 64, False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,lq,lk,hd,full_bias,masked", FUSED_CASES)
def test_fused_kernel_matches_plain(cuda, monkeypatch, dtype, b, h, lq, lk,
                                    hd, full_bias, masked):
    q, k, v, bias = _fused_inputs(cuda, b, h, lq, lk, hd, full_bias, dtype,
                                  seed=lq + lk, masked_row=masked)
    plain = attention.fused_attention_reference
    want = plain(q, k, v, bias)

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(attention, "fused_attention_reference", refuse)
    before = attention.fused_attention.launches
    tc_before = attention.fused_attention.tc_launches
    out, probs = attention.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before + 1
    # aligned inputs: bf16 takes the tensor-core route, f32 the SIMT route
    assert attention.fused_attention.tc_launches == \
        tc_before + (dtype == torch.bfloat16)
    assert out.dtype == dtype and out.shape == q.shape
    assert probs.dtype == torch.float32 and probs.shape == (b, lq, lk)
    assert torch.isfinite(out).all() and torch.isfinite(probs).all()
    err = (out.float() - want[0].float()).abs().max().item()
    assert err <= TOLS[dtype], err
    monkeypatch.setattr(attention, "fused_attention_reference", plain)
    out_err, map_err, used = attention.fused_attention_error(
        q, k, v, bias, out, probs, atol=TOLS[torch.float32])
    assert map_err <= TOLS[torch.float32], map_err
    assert used <= 1.0, (out_err, used)


def _fused_check(q, k, v, bias, monkeypatch):
    """One kernel call held to the plain version and to its own arithmetic;
    returns (out, probs, whether it took the tensor-core route)."""
    plain = attention.fused_attention_reference
    want = plain(q, k, v, bias)

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(attention, "fused_attention_reference", refuse)
    tc_before = attention.fused_attention.tc_launches
    out, probs = attention.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    tc = attention.fused_attention.tc_launches > tc_before
    monkeypatch.setattr(attention, "fused_attention_reference", plain)
    assert torch.isfinite(out).all() and torch.isfinite(probs).all()
    if q.dtype == torch.float32:
        # in bf16 the plain version rounds the scores to bf16, which the
        # kernel does not, so its distance grows with the sample count: the
        # exact limit below, far tighter, is the bf16 gate
        err = (out.float() - want[0].float()).abs().max().item()
        assert err <= TOLS[q.dtype], err
    out_err, map_err, used = attention.fused_attention_error(
        q, k, v, bias, out, probs, atol=TOLS[torch.float32])
    assert map_err <= TOLS[torch.float32], map_err
    assert used <= 1.0, (out_err, used)
    return out, probs, tc


# the bias layouts a caller may pass, each read through its strides: one row
# per batch row (staged once per block), one [Lq, Lk] plane for all, one per
# batch row, one per head (float2 reads where Lk is even), one per query row
BIAS_SHAPES = {"b11k": lambda b, h, lq, lk: (b, 1, 1, lk),
               "11qk": lambda b, h, lq, lk: (1, 1, lq, lk),
               "b1qk": lambda b, h, lq, lk: (b, 1, lq, lk),
               "bhqk": lambda b, h, lq, lk: (b, h, lq, lk),
               "bhq1": lambda b, h, lq, lk: (b, h, lq, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [3, 264])       # 16- and 32-row blocks
@pytest.mark.parametrize("lk", [200, 45])
@pytest.mark.parametrize("layout", list(BIAS_SHAPES))
def test_fused_kernel_bias_layouts(cuda, monkeypatch, layout, lk, b, dtype):
    h, lq, hd = 3, 17, 64
    rng = np.random.default_rng(lk)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    q, k, v = (t(b, h, l, hd).to(dtype) for l in (lq, lk, lk))
    bias = t(*BIAS_SHAPES[layout](b, h, lq, lk)) * 2
    if bias.shape[-1] == lk:
        bias[..., -3:] = -1e9
    _, _, tc = _fused_check(q, k, v, bias, monkeypatch)
    assert tc == (dtype == torch.bfloat16)


def test_fused_kernel_misaligned_bf16_takes_the_simt_route(cuda, monkeypatch):
    q, k, v, bias = _fused_inputs(cuda, 2, 3, 20, 200, 64, True,
                                  torch.bfloat16, 5, masked_row=True)
    flat = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)
    q_off = flat[1:1 + q.numel()].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 and not \
        attention._fused_takes_tensor_cores(q_off, k, v)
    before = attention.fused_attention.launches
    _, _, tc = _fused_check(q_off, k, v, bias, monkeypatch)
    assert not tc and attention.fused_attention.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_kernel_is_deterministic(cuda, dtype):
    """Two calls on the same inputs give the same bits: the head sum of the
    map has a fixed order and no atomics."""
    q, k, v, bias = _fused_inputs(cuda, 4, 12, 65, 200, 64, True, dtype, 6)
    first = attention.fused_attention(q, k, v, bias)
    second = attention.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    bits = lambda x: x.view(torch.int16 if x.dtype == torch.bfloat16
                            else torch.int32)
    for a, b in zip(first, second):
        assert torch.equal(bits(a), bits(b))


def test_fused_tc_smem_mirror_matches_the_kernel(cuda):
    """``fused_tc_chunks`` and ``fused_tc_smem_bytes`` give what a launch
    of the tensor-core route asks for."""
    lib = build.load("fused_attention")
    for hd in attention.HEAD_DIMS:
        for lk in (1, 17, 32, 33, 64, 65, 128, 129, 200, 208, 209, 256):
            for b, lq in ((16, 200), (256, 200), (132, 33), (264, 32)):
                nch = attention.fused_tc_chunks(lk)
                want = attention.fused_tc_smem_bytes(
                    hd, nch, attention.fused_tc_row_tiles(hd, nch, b, lq))
                got = lib.vln_fused_attention_tc_smem(hd, b, lq, lk)
                assert got == want, (hd, b, lq, lk)
    assert lib.vln_fused_attention_tc_smem(64, 2, 8, 257) == -1


def test_fused_kernel_refuses_inputs_that_require_grad(cuda):
    q, k, v, bias = _fused_inputs(cuda, 2, 2, 4, 8, 32, False, torch.float32, 0)
    q.requires_grad_(True)
    before = attention.fused_attention.launches
    with pytest.raises(RuntimeError, match="grad"):
        attention.fused_attention(q, k, v, bias)
    assert attention.fused_attention.launches == before


@pytest.mark.parametrize("hd,lk", [(24, 8), (32, 257)])
def test_fused_kernel_rejects_unsupported_shapes(cuda, hd, lk):
    q, k, v, bias = _fused_inputs(cuda, 2, 2, 4, lk, hd, False,
                                  torch.float32, 0)
    with pytest.raises(ValueError):
        attention.fused_attention(q, k, v, bias)


def _golden_nav(cuda, parity=False, lanes=8):
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig,
                                            ModelConfig, TrainConfig)
    from vln_magic_tpu_torch.env import make_synthetic_world

    cfg = MagicConfig(
        model=ModelConfig(vocab_size=400, hidden_size=64,
                          num_attention_heads=2, num_l_layers=2,
                          num_pano_layers=1, num_x_layers=2,
                          image_feat_size=24, max_position_embeddings=64,
                          use_pallas_attention=True),
        env=EnvConfig(max_action_len=8, max_gmap_len=24, max_instr_len=48,
                      observed_graph_parity=parity),
        train=TrainConfig(batch_size=lanes))
    world = make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                 seed=777)
    params = dict(np.load(os.path.join(HERE, "fixtures",
                                       "golden_params_777.npz")))
    return Navigator(cfg, world, params=params, device=cuda)


def _golden_items(world, n=8):
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    return make_synthetic_instructions(world, n, np.random.default_rng(777),
                                       vocab_size=400, min_path=3,
                                       max_path=6)


@pytest.mark.parametrize("golden,parity", [("golden_decode.json", False),
                                           ("golden_decode_parity.json",
                                            True)], ids=["full", "parity"])
def test_golden_decode_with_the_kernel(cuda, golden, parity):
    """tests/test_golden.py's decodes in f32 with the kernel on."""
    nav = _golden_nav(cuda, parity)
    before = attention.packed_attention.launches
    _, preds = nav.evaluate(_golden_items(nav.world), batch_size=8)
    assert attention.packed_attention.launches > before
    with open(os.path.join(HERE, golden)) as f:
        assert [p["trajectory_idx"] for p in preds] == json.load(f)


def test_stream_equals_waves_with_the_kernel(cuda):
    """The golden model over 4 lanes and 10 items of one instruction
    length: the streamed decode equals the wave decode per episode."""
    nav = _golden_nav(cuda, lanes=4)
    items = _golden_items(nav.world, 10)
    rng = np.random.default_rng(1)
    for it in items:
        it["instr_encoding"] = rng.integers(4, 400, 40).astype(np.int32)
    _, waves = nav.evaluate(items, stream=False)
    _, streamed = nav.evaluate(items, stream=True)
    assert [p["trajectory_idx"] for p in streamed] == \
        [p["trajectory_idx"] for p in waves]
