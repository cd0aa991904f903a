"""The port's fused attention (vln_magic_tpu_torch.ops.fused_attention) held
against the JAX kernel in interpret mode and its XLA oracle.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the card
(tests/test_torch_kernel_cuda.py and chip_smoke.py).  Inputs come from numpy
with a fixed seed and go to both frameworks unchanged.

Tolerances: f32, 2e-5 absolute on both outputs (sums in another order).
bf16: the output within 5e-2 (rtol and atol, as tests/test_ops.py:42-44) and
the map within 1e-2 absolute: the plain version rounds the scores to bf16
while the JAX kernel keeps them in f32, which moves a probability by a few
1e-3 at these shapes.  The tighter limit that holds the CUDA kernel to the
kernel's own f32 arithmetic (``fused_attention_error``) is checked here
against the JAX kernel's bf16 result.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vln_magic_tpu.ops import fused_attention as jax_fused
from vln_magic_tpu.ops import fused_attention_reference as jax_ref
from vln_magic_tpu_torch.ops import fused_attention, fused_attention_reference
from vln_magic_tpu_torch.ops import attention
from vln_magic_tpu_torch.ops.attention import fused_attention_error

TOL = 2e-5
BF16_OUT_TOL, BF16_MAP_TOL = 5e-2, 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, h, lq, lk, hd, seed, full_bias=False, masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, hd)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, hd)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, hd)).astype(np.float32)
    shape = (b, h, lq, lk) if full_bias else (b, 1, 1, lk)
    bias = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    bias[..., -3:] = -1e9            # masked keys, as the model's padding
    if masked_row:
        bias[b - 1] = -1e9           # an ended episode: every key masked
    return q, k, v, bias


def _both(q, k, v, bias, dtype):
    """(port, JAX kernel in interpret mode, JAX oracle) as f32 numpy."""
    t = lambda x: torch.from_numpy(x).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = lambda x: jnp.asarray(x, jdt)
    out, probs = fused_attention(t(q), t(k), t(v), torch.from_numpy(bias))
    assert out.dtype == dtype and probs.dtype == torch.float32
    f = lambda x: np.asarray(x, np.float32)
    port = (out.float().numpy(), probs.numpy())
    kern = jax_fused(j(q), j(k), j(v), jnp.asarray(bias), interpret=True)
    ref = jax_ref(j(q), j(k), j(v), jnp.asarray(bias))
    return port, tuple(map(f, kern)), tuple(map(f, ref))


# the shapes of tests/test_ops.py:12-44, the MAGIC teacher's H 12 x hd 64 at
# a tiny batch, a full per-head bias, a fully masked row, hd 128
CASES = [(2, 2, 16, 16, 32, False, False),
         (1, 4, 8, 24, 16, False, False),
         (2, 12, 9, 20, 64, False, False),
         (3, 2, 7, 12, 64, True, False),
         (2, 2, 5, 11, 128, False, True)]


@pytest.mark.parametrize("b,h,lq,lk,hd,full_bias,masked_row", CASES)
def test_plain_fused_attention_matches_jax(b, h, lq, lk, hd, full_bias,
                                           masked_row):
    q, k, v, bias = _inputs(b, h, lq, lk, hd, seed=b * 100 + h * 10 + hd,
                            full_bias=full_bias, masked_row=masked_row)
    (out, probs), kern, ref = _both(q, k, v, bias, torch.float32)
    assert out.shape == (b, h, lq, hd) and probs.shape == (b, lq, lk)
    assert np.isfinite(out).all() and np.isfinite(probs).all()
    for want in (kern, ref):
        np.testing.assert_allclose(out, want[0], rtol=0, atol=TOL)
        np.testing.assert_allclose(probs, want[1], rtol=0, atol=TOL)
    live = slice(0, b - 1) if masked_row else slice(None)
    assert float(probs[live, :, -3:].max()) < 1e-6
    if masked_row:
        # -1e9 swamps every score: the row is the uniform mean of V
        np.testing.assert_allclose(out[b - 1], np.broadcast_to(
            v[b - 1].mean(1, keepdims=True), out[b - 1].shape),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,h,lq,lk,hd", [(2, 2, 16, 16, 32),
                                          (2, 12, 9, 20, 64)])
def test_plain_fused_attention_bf16_matches_jax(b, h, lq, lk, hd):
    q, k, v, bias = _inputs(b, h, lq, lk, hd, seed=7)
    (out, probs), kern, ref = _both(q, k, v, bias, torch.bfloat16)
    for want in (kern, ref):
        np.testing.assert_allclose(out, want[0], rtol=BF16_OUT_TOL,
                                   atol=BF16_OUT_TOL)
        np.testing.assert_allclose(probs, want[1], rtol=0, atol=BF16_MAP_TOL)
    assert float(probs[..., -3:].max()) < 1e-6


@pytest.mark.parametrize("b,h,lq,lk,hd,full_bias,masked_row", CASES)
def test_exact_limit_admits_the_jax_kernel_in_bf16(b, h, lq, lk, hd,
                                                   full_bias, masked_row):
    """The limit that holds the CUDA kernel on the card
    (``fused_attention_error``: the map to 2e-5 and out within one bf16
    rounding of P and one of out, against the f32 arithmetic) admits the
    JAX kernel's bf16 result and refuses the plain version's, which rounds
    the scores to bf16."""
    q, k, v, bias = _inputs(b, h, lq, lk, hd, seed=b * 100 + h * 10 + hd,
                            full_bias=full_bias, masked_row=masked_row)
    port, kern, _ = _both(q, k, v, bias, torch.bfloat16)
    bf = lambda x: torch.from_numpy(x).bfloat16()
    args = (bf(q), bf(k), bf(v), torch.from_numpy(bias))
    _, map_err, used = fused_attention_error(
        *args, *map(torch.tensor, kern), atol=TOL)
    assert map_err <= TOL and used <= 1.0, (map_err, used)
    _, map_err, used = fused_attention_error(
        *args, *map(torch.tensor, port), atol=TOL)
    assert map_err > TOL or used > 1.0, (map_err, used)


@pytest.mark.parametrize("bad", ["head_dim", "keys", "bias_shape", "dtype",
                                 "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    hd, lk = (24, 8) if bad == "head_dim" else (16, 257 if bad == "keys" else 8)
    q, k, v, bias = [torch.from_numpy(x) for x in
                     _inputs(1, 2, 4, lk, hd, seed=3)]
    if bad == "bias_shape":
        bias = bias[..., :-1]
    elif bad == "dtype":
        k = k.double()
    elif bad == "device":
        q, k, v, bias = [x.to("meta") for x in (q, k, v, bias)]
    with pytest.raises((ValueError, TypeError)):
        fused_attention(q, k, v, bias)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    q, k, v, bias = [torch.from_numpy(x) for x in
                     _inputs(2, 3, 4, 6, 32, seed=4)]
    before = fused_attention.launches
    tc_before = fused_attention.tc_launches
    got = fused_attention(q, k, v, bias)
    assert fused_attention.launches == before
    assert fused_attention.tc_launches == tc_before
    for g, w in zip(got, fused_attention_reference(q, k, v, bias)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_bf16_call_takes_the_plain_version_and_counts_no_launch():
    """Inputs the tensor-core route would take on the card still run the
    plain version on the CPU."""
    q, k, v, bias = [torch.from_numpy(x) for x in
                     _inputs(2, 2, 5, 40, 64, seed=5)]
    q, k, v = (x.bfloat16() for x in (q, k, v))
    assert attention._fused_takes_tensor_cores(q, k, v)
    before = (fused_attention.launches, fused_attention.tc_launches)
    got = fused_attention(q, k, v, bias)
    assert (fused_attention.launches, fused_attention.tc_launches) == before
    for g, w in zip(got, fused_attention_reference(q, k, v, bias)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _misaligned(x):
    flat = torch.empty(x.numel() + 8, dtype=x.dtype)
    y = flat[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("case", ["bf16", "f32", "lk256", "lk257",
                                  "q_misaligned", "k_misaligned",
                                  "v_misaligned"])
def test_fused_route_rule(case):
    """bf16 with at most 256 keys and 16-byte aligned q, k, v takes the
    tensor-core route; f32, more keys or a misaligned input the SIMT
    route."""
    lk = {"lk256": 256, "lk257": 257}.get(case, 24)
    q, k, v = (torch.zeros((2, 3, n, 32), dtype=torch.bfloat16)
               for n in (5, lk, lk))
    if case == "f32":
        q, k, v = q.float(), k.float(), v.float()
    elif case.endswith("_misaligned"):
        name = case[0]
        q, k, v = (_misaligned(x) if n == name else x
                   for n, x in zip("qkv", (q, k, v)))
    want = case in ("bf16", "lk256")
    assert attention._fused_takes_tensor_cores(q, k, v) == want


@pytest.mark.parametrize("lk,chunks", [(1, 2), (32, 2), (33, 4), (64, 4),
                                       (65, 8), (128, 8), (129, 13),
                                       (200, 13), (208, 13), (209, 16),
                                       (256, 16)])
def test_fused_tc_key_bucket(lk, chunks):
    """The key bucket: the fewest of 2, 4, 8, 13 or 16 chunks of 16 keys
    that hold Lk (13: MAGIC's 200-token instructions)."""
    assert attention.fused_tc_chunks(lk) == chunks


@pytest.mark.parametrize("hd", attention.HEAD_DIMS)
@pytest.mark.parametrize("chunks", [2, 4, 8, 13, 16])
@pytest.mark.parametrize("rt", [1, 2])
def test_fused_tc_smem_fits_the_h100(hd, chunks, rt):
    """Every instantiation of the tensor-core route fits a block's 227 KB
    of shared memory, and the MAGIC shapes (hd 64, 200 keys) leave room for
    three blocks per SM in either block height."""
    smem = attention.fused_tc_smem_bytes(hd, chunks, rt)
    assert 0 < smem <= 232448
    staged = 16 * rt * (hd + 8) * 2 + 2 * chunks * 16 * (hd + 8) * 2
    assert smem >= staged
    if (hd, chunks) == (64, 13):
        assert 3 * (smem + 1024) <= 233472


@pytest.mark.parametrize("hd,chunks,b,lq,rt", [
    (64, 13, 256, 200, 2),     # MAGIC-S language: 1,792 32-row blocks
    (64, 4, 256, 52, 2),       # MAGIC-S local self: 512
    (64, 13, 16, 200, 1),      # teacher language: 112 would underfill
    (64, 4, 16, 52, 1),        # teacher local self
    (64, 13, 132, 33, 2),      # exactly 264
    (64, 13, 131, 33, 1),      # 262
    (64, 2, 256, 200, 1),      # at most 32 keys: 2 warps, one row tile
    (32, 13, 256, 200, 1),     # hd 64 only
    (128, 13, 256, 200, 1)])
def test_fused_tc_row_tiles(hd, chunks, b, lq, rt):
    """32-row blocks where they still number 264 (two per SM) at hd 64 with
    at least 4 key chunks; 16-row blocks elsewhere."""
    assert attention.fused_tc_row_tiles(hd, chunks, b, lq) == rt
