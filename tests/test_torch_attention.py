"""The port's packed-head attention (vln_magic_tpu_torch.ops.attention) held
against the JAX kernel in interpret mode and its XLA oracle.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernels themselves are compared with that plain version on the card
(tests/test_torch_kernel_cuda.py and chip_smoke.py).  Inputs come from numpy
with a fixed seed and go to both frameworks unchanged.  Tolerance 2e-5
absolute in f32 (sums in another order).  The tighter bf16 limit that holds
the CUDA kernel to its own f32 arithmetic (``packed_attention_error``) is
checked here against the JAX kernel's bf16 result.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vln_magic_tpu.ops.attention import (packed_attention as jax_packed,
                                         packed_attention_reference as jax_ref)
from vln_magic_tpu_torch.ops.attention import (packed_attention,
                                               packed_attention_error,
                                               packed_attention_reference)

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, h, lq, lk, hd, sprel, seed, masked_row=False):
    rng = np.random.default_rng(seed)
    d = h * hd
    q = rng.standard_normal((b, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, d)).astype(np.float32)
    mask = np.zeros((b, lk), np.float32)
    mask[:, -3:] = -1e9
    if masked_row:
        mask[1] = -1e9          # an ended episode: every key masked
    sb = rng.standard_normal((b, h, lq, lk)).astype(np.float32) \
        if sprel else None
    return q, k, v, mask, sb


# the six packed shapes of tests/test_ops.py (ungrouped hd 16/32 and
# grouped hd 64, with and without sprel) and a fully masked row
CASES = [
    (4, 2, 16, 24, 32, False, False),
    (2, 2, 16, 16, 32, True, False),
    (3, 4, 8, 8, 16, False, False),
    (4, 2, 16, 24, 64, False, False),
    (2, 2, 16, 16, 64, True, False),
    (2, 4, 8, 24, 64, True, False),
    (3, 2, 16, 24, 64, True, True),
]


@pytest.mark.parametrize("b,h,lq,lk,hd,sprel,masked_row", CASES)
def test_plain_packed_attention_matches_jax(b, h, lq, lk, hd, sprel,
                                            masked_row):
    q, k, v, mask, sb = _inputs(b, h, lq, lk, hd, sprel, seed=b * 100 + hd,
                                masked_row=masked_row)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = packed_attention(t(q), t(k), t(v), t(mask), t(sb),
                           num_heads=h).numpy()
    j = lambda x: None if x is None else jnp.asarray(x)
    want_kernel = np.asarray(jax_packed(j(q), j(k), j(v), j(mask), j(sb),
                                        num_heads=h, interpret=True))
    want_ref = np.asarray(jax_ref(j(q), j(k), j(v), j(mask), j(sb), h))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=TOL)
    if masked_row:
        # -1e9 swamps every score: the row is the uniform mean of V
        np.testing.assert_allclose(got[1], np.broadcast_to(
            v[1].mean(0), got[1].shape), rtol=0, atol=1e-5)


def test_plain_packed_attention_bf16_matches_jax():
    q, k, v, mask, sb = _inputs(2, 2, 16, 16, 64, True, seed=1)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    got = packed_attention(bf(q), bf(k), bf(v), torch.from_numpy(mask),
                           torch.from_numpy(sb), num_heads=2)
    assert got.dtype == torch.bfloat16
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)
    want = jax_ref(jb(q), jb(k), jb(v), jnp.asarray(mask), jnp.asarray(sb), 2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,h,lq,lk,hd,sprel,masked_row", [
    (2, 2, 16, 16, 64, True, False),    # grouped body, sprel
    (3, 2, 16, 24, 64, True, True),     # a fully masked row
    (3, 4, 8, 8, 16, False, False),     # ungrouped body, H 4 x hd 16
    (4, 2, 9, 24, 32, False, False)])   # ungrouped body, odd Lq
def test_exact_limit_admits_the_jax_kernel_in_bf16(b, h, lq, lk, hd, sprel,
                                                   masked_row):
    """The limit that holds the CUDA kernel on the card
    (``packed_attention_error``: out within one bf16 rounding of P and one
    of out, against the f32 arithmetic) admits the JAX kernel's bf16 result
    and refuses the plain version's, which rounds the scores to bf16."""
    q, k, v, mask, sb = _inputs(b, h, lq, lk, hd, sprel, seed=b * 100 + hd,
                                masked_row=masked_row)
    q = q * 3.0     # logits of std 3, as peaked as a trained model's
    bf = lambda x: torch.from_numpy(x).bfloat16()
    args = (bf(q), bf(k), bf(v), torch.from_numpy(mask),
            None if sb is None else torch.from_numpy(sb), h)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)
    kern = jax_packed(jb(q), jb(k), jb(v), jnp.asarray(mask),
                      None if sb is None else jnp.asarray(sb), num_heads=h,
                      interpret=True)
    kern = torch.from_numpy(np.asarray(kern, np.float32)).bfloat16()
    _, used = packed_attention_error(*args, kern, atol=TOL)
    assert used <= 1.0, used
    plain = packed_attention(*args[:5], num_heads=h)
    _, used = packed_attention_error(*args, plain, atol=TOL)
    assert used > 1.0, used


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mask_shape",
                                 "sprel_shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, mask, sb = [torch.from_numpy(x) for x in
                         _inputs(2, 2, 4, 6, 16, True, seed=3)]
    heads = 2
    if bad == "head_dim":
        heads = 1                     # hd 32 ok; make it 24 instead
        q, k, v = q[..., :24].contiguous(), k[..., :24].contiguous(), \
            v[..., :24].contiguous()
        sb = None
    elif bad == "dtype":
        k = k.double()
    elif bad == "mask_shape":
        mask = mask[:, :-1].contiguous()
    elif bad == "sprel_shape":
        sb = sb[:, :1].contiguous()
    else:
        q, k, v, mask, sb = [x.to("meta") for x in (q, k, v, mask, sb)]
    with pytest.raises((ValueError, TypeError)):
        packed_attention(q, k, v, mask, sb, num_heads=heads)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    q, k, v, mask, sb = [torch.from_numpy(x) for x in
                         _inputs(2, 2, 4, 6, 16, True, seed=4)]
    before = packed_attention.launches
    out = packed_attention(q, k, v, mask, sb, num_heads=2)
    assert packed_attention.launches == before
    torch.testing.assert_close(
        out, packed_attention_reference(q, k, v, mask, sb, 2), rtol=0, atol=0)
