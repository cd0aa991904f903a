"""Attention kernels: their wrappers and their plain versions.

``packed_attention`` replaces the TPU kernels of
``vln_magic_tpu/ops/attention.py`` (``_packed_kernel_grouped``, lines 81-142,
and ``_packed_kernel``, lines 54-78; ``pl.pallas_call`` at lines 216 and
238); its kernels are in ``csrc/packed_attention.cu``: a tensor-core route
for bf16 with at most 256 keys, and a SIMT route for the rest.
``fused_attention`` replaces ``_kernel`` (lines 37-51; ``pl.pallas_call`` at
line 272); its kernels are in ``csrc/fused_attention.cu``, with the same two
routes.  Each source's header says what it computes, what bounds it on the
H100 and how it is laid out.

Each kernel is compiled with ``nvcc`` into a shared library with a C
interface at first use and loaded with ctypes (``ops/build.py``).  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import load

HEAD_DIMS = (16, 32, 64, 128)
MAX_FUSED_KEYS = 256          # csrc/fused_attention.cu keeps 8 key tiles
MAX_TC_KEYS = 256             # the tensor-core routes hold a row's logits
                              # in registers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def packed_attention_reference(q, k, v, mask_bias, sprel_bias, num_heads):
    """Plain PyTorch version of ``packed_attention`` (the JAX oracle
    ``packed_attention_reference``, vln_magic_tpu/ops/attention.py:145)."""
    b, lq, d = q.shape
    hd = d // num_heads
    qh = q.reshape(b, lq, num_heads, hd)
    kh = k.reshape(b, k.shape[1], num_heads, hd)
    vh = v.reshape(b, v.shape[1], num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
    s = s.float() + mask_bias[:, None, None, :]
    if sprel_bias is not None:
        s = s + sprel_bias
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vh)
    return out.reshape(b, lq, d)


def packed_attention_error(q, k, v, mask_bias, sprel_bias, num_heads, out,
                           atol=2e-5):
    """How far a ``packed_attention`` result ``out`` lies from the kernel's
    own arithmetic: the plain version on the f32 upcast of the same inputs
    (exact from bf16), whose f32 scores and softmax are the kernel's.  Out
    may differ further by one rounding of P to V's dtype before P.V and one
    of out itself (see ``_rounding_error``).

    Returns ``(max abs err, the largest share of the limit used)``; a result
    within its limit has a share <= 1."""
    f = lambda x: x.float()
    args = (mask_bias, sprel_bias, num_heads)
    out32 = packed_attention_reference(f(q), f(k), f(v), *args)
    pv_abs = packed_attention_reference(f(q), f(k), f(v).abs(), *args)
    return _rounding_error(out, out32, pv_abs, q.dtype, atol)


def _check(q, k, v, mask_bias, sprel_bias, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, L, H*hd]")
    b, lq, d = q.shape
    lk = k.shape[1]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if num_heads <= 0 or d % num_heads or d // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {d}/{num_heads} not in {HEAD_DIMS}")
    if k.shape != (b, lk, d) or v.shape != (b, lk, d) or lq == 0 or lk == 0:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if mask_bias.dtype != torch.float32 or mask_bias.shape != (b, lk):
        raise ValueError(f"mask_bias must be f32 [{b}, {lk}]")
    tensors = [q, k, v, mask_bias]
    if sprel_bias is not None:
        if (sprel_bias.dtype != torch.float32
                or sprel_bias.shape != (b, num_heads, lq, lk)):
            raise ValueError(f"sprel_bias must be f32 [{b}, {num_heads}, "
                             f"{lq}, {lk}]")
        tensors.append(sprel_bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def _takes_tensor_cores(q, k, v) -> bool:
    """The packed kernel's route rule: bf16, at most 256 keys and 16-byte
    aligned q, k, v (out is allocated aligned) take the tensor-core route;
    everything else the SIMT route."""
    return (q.dtype == torch.bfloat16 and k.shape[1] <= MAX_TC_KEYS
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def packed_attention(q, k, v, mask_bias, sprel_bias=None, *, num_heads):
    """Attention on packed heads.

    q ``[B, Lq, H*hd]``; k, v ``[B, Lk, H*hd]`` as the Linear layers emit
    them; ``mask_bias`` ``[B, Lk]`` f32 additive; ``sprel_bias`` optional
    ``[B, H, Lq, Lk]`` f32 additive.  q/k/v float32 or bfloat16, hd in
    {16, 32, 64, 128}.  Returns ``[B, Lq, H*hd]`` in q's dtype.  Forward
    only: under grad mode, a CUDA input that requires grad raises.
    """
    _check(q, k, v, mask_bias, sprel_bias, num_heads)
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, mask_bias, sprel_bias,
                                          num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, mask_bias, sprel_bias)):
        raise RuntimeError("packed_attention has no backward: under grad "
                           "mode its inputs must not require grad")
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // num_heads
    tc = _takes_tensor_cores(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = load("packed_attention")
        fn = lib.vln_packed_attention_tc if tc else lib.vln_packed_attention
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
                None if sprel_bias is None else sprel_bias.data_ptr(),
                out.data_ptr(), b, num_heads, lq, lk, hd,
                _DTYPE_CODE[q.dtype], float(math.sqrt(hd)), stream)
    if rc != 0:
        raise RuntimeError(f"packed_attention kernel launch failed "
                           f"({'tensor-core' if tc else 'SIMT'} route): "
                           f"cudaError {rc}")
    packed_attention.launches += 1
    packed_attention.tc_launches += tc
    return out


# kernel launches since the counts were last reset (chip_smoke.py reads
# them): all launches, and those of the tensor-core route
packed_attention.launches = 0
packed_attention.tc_launches = 0


def _fused_takes_tensor_cores(q, k, v) -> bool:
    """The fused kernel's route rule, as the packed kernel's: bf16, at most
    256 keys and 16-byte aligned q, k, v (out is allocated aligned) take the
    tensor-core route; f32 and misaligned bf16 the SIMT route."""
    return (q.dtype == torch.bfloat16 and k.shape[2] <= MAX_TC_KEYS
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def fused_tc_chunks(lk: int) -> int:
    """The tensor-core route's key bucket for ``lk`` keys, in 16-key chunks
    (``tc_chunks`` in csrc/fused_attention.cu)."""
    return next(n for n in (2, 4, 8, 13, 16) if lk <= 16 * n)


def fused_tc_row_tiles(hd: int, nch: int, b: int, lq: int) -> int:
    """The tensor-core route's 16-row tiles per block (``tc_row_tiles`` in
    csrc/fused_attention.cu): 2 at hd 64 with at least 4 key chunks where
    32-row blocks still number 264 (two per SM), else 1."""
    return 2 if hd == 64 and nch >= 4 and b * -(-lq // 32) >= 264 else 1


def fused_tc_smem_bytes(hd: int, nch: int, rt: int) -> int:
    """Dynamic shared memory of one tensor-core block of ``rt`` row tiles
    (``tc_smem_bytes`` in csrc/fused_attention.cu): Q [16 rt][hd + 8] and K
    [keys][hd + 8] in bf16; V in bf16 or the warps' partial P.V in f32 that
    alias it, whichever is larger; the mask; each warp's row max and
    sum."""
    warps = min(nch, 4)
    q = 16 * rt * (hd + 8) * 2
    kv = nch * 16 * (hd + 8) * 2
    ox = (warps - rt) * 16 * (hd + 8) * 4
    return q + kv + max(kv, ox) + nch * 16 * 4 + 2 * warps * 16 * 4


def fused_attention_reference(q, k, v, bias):
    """Plain PyTorch version of ``fused_attention`` (the JAX oracle
    ``fused_attention_reference``, vln_magic_tpu/ops/attention.py:26): the
    scores in q's dtype, divided by sqrt(hd) in that dtype."""
    hd = q.shape[-1]
    root = torch.full((), math.sqrt(hd), dtype=torch.float32,
                      device=q.device).to(q.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / root
    scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)
    return out, probs.mean(dim=1)


def fused_attention_error(q, k, v, bias, out, probs, atol=2e-5):
    """How far a ``fused_attention`` result (``out``, ``probs``) lies from
    the kernel's own arithmetic.  The plain version on the f32 upcast of the
    same inputs (exact from bf16) has the kernel's f32 scores, f32 softmax
    and unrounded map, so the map must agree within ``atol``.  ``out`` may
    differ further by one rounding of P to V's dtype before P.V and one of
    out itself, each at most half an ulp (u = 2**-8 relative in bf16, 0 in
    f32), so its limit per element is
    ``1.01 * u * (sum_k p|v| + |out32|) + atol``.

    Returns ``(out max abs err, map max abs err, the largest share of the
    out limit used)``; a result within its limits has a map error <= atol
    and a share <= 1."""
    f = lambda x: x.float()
    out32, map32 = fused_attention_reference(f(q), f(k), f(v), bias)
    pv_abs = fused_attention_reference(f(q), f(k), f(v).abs(), bias)[0]
    err, used = _rounding_error(out, out32, pv_abs, q.dtype, atol)
    return err, (f(probs) - map32).abs().max().item(), used


def _rounding_error(out, out32, pv_abs, dtype, atol):
    """``out`` against the f32 result ``out32`` of the same arithmetic, with
    ``pv_abs`` = P.|V|: one rounding of P to ``dtype`` before P.V and one of
    out, each at most half an ulp (u = 2**-8 relative in bf16, 0 in f32),
    give the limit ``1.01 * u * (pv_abs + |out32|) + atol`` per element.
    Returns ``(max abs err, the largest share of the limit used)``."""
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    diff = (out.float() - out32).abs()
    limit = 1.01 * u * (pv_abs + out32.abs()) + atol
    return diff.max().item(), (diff / limit).max().item()


def _check_fused(q, k, v, bias):
    """Validate the inputs; return the bias as f32 expanded (stride 0 on
    its broadcast dimensions) to [B, H, Lq, Lk]."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, hd]")
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not 0 < lk <= MAX_FUSED_KEYS:
        raise ValueError(f"Lk {lk} not in [1, {MAX_FUSED_KEYS}]")
    if k.shape != (b, h, lk, hd) or v.shape != (b, h, lk, hd) or lq == 0:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    full = (b, h, lq, lk)
    try:
        fits = torch.broadcast_shapes(bias.shape, full) == full
    except RuntimeError:
        fits = False
    if bias.dim() > 4 or not bias.is_floating_point() or not fits:
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                         f"{full}")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    return bias.to(torch.float32).expand(full)


def fused_attention(q, k, v, bias):
    """Biased attention on split heads with the head-averaged map.

    q ``[B, H, Lq, hd]``; k, v ``[B, H, Lk, hd]``, float32 or bfloat16, hd in
    {16, 32, 64, 128}, Lk <= 256; ``bias`` broadcastable to
    ``[B, H, Lq, Lk]`` (mask and sprels summed), read in f32 through its
    strides.  Returns ``(out [B, H, Lq, hd] in q's dtype, probs [B, Lq, Lk]
    f32)``.  Forward only: a CUDA input that requires grad raises.
    """
    bias4 = _check_fused(q, k, v, bias)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    if any(t.requires_grad for t in (q, k, v, bias)):
        raise RuntimeError("fused_attention has no backward: its inputs "
                           "must not require grad")
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    tc = _fused_takes_tensor_cores(q, k, v)
    out = torch.empty_like(q)
    probs = torch.empty((b, lq, lk), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 4)(*bias4.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = load("fused_attention")
        fn = lib.vln_fused_attention_tc if tc else lib.vln_fused_attention
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias4.data_ptr(),
                ctypes.addressof(strides), out.data_ptr(), probs.data_ptr(),
                b, h, lq, lk, hd, _DTYPE_CODE[q.dtype],
                float(1.0 / math.sqrt(hd)), stream)
    if rc != 0:
        raise RuntimeError(f"fused_attention kernel launch failed "
                           f"({'tensor-core' if tc else 'SIMT'} route): "
                           f"cudaError {rc}")
    fused_attention.launches += 1
    fused_attention.tc_launches += tc
    return out, probs


# kernel launches since the counts were last reset (chip_smoke.py reads
# them): all launches, and those of the tensor-core route
fused_attention.launches = 0
fused_attention.tc_launches = 0
