"""Packed-head attention: the CUDA kernel's wrapper and its plain version.

``packed_attention`` replaces the TPU kernels of
``vln_magic_tpu/ops/attention.py`` (``_packed_kernel_grouped``, lines 81-142,
and ``_packed_kernel``, lines 54-78; ``pl.pallas_call`` at lines 216 and
238).  The kernel is ``csrc/packed_attention.cu``; its header says what it
computes, what bounds it on the H100 (bytes: about 67 MB, about 20 us at
3.35 TB/s at the global self-attention shape) and how it is laid out.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a C interface at first use, into ``vln_magic_tpu_torch/build/``, and
loaded with ctypes.  A CPU tensor takes ``packed_attention_reference``; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "packed_attention.cu")
BUILD_DIR = os.path.join(_PKG, "build")
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


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


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/packed_attention.cu")
    return path


def build(verbose: bool = False) -> str:
    """Compile the kernel (once per source content) and return the path of
    the shared library.  ``verbose`` prints ptxas' register and shared
    memory report."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    lib_path = os.path.join(BUILD_DIR, f"libpacked_attention_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, flush=True)
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.vln_packed_attention
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


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


def packed_attention(q, k, v, mask_bias, sprel_bias=None, *, num_heads):
    """Attention on packed heads.

    q ``[B, Lq, H*hd]``; k, v ``[B, Lk, H*hd]`` as the Linear layers emit
    them; ``mask_bias`` ``[B, Lk]`` f32 additive; ``sprel_bias`` optional
    ``[B, H, Lq, Lk]`` f32 additive.  q/k/v float32 or bfloat16, hd in
    {16, 32, 64, 128}.  Returns ``[B, Lq, H*hd]`` in q's dtype.
    """
    _check(q, k, v, mask_bias, sprel_bias, num_heads)
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, mask_bias, sprel_bias,
                                          num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // num_heads
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _load().vln_packed_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(),
            None if sprel_bias is None else sprel_bias.data_ptr(),
            out.data_ptr(), b, num_heads, lq, lk, hd, _DTYPE_CODE[q.dtype],
            float(math.sqrt(hd)), stream)
    if rc != 0:
        raise RuntimeError(f"packed_attention kernel launch failed: "
                           f"cudaError {rc}")
    packed_attention.launches += 1
    return out


# kernel launches since the count was last reset (chip_smoke.py reads it)
packed_attention.launches = 0
