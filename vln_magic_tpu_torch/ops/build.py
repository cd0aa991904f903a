"""Build and load the CUDA kernels in ``vln_magic_tpu_torch/csrc/``.

Each kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a C interface at first use, into ``vln_magic_tpu_torch/build/``, named
by a hash of its source so that a changed source builds anew, and loaded
with ctypes, its exported functions typed from ``_SYMBOLS``.  The wrappers
(``ops/attention.py``, ``ops/walk.py``) call ``load``; ``build`` alone
compiles ahead of use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("packed_attention", "fused_attention", "observed_walk")
BUILD_DIR = os.path.join(_PKG, "build")
_PACKED_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
_FUSED_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_void_p])
# each kernel's exported C functions and their argument types
_SYMBOLS = {
    "packed_attention": {"vln_packed_attention": _PACKED_ARGS,
                         "vln_packed_attention_tc": _PACKED_ARGS},
    "fused_attention": {"vln_fused_attention": _FUSED_ARGS,
                        "vln_fused_attention_tc": _FUSED_ARGS,
                        "vln_fused_attention_tc_smem": [ctypes.c_int] * 4},
    "observed_walk": {"vln_observed_walk": [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p]},
}

_libs: dict = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in vln_magic_tpu_torch/csrc/")
    return path


def _source(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def _lib_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build(names=KERNELS, reports: dict | None = None) -> dict:
    """Compile each named kernel (once per source content) and return
    ``{name: library path}``.  Given a dict, ``reports`` receives ptxas'
    register, spill and shared memory report of each kernel it builds."""
    paths = {}
    for name in names:
        lib_path = paths[name] = _lib_path(name)
        if os.path.exists(lib_path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, _source(name)]
        if reports is not None:
            cmd[1:1] = ["-Xptxas", "-v"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({res.returncode}):"
                               f"\n{res.stderr}")
        if reports is not None:
            reports[name] = res.stderr
        os.replace(tmp, lib_path)
    return paths


def load(name: str):
    """The named kernel's library, built if need be, loaded once a
    process."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(build((name,))[name])
            for symbol, argtypes in _SYMBOLS[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]
