"""Native host ops: C++ implementations over ctypes, with plain numpy
versions.

Port of ``vln_magic_tpu/native/``: corpus BLEU counts, batched Levenshtein
distance, edit operations, token-bucketed batching and WER
(``vln_native.cpp``).  The library is built with ``g++ -O3 -shared`` at
first use, never at import, into ``vln_magic_tpu_torch/build/`` (named by
the source's hash, so an edited source builds anew); where no compiler is
found the numpy versions keep every function but ``edit_ops`` working.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "vln_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
_lock = threading.Lock()
_lib = None
_build_failed = False


def lib_path() -> str:
    """Where the library of the current source is built."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libvln_native_{tag}.so")


def _build() -> str:
    path = lib_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                        "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, path)
    return path


def _load():
    """The library, built on first call; ``None`` where it cannot be."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bleu_count.argtypes = [i32p, ctypes.c_int, i32p, ctypes.c_int,
                                   i64p]
        lib.edit_distance_batch.argtypes = [i32p, i32p, i32p, i32p,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, i32p]
        lib.edit_ops.restype = ctypes.c_int32
        lib.edit_ops.argtypes = [i32p, ctypes.c_int, i32p, ctypes.c_int,
                                 i32p, ctypes.c_int]
        lib.batch_by_size.restype = ctypes.c_int32
        lib.batch_by_size.argtypes = [i32p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, i32p]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _i32(x):
    return np.ascontiguousarray(x, dtype=np.int32)


def _ptr(a, typ=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def bleu_counts(hyps: list, refs: list) -> np.ndarray:
    """Corpus-level clipped n-gram counts [match1, total1, ..., match4,
    total4] followed by (hyp_len, ref_len): enough to compute BLEU."""
    counts = np.zeros(8, np.int64)
    hyp_len = ref_len = 0
    lib = _load()
    for h, r in zip(hyps, refs):
        h, r = _i32(h), _i32(r)
        hyp_len += len(h)
        ref_len += len(r)
        if lib is not None:
            lib.bleu_count(_ptr(h), len(h), _ptr(r), len(r),
                           _ptr(counts, ctypes.c_int64))
        else:
            _bleu_count_np(h, r, counts)
    return np.concatenate([counts, [hyp_len, ref_len]])


def bleu_score(hyps: list, refs: list) -> float:
    """Smoothed corpus BLEU-4 in [0, 100]."""
    c = bleu_counts(hyps, refs)
    logs = [np.log(max(c[2 * n], 0.5) / max(c[2 * n + 1], 1))
            for n in range(4)]
    hyp_len, ref_len = c[8], c[9]
    bp = min(1.0, np.exp(1 - ref_len / max(hyp_len, 1)))
    return float(100.0 * bp * np.exp(np.mean(logs)))


def _bleu_count_np(h, r, counts):
    for n in range(1, 5):
        ref_ngrams = {}
        for i in range(len(r) - n + 1):
            k = tuple(r[i : i + n])
            ref_ngrams[k] = ref_ngrams.get(k, 0) + 1
        match, used = 0, {}
        for i in range(len(h) - n + 1):
            k = tuple(h[i : i + n])
            if used.get(k, 0) < ref_ngrams.get(k, 0):
                used[k] = used.get(k, 0) + 1
                match += 1
        counts[2 * (n - 1)] += match
        counts[2 * (n - 1) + 1] += max(len(h) - n + 1, 0)


def edit_distance(a_batch, b_batch) -> np.ndarray:
    """Batched Levenshtein distance over lists of int sequences."""
    bsz = len(a_batch)
    max_a = max((len(a) for a in a_batch), default=1) or 1
    max_b = max((len(b) for b in b_batch), default=1) or 1
    A = np.zeros((bsz, max_a), np.int32)
    B = np.zeros((bsz, max_b), np.int32)
    al = np.zeros(bsz, np.int32)
    bl = np.zeros(bsz, np.int32)
    for i, (a, b) in enumerate(zip(a_batch, b_batch)):
        A[i, : len(a)] = a
        B[i, : len(b)] = b
        al[i], bl[i] = len(a), len(b)
    out = np.zeros(bsz, np.int32)
    lib = _load()
    if lib is not None:
        lib.edit_distance_batch(_ptr(A), _ptr(al), _ptr(B), _ptr(bl), bsz,
                                max_a, max_b, _ptr(out))
        return out
    for i in range(bsz):
        out[i] = _levenshtein_np(A[i, : al[i]], B[i, : bl[i]])
    return out


def _levenshtein_np(a, b):
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, np.int64)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


def edit_ops(a, b) -> tuple[int, np.ndarray]:
    """(distance, ops) with ops in {0 keep, 1 sub, 2 insert, 3 delete}.
    Needs the library: raises ``NotImplementedError`` without it."""
    a, b = _i32(a), _i32(b)
    lib = _load()
    if lib is None:
        raise NotImplementedError("edit_ops requires the native library")
    max_ops = len(a) + len(b) + 1
    ops = np.zeros(max_ops, np.int32)
    d = lib.edit_ops(_ptr(a), len(a), _ptr(b), len(b), _ptr(ops), max_ops)
    # the alignment's length: keeps and subs advance both sequences,
    # inserts b, deletes a
    length = i = j = 0
    for op in ops:
        if i >= len(a) and j >= len(b):
            break
        length += 1
        if op in (0, 1):
            i += 1
            j += 1
        elif op == 2:
            j += 1
        else:
            i += 1
    return int(d), ops[:length]


def batch_by_size(lengths, max_tokens: int = 0, max_sentences: int = 0):
    """Group sample indices into token-capped batches; returns a list of
    index arrays (fairseq ``batch_by_size`` semantics)."""
    lengths = _i32(lengths)
    ids = np.zeros(len(lengths), np.int32)
    lib = _load()
    if lib is not None:
        nb = lib.batch_by_size(_ptr(lengths), len(lengths), max_tokens,
                               max_sentences, _ptr(ids))
    else:
        nb = _batch_by_size_np(lengths, max_tokens, max_sentences, ids)
    return [np.flatnonzero(ids == b) for b in range(nb)]


def _batch_by_size_np(lengths, max_tokens, max_sentences, ids):
    batch = count = max_len = 0
    for i, L in enumerate(lengths):
        cand = max(max_len, L)
        overflow = count > 0 and (
            (max_sentences > 0 and count + 1 > max_sentences)
            or (max_tokens > 0 and cand * (count + 1) > max_tokens))
        if overflow:
            batch += 1
            count = 0
            max_len = 0
        ids[i] = batch
        count += 1
        max_len = max(max_len, L)
    return batch + 1


def wer(hyps: list, refs: list) -> float:
    """Corpus word-error rate: the sum of edit distances over the total
    reference length (fairseq's scorer, reference: map_nav_src/fairseq/
    scoring/wer.py).  Takes token-id sequences or whitespace-split
    strings."""
    tok = lambda s: ([_stable_id(w) for w in s.split()]
                     if isinstance(s, str) else list(s))
    H = [tok(h) for h in hyps]
    R = [tok(r) for r in refs]
    total_ref = sum(len(r) for r in R)
    if total_ref == 0:
        return 0.0
    return float(edit_distance(H, R).sum()) / total_ref


def _stable_id(word: str) -> int:
    return zlib.crc32(word.encode()) & 0x7FFFFFFF
