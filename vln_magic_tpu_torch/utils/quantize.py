"""Post-training int8 weight quantization for serving.

Port of ``vln_magic_tpu/utils/quantize.py``: per-channel symmetric int8 for
matmul kernels and embeddings, f32 for everything else, and the product
quantizer (the fairseq fork's ``modules/quantization/pq``).  The arithmetic
is the same numpy, so on the flax layout that ``utils.weights.
export_flax_params`` gives, the int8 values and scales equal JAX's bit for
bit.

A tree is a dict of arrays, flat (``{"params.x.kernel": array}``) or nested;
a leaf is a numpy array or a torch tensor.  A quantized leaf becomes
``{"__int8__": q, "scale": scale, "dtype": name}``, ``name`` the leaf's
dtype as a string ("float32", "bfloat16"), so that dequantization restores
it with no ``ml_dtypes``: a bfloat16 leaf comes back as a bfloat16 torch
tensor, any other as a numpy array.  ``save_quantized`` and the serving
bundle flatten it to ``<name>.__int8__``, ``<name>.scale`` and
``<name>.dtype`` in an ``.npz``.
"""

from __future__ import annotations

import numpy as np
import torch

QKEYS = ("__int8__", "scale", "dtype")


def quantize_array(x, axis: int = -1):
    """Per-channel symmetric int8: returns (q int8, scale f32)."""
    x = _f32(x)
    amax = np.max(np.abs(x), axis=axis, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_array(q: np.ndarray, scale: np.ndarray, dtype=None):
    """``q * scale`` in f32, cast to ``dtype`` (a dtype name) if given."""
    deq = np.asarray(q).astype(np.float32) * np.asarray(scale)
    if dtype is None or str(dtype) == "float32":
        return deq
    if str(dtype) == "bfloat16":
        return torch.from_numpy(deq).to(torch.bfloat16)
    return deq.astype(str(dtype))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _numpy(x) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor, which numpy cannot hold, as
    f32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return np.asarray(x).dtype.name


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and "__int8__" in x


def _map(fn, tree):
    """``fn`` on every leaf of a dict tree; a quantized leaf is a leaf."""
    if isinstance(tree, dict) and not _is_qleaf(tree):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_params(params, min_size: int = 1024):
    """Quantize every floating leaf of >= 2 dimensions and >= ``min_size``
    elements (JAX's rule; a bfloat16 leaf quantizes too).  Other leaves
    pass through."""

    def visit(leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 2 and int(np.prod(shape)) >= min_size \
                and _is_float(leaf):
            q, scale = quantize_array(leaf)
            return {"__int8__": q, "scale": scale,
                    "dtype": np.asarray(_dtype_name(leaf))}
        return leaf

    return _map(visit, params)


def dequantize_params(qparams):
    """The tree with every quantized leaf dequantized to its dtype."""

    def visit(x):
        if _is_qleaf(x):
            return dequantize_array(x["__int8__"], x["scale"],
                                    _dtype_of(x.get("dtype")))
        return x

    return _map(visit, qparams)


def _dtype_of(entry):
    """The dtype name a quantized leaf records: a string (this package),
    or JAX's zero-size proxy array of the dtype; None for none."""
    if entry is None:
        return None
    entry = np.asarray(entry)
    return str(entry) if entry.dtype.kind == "U" else entry.dtype.name


def quantization_error(params, qparams) -> dict:
    """Per-leaf relative L2 error of the quantized tree (diagnostics), by
    dot-joined name."""
    flat_p, flat_d = flatten(params), flatten(dequantize_params(qparams))
    out = {}
    for name, p in flat_p.items():
        p, d = _f32(p), _f32(flat_d[name])
        out[name] = float(np.linalg.norm(p - d) / (np.linalg.norm(p) + 1e-9))
    return out


def flatten(tree, prefix: str = "") -> dict:
    """A dict tree as ``{dot-joined name: leaf}``; a quantized leaf becomes
    its three entries ``<name>.__int8__``, ``<name>.scale``, ``<name>.dtype``
    (what an ``.npz`` holds)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten_quantized(flat: dict) -> dict:
    """The inverse of ``flatten`` on a flat tree: ``<name>.__int8__`` and
    its siblings regrouped into one quantized leaf under ``<name>``."""
    out = {}
    for name, v in flat.items():
        base, _, key = name.rpartition(".")
        if key in QKEYS and f"{base}.__int8__" in flat:
            out.setdefault(base, {})[key] = v
        else:
            out[name] = v
    return out


def save_quantized(params, path: str):
    """Quantized checkpoint as a compressed npz (int8 kernels + scales)."""
    flat = {k: _numpy(v) for k, v in flatten(quantize_params(params)).items()}
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)


def load_quantized(path: str) -> dict:
    """A ``save_quantized`` (or serving bundle) npz, dequantized, as a flat
    ``{name: array}`` dict (JAX's ``load_quantized`` nests it; read by
    ``utils.weights.load_flax_params`` here)."""
    with np.load(path, allow_pickle=False) as blob:
        flat = {k: blob[k] for k in blob.files}
    return dequantize_params(unflatten_quantized(flat))


# ----- product quantization (fairseq modules/quantization/pq, the EM
#       codebook learner: split each row into M subvectors, k-means each
#       block, store uint8 codes + centroid tables) -----

class ProductQuantizer:
    """PQ for 2-D weight matrices: columns split into ``num_blocks`` groups,
    each group's subvectors clustered into ``num_centroids`` codewords.

    Compression: [R, C] f32 -> [R, M] uint8 codes + [M, K, C/M] centroids.
    """

    def __init__(self, num_blocks: int = 4, num_centroids: int = 256,
                 iters: int = 12, seed: int = 0):
        if num_centroids > 256:
            raise ValueError("codes are uint8: num_centroids <= 256")
        self.M = num_blocks
        self.K = num_centroids
        self.iters = iters
        self.seed = seed
        self.centroids = None   # [M, K, sub]

    def fit(self, w) -> "ProductQuantizer":
        w = _f32(w)
        r, c = w.shape
        if c % self.M:
            raise ValueError(f"{c} columns not divisible by {self.M} blocks")
        sub = c // self.M
        rng = np.random.default_rng(self.seed)
        cents = []
        for m in range(self.M):
            x = w[:, m * sub : (m + 1) * sub]
            k = min(self.K, len(x))
            cent = x[rng.choice(len(x), k, replace=False)].copy()
            for _ in range(self.iters):   # lloyd iterations
                d = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
                assign = d.argmin(1)
                for j in range(k):
                    sel = assign == j
                    if sel.any():
                        cent[j] = x[sel].mean(0)
            if k < self.K:                # pad the codebook
                cent = np.concatenate(
                    [cent, np.repeat(cent[-1:], self.K - k, axis=0)])
            cents.append(cent)
        self.centroids = np.stack(cents)
        return self

    def encode(self, w) -> np.ndarray:
        w = _f32(w)
        sub = w.shape[1] // self.M
        codes = np.empty((w.shape[0], self.M), np.uint8)
        for m in range(self.M):
            x = w[:, m * sub : (m + 1) * sub]
            d = ((x[:, None, :] - self.centroids[m][None]) ** 2).sum(-1)
            codes[:, m] = d.argmin(1).astype(np.uint8)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [self.centroids[m][codes[:, m]] for m in range(self.M)], axis=1)

    def state(self) -> dict:
        return {"centroids": self.centroids, "num_blocks": self.M,
                "num_centroids": self.K}

    @classmethod
    def from_state(cls, state: dict) -> "ProductQuantizer":
        pq = cls(int(state["num_blocks"]), int(state["num_centroids"]))
        pq.centroids = np.asarray(state["centroids"], np.float32)
        return pq
