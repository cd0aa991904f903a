"""Numerical sanitizers: NaN/Inf detection with attribution, and
cross-process parameter consistency checks.

Port of ``vln_magic_tpu/utils/debug.py``, the equivalent of the
reference's NanDetector hooks (reference: map_nav_src/fairseq/
nan_detector.py:12-91) and the fairseq trainer's cross-rank consistency
check (fairseq/trainer.py:999-1031).  The checks walk nested dicts, lists
and tuples of tensors (or arrays) between steps and name each offending
leaf by its path, as JAX's name theirs.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn


def _leaves(tree, prefix=""):
    """(path, leaf) of every leaf of nested dicts, lists and tuples, in
    order; the path names as JAX's do: dict keys and ``[i]`` indices
    joined by dots."""
    join = lambda part: f"{prefix}.{part}" if prefix else part
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, join(str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, join(f"[{i}]"))
    else:
        yield prefix, tree


def _float_tensor(leaf):
    """``leaf`` as a floating tensor, or ``None`` for anything else."""
    if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype,
                                                      np.floating):
        return torch.from_numpy(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
        return leaf
    return None


def nonfinite_report(tree, prefix: str = "") -> list[str]:
    """Names of the leaves holding NaN or Inf (an empty list: clean)."""
    bad = []
    for name, leaf in _leaves(tree):
        x = _float_tensor(leaf)
        if x is not None and not bool(torch.isfinite(x).all()):
            bad.append(prefix + name)
    return bad


def assert_finite(tree, where: str = ""):
    bad = nonfinite_report(tree)
    if bad:
        raise FloatingPointError(
            f"non-finite values {('in ' + where) if where else ''}: "
            + ", ".join(bad[:10])
            + (f" (+{len(bad) - 10} more)" if len(bad) > 10 else ""))


def grad_health(grads) -> dict:
    """One pass over the gradients (a tree of tensors): global norm, max
    abs, non-finite count, as tensors."""
    leaves = [x for _, g in _leaves(grads)
              if (x := _float_tensor(g)) is not None]
    if not leaves:
        zero = torch.zeros(())
        return {"grad_norm": zero, "grad_max": zero,
                "grad_nonfinite": torch.zeros((), dtype=torch.long)}
    sq = sum(g.float().square().sum() for g in leaves)
    return {"grad_norm": torch.sqrt(sq),
            "grad_max": torch.stack([g.abs().max().float()
                                     for g in leaves]).max(),
            "grad_nonfinite": sum((~torch.isfinite(g)).sum() for g in leaves)}


def _flax_tree(params) -> dict:
    """``{flax flat name: f32 array}`` of a module (the flax layout, split
    leaves gathered whole: ``utils.weights.export_flax_params``) or of a
    flat dict already so named."""
    if isinstance(params, nn.Module):
        from .weights import export_flax_params

        return export_flax_params(params)
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in params.items()}


def param_fingerprint(params) -> str:
    """Deterministic digest of the parameters (a module, or flat flax
    names to tensors or arrays): JAX's over the same weights in their
    flax tree, which hashes each leaf's key path (``str`` of its
    ``DictKey`` tuple) and f32 bytes in path order
    (``vln_magic_tpu/utils/debug.py:57-67``)."""
    h = hashlib.sha256()
    paths = {"(" + ", ".join(f"DictKey(key={k!r})" for k in name.split("."))
             + ("," if "." not in name else "") + ")": arr
             for name, arr in _flax_tree(params).items()}
    for path in sorted(paths):
        h.update(path.encode())
        h.update(np.ascontiguousarray(np.asarray(paths[path],
                                                 np.float32)).tobytes())
    return h.hexdigest()[:16]


def check_params_in_sync(params) -> bool:
    """Whether every process holds the same parameters, by
    ``param_fingerprint`` (a collective; on a mesh the split leaves are
    gathered whole first, so every rank of a dp x mp mesh compares the
    whole model).  One process: True."""
    fp = param_fingerprint(params)
    if not (dist.is_available() and dist.is_initialized()):
        return True
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, fp)
    return all(f == out[0] for f in out)


class NanGuard:
    """Wrap a step function: raise ``FloatingPointError`` naming the leaf
    when its outputs (and, with ``check_inputs``, its inputs) go
    non-finite.  Disabled, it returns the function itself."""

    def __init__(self, enabled: bool = True, check_inputs: bool = False):
        self.enabled = enabled
        self.check_inputs = check_inputs

    def __call__(self, fn):
        if not self.enabled:
            return fn

        def wrapped(*args, **kwargs):
            if self.check_inputs:
                assert_finite(args, "step inputs")
            out = fn(*args, **kwargs)
            assert_finite(out, "step outputs")
            return out

        return wrapped
