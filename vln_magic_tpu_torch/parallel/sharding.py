"""Sharding: parameter splits (Megatron column/row parallelism and the
vocab-parallel embedding) and batch rows over dp.

Port of ``vln_magic_tpu/parallel/sharding.py``.  The split decision is
JAX's, on flax names: the kernels of ``query``, ``key``, ``value``,
``intermediate`` and ``z_proj`` split their output axis over mp (column
parallel), those of ``out`` and ``output`` their input axis (row
parallel), ``word_embeddings/embedding`` its vocabulary axis; every other
leaf, every leaf of fewer than 2 dims and every leaf whose split axis does
not divide by mp stays replicated.

JAX lets GSPMD insert the collectives; here they are written out as the
reference's fairseq fork does (fairseq/model_parallel/megatron/mpu/
layers.py, mappings.py).  ``shard_params`` cuts each split leaf to this
rank's slice in place and turns its module into the matching parallel
layer: a column-parallel linear reads its input through ``copy_to_mp``
(identity forward, all-reduce of the gradient) and its bias through
``scatter_to_mp``; a row-parallel linear all-reduces its partial product
(``reduce_from_mp``) and adds the whole bias; the embedding looks up its
slice of the vocabulary and all-reduces.  A column-parallel linear whose
consumer is not row parallel (``z_proj``, and the projections of an
attention whose heads do not divide by mp) all-gathers its output
(``gather_from_mp``), and the row-parallel linear behind such an attention
takes its slice of the input.  Where the heads divide, attention runs at
the local heads (``models.layers.MultiHeadAttention``).  So every
replicated leaf gets its whole gradient on every mp rank, and only the dp
all-reduce of ``reduce_gradients`` remains.

Every collective is an all-reduce (an all-gather is one over a zero-padded
buffer), which NCCL and gloo both carry on CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

COLUMN_PARALLEL = ("query", "key", "value", "intermediate", "z_proj")
ROW_PARALLEL = ("out", "output")
# column-parallel layers whose consumer is not row parallel
GATHERED_COLUMNS = ("z_proj",)


def param_spec(name: str, ndim: int) -> tuple:
    """JAX's partition spec of the leaf at flax name ``name`` (dot- or
    slash-joined) with ``ndim`` dims: ``(None, "mp")`` column parallel,
    ``("mp", None)`` row parallel or vocab parallel, ``()`` replicated."""
    names = name.replace("/", ".").split(".")
    if ndim < 2:
        return ()
    if "word_embeddings" in names and names[-1] == "embedding":
        return ("mp", None)
    if names[-1] == "kernel":
        parent = names[-2] if len(names) >= 2 else ""
        if parent in COLUMN_PARALLEL:
            return (None, "mp")
        if parent in ROW_PARALLEL:
            return ("mp", None)
    return ()


def split_axis(name: str, shape, mp: int) -> int | None:
    """The flax-layout axis of the leaf ``name`` that splits over ``mp``
    ranks, or ``None`` when it stays replicated (JAX's ``shard_params``:
    no split axis, or one that does not divide by ``mp``)."""
    if mp <= 1:
        return None
    for axis, ax in enumerate(param_spec(name, len(shape))):
        if ax == "mp":
            return axis if shape[axis] % mp == 0 else None
    return None


# ----- collectives with their conjugate gradients -----

def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    dist.all_reduce(y, op, group=group)
    return y


def all_gather(x, group, size: int, rank: int, dim: int):
    """The ranks' ``x`` concatenated along ``dim`` in rank order (an
    all-reduce over a zero buffer holding ``x`` at this rank's place)."""
    if group is None:
        return x
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    buf = x.new_zeros(shape)
    buf.narrow(dim, rank * n, n).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf


def _slice(x, size, rank, dim):
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh.mp_group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.mp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh.mp_group, mesh.mp, mesh.mp_rank, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _slice(g, m.mp, m.mp_rank, ctx.dim % g.dim()), None, None


class _ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _slice(x, mesh.mp, mesh.mp_rank, dim % x.dim())

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return all_gather(g, m.mp_group, m.mp, m.mp_rank, ctx.dim), None, None


class _GatherFromDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh.dp_group, mesh.dp, mesh.dp_rank, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _slice(g, m.dp, m.dp_rank, ctx.dim % g.dim()), None, None


def copy_to_mp(x, mesh):
    """Identity forward; the gradient all-reduced over mp (the input of a
    column-parallel layer)."""
    return x if mesh.mp_group is None else _CopyToMP.apply(x, mesh)


def reduce_from_mp(x, mesh):
    """All-reduce over mp; the gradient passes through (the output of a
    row-parallel layer)."""
    return x if mesh.mp_group is None else _ReduceFromMP.apply(x, mesh)


def gather_from_mp(x, mesh, dim: int = -1):
    """The mp ranks' slices concatenated along ``dim``; the gradient is
    cut back to this rank's slice."""
    return x if mesh.mp_group is None else _GatherFromMP.apply(x, mesh, dim)


def scatter_to_mp(x, mesh, dim: int = -1):
    """This rank's slice of ``x`` along ``dim``; the gradient is gathered."""
    return x if mesh.mp_group is None else _ScatterToMP.apply(x, mesh, dim)


def gather_from_dp(x, mesh, dim: int = 0):
    """The dp ranks' rows concatenated along ``dim`` (rank order, so the
    global batch); the gradient is cut back to this rank's rows, since
    every dp rank computes the same function of the gathered tensor."""
    return x if mesh.dp_group is None else _GatherFromDP.apply(x, mesh, dim)


# ----- parallel layers -----

@dataclasses.dataclass
class TensorParallel:
    """A module's split: ``kind`` ``col``, ``row`` or ``vocab``; ``gather``
    (col): all-gather the output; ``scatter`` (row): the input is whole,
    take this rank's slice first."""
    kind: str
    mesh: object
    gather: bool = False
    scatter: bool = False


def parallel_linear(x, weight, bias, tp: TensorParallel | None,
                    linear=F.linear):
    """``linear(x, weight, bias)`` under the split ``tp`` of the weight
    (``None``: unsplit).  ``linear`` takes a ``None`` bias."""
    if tp is None:
        return linear(x, weight, bias)
    m = tp.mesh
    if tp.kind == "col":
        y = linear(copy_to_mp(x, m), weight,
                   None if bias is None else scatter_to_mp(bias, m, -1))
        return gather_from_mp(y, m, -1) if tp.gather else y
    if tp.scatter:
        x = scatter_to_mp(x, m, -1)
    y = reduce_from_mp(linear(x, weight, None), m)
    if bias is None:
        return y
    # a per-branch bias [2, out] broadcasts over the rows between
    lead = bias.shape[:-1]
    return y + bias.reshape(lead + (1,) * (y.dim() - bias.dim())
                            + bias.shape[-1:])


class ParallelLinear(nn.Linear):
    """An ``nn.Linear`` whose weight holds this rank's slice (``tp``)."""

    def forward(self, x):
        return parallel_linear(x, self.weight, self.bias, self.tp)


class VocabParallelEmbedding(nn.Embedding):
    """An ``nn.Embedding`` holding this rank's rows of the vocabulary:
    ids outside them look up zeros, and the ranks' lookups are summed."""

    def forward(self, ids):
        m = self.tp.mesh
        n = self.weight.shape[0]
        lo = m.mp_rank * n
        mine = (ids >= lo) & (ids < lo + n)
        x = F.embedding(torch.where(mine, ids - lo, 0), self.weight)
        x = x * mine[..., None].to(x.dtype)
        return reduce_from_mp(x, m)


def vocab_logits(x, embedding: nn.Module):
    """``x @ embedding.weight.T`` over the whole vocabulary (the tied MLM
    decoder): on a vocab-parallel embedding each rank's slice of the
    logits, all-gathered, so the softmax spans every shard."""
    tp = getattr(embedding, "tp", None)
    if tp is None:
        return x @ embedding.weight.t()
    return gather_from_mp(copy_to_mp(x, tp.mesh) @ embedding.weight.t(),
                          tp.mesh, -1)


# ----- sharding modules and optimizer states -----

def _module_splits(model: nn.Module, mp: int) -> dict:
    """``{module name: (flax leaf name, torch axis)}`` of the split leaves
    (Linear weights and Embedding tables; flax kernels are [in, out], torch
    weights [out, in])."""
    from ..utils.weights import _flax_names

    flax = {id(p): (k, t) for k, (p, t) in _flax_names(model).items()}
    out = {}
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, (nn.Linear, nn.Embedding)):
            continue
        name, transposed = flax[id(mod.weight)]
        shape = tuple(mod.weight.shape)
        flax_shape = shape[::-1] if transposed else shape
        axis = split_axis(name, flax_shape, mp)
        if axis is not None:
            out[mod_name] = (name, (1 - axis) if transposed else axis)
    return out


def _cut(p: torch.Tensor, mesh, axis: int):
    """Replace ``p``'s data by this rank's slice along ``axis`` in place
    (the parameter object stays, so optimizers keep it), and mark it."""
    with torch.no_grad():
        p.data = _slice(p.data, mesh.mp, mesh.mp_rank, axis)
    p.tp_axis = axis
    p.tp_mesh = mesh


def shard_params(obj, mesh):
    """Shard ``obj`` over ``mesh`` in place and return it: a module (its
    split leaves cut to this rank's slice, their modules made parallel
    layers, head-split attentions set to their local heads, everything on
    ``mesh.device``), or an ``agent.trainer.Optimizer`` whose parameters a
    sharded module holds (its per-parameter state cut alike, so a state
    already loaded is kept).  At mp 1 a module only moves."""
    from ..agent.trainer import Optimizer

    if obj is None:
        return None
    if isinstance(obj, Optimizer):
        obj.shard(mesh)
        return obj
    from ..models.layers import MultiHeadAttention

    if any(is_split(p) for p in obj.parameters()):
        raise ValueError("the module is sharded already")
    model = obj.to(mesh.device)
    splits = _module_splits(model, mesh.mp)
    mods = dict(model.named_modules())
    for mod_name, (_, axis) in splits.items():
        mod = mods[mod_name]
        _cut(mod.weight, mesh, axis)
        if isinstance(mod, nn.Embedding):
            mod.__class__ = VocabParallelEmbedding
            mod.tp = TensorParallel("vocab", mesh)
            mod.num_embeddings = mod.weight.shape[0]
            continue
        kind = "col" if axis == 0 else "row"
        mod.__class__ = ParallelLinear
        mod.tp = TensorParallel(kind, mesh, gather=(
            kind == "col" and mod_name.rsplit(".", 1)[-1]
            in GATHERED_COLUMNS))
        mod.out_features, mod.in_features = mod.weight.shape
    for mod_name, mod in mods.items():
        if not isinstance(mod, MultiHeadAttention) or \
                f"{mod_name}.query".lstrip(".") not in splits:
            continue
        if mod.h % mesh.mp == 0:
            mod.shard_heads(mesh)
        else:
            # heads that do not divide: whole Q/K/V, the out input sliced
            for lin in (mod.query, mod.key, mod.value):
                lin.tp.gather = True
            mod.out.tp.scatter = True
    return model


def is_split(p: torch.Tensor) -> bool:
    return getattr(p, "tp_axis", None) is not None


def full_tensor(p: torch.Tensor, t: torch.Tensor | None = None):
    """The whole leaf of ``t`` (default ``p`` itself), a tensor shaped
    like the parameter ``p``: all-gathered over mp where ``shard_params``
    split ``p`` (a collective: every mp rank calls it)."""
    t = (p if t is None else t).detach()
    if not is_split(p):
        return t
    m = p.tp_mesh
    return all_gather(t, m.mp_group, m.mp, m.mp_rank, p.tp_axis)


def local_slice(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``t``, a whole leaf shaped like the split
    parameter ``p`` (``t`` itself where ``p`` is not split or ``t`` is
    already cut)."""
    if not is_split(p) or t.shape == p.shape:
        return t
    m = p.tp_mesh
    return _slice(t, m.mp, m.mp_rank, p.tp_axis)


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every split leaf gathered whole (a
    collective: every mp rank calls it)."""
    params = dict(model.named_parameters())
    return {k: full_tensor(params[k]) if k in params else v
            for k, v in model.state_dict().items()}


def all_reduce_tensors(tensors, group) -> None:
    """Sum each tensor over ``group`` in place, in one flat all-reduce per
    dtype."""
    if group is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


def reduce_gradients(params, mesh) -> None:
    """Sum every parameter's ``.grad`` over dp (each rank's loss is its
    share of the global objective)."""
    all_reduce_tensors([p.grad for p in params if p.grad is not None],
                       mesh.dp_group)


def reduce_metrics(metrics: dict, mesh) -> dict:
    """Sum each metric (a scalar tensor: this rank's share) over dp."""
    if mesh.dp_group is None or not metrics:
        return metrics
    names = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in
                        names])
    dist.all_reduce(flat, group=mesh.dp_group)
    return dict(zip(names, flat.unbind()))


# ----- batches -----

def batch_spec(leaf) -> tuple:
    """JAX's batch spec: the leading axis over dp."""
    nd = np.ndim(leaf)
    return ("dp",) + (None,) * (nd - 1) if nd >= 1 else ()


def shard_batch(x, mesh):
    """This rank's contiguous dp rows of a global batch (a leaf with a
    leading batch axis: a tensor, an array or a list)."""
    if np.ndim(x) == 0 and not isinstance(x, list):
        return x
    return x[mesh.rows(len(x))]


def shard_pytree_batch(tree, mesh):
    """``shard_batch`` of every leaf of a batch-leading tree: dicts, lists,
    tuples, dataclasses (``EpisodeBatch``); ``None`` stays."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: shard_pytree_batch(getattr(tree, f.name), mesh)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: shard_pytree_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(shard_pytree_batch(v, mesh) for v in tree)
    return shard_batch(tree, mesh)


def replicate(tree, mesh):
    """Every tensor of ``tree`` on this rank's device (world tables, small
    state): each process holds a whole copy."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: replicate(getattr(tree, f.name), mesh)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree
