"""The dp x mp process mesh on ``torch.distributed``.

Port of ``vln_magic_tpu/parallel/mesh.py``.  JAX lays its devices out as a
``Mesh`` of shape (dp, mp) and lets XLA insert the collectives; here each
device is one process of an initialised process group (the reference's
NCCL process group, map_nav_src/utils/distributed.py:21-88), rank ``r``
sits at (``r // mp``, ``r % mp``) as JAX's row-major reshape puts device
``r``, and the program issues the collectives itself (``parallel.
sharding``).  Ranks that share a dp coordinate form an mp group (they hold
the slices of one model replica); ranks that share an mp coordinate form a
dp group (they hold the same slice and see different batch rows).

``Mesh.active()`` marks the region where batch rows are split over dp: the
random draws (``draw_uniform``) and the cross-row reductions of the
training rollout (``dp_any``, ``dp_min``, ``dp_max``, ``dp_size``) read it.
Without an active mesh they are the one-process operations.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_ACTIVE: list = []          # the active mesh and its batch blocks, a stack


def init_distributed(device="cuda", backend: str | None = None):
    """Initialise the default process group from the torchrun environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``; one process: rank 0 of 1 on ``localhost:29500``) and
    return this process's device: ``cuda:LOCAL_RANK`` for ``"cuda"``, the
    CPU for ``"cpu"``.  The backend follows the device (NCCL for CUDA,
    gloo for the CPU) unless ``backend`` names one.  An initialised group
    is kept as it is."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{addr}:{port}",
            world_size=int(os.environ.get("WORLD_SIZE", 1)),
            rank=int(os.environ.get("RANK", 0)), device_id=(
                dev if dev.type == "cuda" and backend in (None, "nccl")
                else None))
    return dev


class Mesh:
    """This process's place in the dp x mp mesh: ``shape`` (``{"dp": ..,
    "mp": ..}``, as JAX's code reads it), ``rank``, its coordinates
    ``dp_rank`` and ``mp_rank``, the groups along each axis (``None`` for
    an axis of size 1, where every collective is the identity), its
    ``device`` and the ``backend`` of its groups."""

    def __init__(self, dp: int, mp: int, axis_names, device, backend: str):
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: dp, self.axis_names[1]: mp}
        self.dp, self.mp = dp, mp
        self.device, self.backend = device, backend
        self.rank = dist.get_rank()
        self.dp_rank, self.mp_rank = divmod(self.rank, mp)
        # every rank creates every group, in one order
        self.mp_group = self.dp_group = None
        if mp > 1:
            for i in range(dp):
                g = dist.new_group(list(range(i * mp, (i + 1) * mp)),
                                   backend=backend)
                if i == self.dp_rank:
                    self.mp_group = g
        if dp > 1:
            for j in range(mp):
                g = dist.new_group(list(range(j, dp * mp, mp)),
                                   backend=backend)
                if j == self.mp_rank:
                    self.dp_group = g

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, mp={self.mp}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    @contextmanager
    def active(self, blocks: int = 1):
        """The region where batch rows are split over dp.  ``blocks``: the
        number of dp-split row blocks the batch axis holds (2 for the
        fused dual rollout, whose batch is [teacher-forced rows, on-policy
        rows], each block split over dp)."""
        _ACTIVE.append((self, blocks))
        try:
            yield self
        finally:
            _ACTIVE.pop()

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n_global``."""
        if n_global % self.dp:
            raise ValueError(f"batch of {n_global} not divisible by "
                             f"dp={self.dp}")
        per = n_global // self.dp
        return slice(self.dp_rank * per, (self.dp_rank + 1) * per)


def make_mesh(n_devices: int | None = None, mp: int = 1,
              axis_names=("dp", "mp"), device=None,
              backend: str | None = None) -> Mesh:
    """A dp x mp mesh over the initialised process group (one process per
    device, ``init_distributed``): dp = world size / ``mp``.
    ``n_devices``, when given, must be the world size.  Raises
    ``ValueError`` when the world size is not divisible by ``mp``, as JAX
    does.  ``device`` defaults to ``cuda:LOCAL_RANK`` under NCCL and the
    CPU under gloo; the groups' backend follows it (NCCL for CUDA, gloo
    for the CPU), and ``backend`` overrides that only so that a test can
    put two ranks on one card (NCCL refuses two ranks on one device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.init_distributed)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                         f"{n_devices} processes, not {n}")
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by mp={mp}")
    if device is None:
        device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    return Mesh(n // mp, mp, axis_names, dev, backend)


def active_mesh():
    """``(mesh, blocks)`` of the innermost active region, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


def dp_size() -> int:
    """The number of dp ranks the active region splits batch rows over (1
    outside one): a mean over batch rows is the local mean / ``dp_size``."""
    act = active_mesh()
    return act[0].dp if act else 1


def _dp_reduce(x: torch.Tensor, op) -> torch.Tensor:
    act = active_mesh()
    if act is None or act[0].dp_group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op, group=act[0].dp_group)
    return y


def dp_any(x: torch.Tensor) -> torch.Tensor:
    """``x.any()`` over every dp rank's rows."""
    return _dp_reduce(x.any().int(), dist.ReduceOp.MAX).bool()


def dp_min(x: torch.Tensor) -> torch.Tensor:
    """``x.min()`` over every dp rank's rows (no gradient)."""
    return _dp_reduce(x.min(), dist.ReduceOp.MIN)


def dp_max(x: torch.Tensor) -> torch.Tensor:
    """``x.max()`` over every dp rank's rows (no gradient)."""
    return _dp_reduce(x.max(), dist.ReduceOp.MAX)


def draw_uniform(shape, generator=None, device=None, batch_dim: int = 0,
                 branches: int = 1, head_dim: int | None = None,
                 heads_mp=None) -> torch.Tensor:
    """``torch.rand(shape)`` for a tensor whose axis ``batch_dim`` holds this
    rank's batch rows: inside an active mesh the draw is made at the
    global batch (and, where ``heads_mp`` is the mesh of a head-split
    attention, at all heads along ``head_dim``) and this rank's rows and
    heads are taken, so the draws do not depend on how the batch is split.
    ``branches``: the axis stacks that many copies of the batch (the
    branch-fused trunk's [2B]), each split over dp; the active region's
    ``blocks`` multiply it."""
    act = active_mesh()
    dp = act[0].dp if act else 1
    mp = heads_mp.mp if heads_mp is not None and head_dim is not None else 1
    if dp == 1 and mp == 1:
        return torch.rand(shape, generator=generator, device=device)
    shape = list(shape)
    full = list(shape)
    full[batch_dim] *= dp
    if mp > 1:
        full[head_dim] *= mp
    u = torch.rand(full, generator=generator, device=device)
    if dp > 1:
        nb = branches * act[1]
        u = u.unflatten(batch_dim, (nb, dp, shape[batch_dim] // nb)) \
            .select(batch_dim + 1, act[0].dp_rank).flatten(batch_dim,
                                                            batch_dim + 1)
    if mp > 1:
        u = u.unflatten(head_dim, (mp, shape[head_dim])).select(
            head_dim, heads_mp.mp_rank)
    return u
