"""Block-Momentum Update Filtering (BMUF): data parallelism by periodic
parameter averaging, the alternative dp strategy the reference vendors
(reference: map_nav_src/fairseq/optim/bmuf.py:12-230).

Port of ``vln_magic_tpu/parallel/bmuf.py``.  Each worker trains its own
replica for ``sync_period`` steps; at a sync the replicas are averaged
and filtered through a block-momentum update with an optional Nesterov
lookahead (fairseq bmuf.py:196-227: ``grad = prev_global - avg``,
``v = bm * v + (1 - bm) * lr_block * -grad``, workers restart from
``global + bm * v`` under Nesterov).  The replicas are a leading worker
axis [W, ...] on every tensor of a dict of tensors; the average is a mean
over that axis (across processes, an all-reduce over dp of each rank's
replica divided by W gives the same).
"""

from __future__ import annotations

import torch


def bmuf_init(params: dict) -> dict:
    """State for :func:`bmuf_sync`: the global (averaged) model and the
    block-momentum smoothed delta."""
    return {"global": {k: torch.as_tensor(v).clone()
                       for k, v in params.items()},
            "velocity": {k: torch.zeros_like(torch.as_tensor(v))
                         for k, v in params.items()}}


def replicate_workers(params: dict, num_workers: int) -> dict:
    """``num_workers`` copies of each tensor along a new leading axis."""
    return {k: torch.as_tensor(v)[None].expand(
        (num_workers,) + tuple(torch.as_tensor(v).shape)).clone()
        for k, v in params.items()}


def bmuf_sync(worker_params: dict, state: dict, block_momentum: float = 0.875,
              block_lr: float = 1.0, use_nesterov: bool = True):
    """One BMUF synchronisation of ``worker_params`` ([W, ...] per name).
    Returns ``(new_worker_params, new_state)``: the averaged and
    momentum-filtered global model, broadcast back to every worker (with
    the Nesterov lookahead ``global + bm * v``, as fairseq's
    ``_update_global_model``)."""
    bm, lr = block_momentum, block_lr
    workers, glob, vel = {}, {}, {}
    for k, w in worker_params.items():
        g, v = state["global"][k], state["velocity"][k]
        delta = w.mean(dim=0) - g              # -grad in fairseq's sign
        v2 = bm * v + (1.0 - bm) * lr * delta
        g2 = g + v2
        start = g2 + bm * v2 if use_nesterov else g2
        workers[k] = start[None].expand(w.shape).clone()
        glob[k], vel[k] = g2, v2
    return workers, {"global": glob, "velocity": vel}
