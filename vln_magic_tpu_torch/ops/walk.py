"""The observed-subgraph walk: its kernel's wrapper and its plain version.

``observed_walk`` walks every lane from its current node toward its target
over the observed subgraph in one launch of ``csrc/observed_walk.cu``
(built and loaded by ``ops/build.py``); the source's header says what it
computes and how it is laid out.
``agent/rollout.py`` ``Rollout._walk_observed`` takes it for CUDA tensors,
and its own torch loop (``Rollout._walk_loop``) on the CPU.
``observed_walk_reference`` is the same walk in NumPy, lane by lane.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import load

INF_DIST = 1e9        # observed-graph distance of an unreached pair


def observed_walk_reference(cand_ids, cand_mask, cand_dist, scan, cur,
                            target, moving, visited, obs_dist, nodes, ln,
                            hops):
    """The walk on NumPy arrays, one lane at a time: from ``cur`` toward
    ``target``, the first candidate of least ``cand_dist + obs_dist[b,
    target]`` among those visited or the target itself, for at most
    ``hops`` hops, stopping at the first hop that does not step.  Each hop
    is appended to ``nodes`` (in place) at ``min(ln, nodes.shape[1] - 1)``.
    Returns (prev, the new lengths): prev is the node before the target on
    the walk, the current node where no hop reached it."""
    cand_ids, cand_mask, cand_dist, visited, obs_dist = map(
        np.asarray, (cand_ids, cand_mask, cand_dist, visited, obs_dist))
    max_traj = nodes.shape[1] - 1
    prev = np.array(cur, dtype=np.int64)
    ln = np.array(ln, dtype=np.int64)
    for b in range(len(prev)):
        t, s, p = int(target[b]), int(scan[b]), int(cur[b])
        if not moving[b]:
            continue
        for _ in range(hops):
            if p == t:
                break
            cand = cand_ids[s, p]
            safe = np.maximum(cand, 0)
            stepable = cand_mask[s, p] & (visited[b, safe] | (cand == t))
            cost = np.where(stepable, cand_dist[s, p] + obs_dist[b, t, safe],
                            np.float32(INF_DIST))
            j = int(np.argmin(cost))               # the first minimum
            if not cost[j] < INF_DIST / 2:
                break
            nxt = int(cand[j])
            if nxt == t:
                prev[b] = p
            nodes[b, min(ln[b], max_traj)] = nxt
            ln[b] += 1
            p = nxt
    return prev, ln


def _check(cand_ids, cand_mask, cand_dist, scan, cur, target, moving,
           visited, obs_dist, nodes, ln):
    b = cur.shape[0]
    s, n, c = cand_ids.shape
    want = {"cand_ids": (cand_ids, torch.int64, (s, n, c)),
            "cand_mask": (cand_mask, torch.bool, (s, n, c)),
            "cand_dist": (cand_dist, torch.float32, (s, n, c)),
            "scan": (scan, torch.int64, (b,)),
            "cur": (cur, torch.int64, (b,)),
            "target": (target, torch.int64, (b,)),
            "moving": (moving, torch.bool, (b,)),
            "visited": (visited, torch.bool, (b, visited.shape[-1])),
            "obs_dist": (obs_dist, torch.float32, (b, n, n)),
            "nodes": (nodes, torch.int64, (b, nodes.shape[-1])),
            "ln": (ln, torch.int64, (b,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{x.dtype} {list(x.shape)}")
        if x.device != cur.device:
            raise ValueError("all inputs must be on one device")
    if c < 1:
        raise ValueError("the candidate tables hold no slot")
    if visited.shape[1] < n or nodes.shape[1] < 1:
        raise ValueError(f"visited {list(visited.shape)} must cover {n} "
                         f"nodes and nodes {list(nodes.shape)} hold a slot")


def observed_walk(cand_ids, cand_mask, cand_dist, scan, cur, target, moving,
                  visited, obs_dist, nodes, ln, hops: int):
    """Walk the ``moving`` lanes from ``cur`` toward ``target`` over the
    observed subgraph, at most ``hops`` hops, appending each hop to
    ``nodes`` (in place).  Tables ``cand_ids`` i64, ``cand_mask`` bool,
    ``cand_dist`` f32, each ``[S, N, C]``, indexed by ``scan``;
    per lane ``scan``, ``cur``, ``target``, ``ln`` i64 and ``moving`` bool
    ``[B]``, ``visited`` bool ``[B, >= N]``, ``obs_dist`` f32 ``[B, N, N]``,
    ``nodes`` i64 ``[B, MAX_TRAJ + 1]``; every input read through its
    strides.  Returns (prev, the new lengths), as
    ``observed_walk_reference``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    args = (cand_ids, cand_mask, cand_dist, scan, cur, target, moving,
            visited, obs_dist, nodes, ln)
    _check(*args)
    if cur.device.type == "cpu":
        prev, new_ln = observed_walk_reference(*(x.numpy() for x in args),
                                               hops)
        return torch.from_numpy(prev), torch.from_numpy(new_ln)
    if cur.device.type != "cuda":
        raise ValueError(f"observed_walk runs on cpu or cuda, not "
                         f"{cur.device.type}")
    b, c = cur.shape[0], cand_ids.shape[2]
    prev = torch.empty(b, dtype=torch.int64, device=cur.device)
    new_ln = torch.empty_like(prev)
    ptrs = (ctypes.c_void_p * 13)(*(x.data_ptr() for x in args),
                                  prev.data_ptr(), new_ln.data_ptr())
    strides = (ctypes.c_longlong * 21)(*(st for x in args
                                         for st in x.stride()))
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("observed_walk").vln_observed_walk(
            ctypes.addressof(ptrs), ctypes.addressof(strides), b, c, hops,
            nodes.shape[1] - 1, stream)
    if rc != 0:
        raise RuntimeError(f"observed_walk kernel launch failed: "
                           f"cudaError {rc}")
    observed_walk.launches += 1
    return prev, new_ln


# kernel launches since the count was last reset
observed_walk.launches = 0
