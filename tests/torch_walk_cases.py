"""Seeded random observed graphs for the observed-subgraph walk
(``Rollout._walk_observed``, ``ops.walk``), shared by the CPU tests
(tests/test_torch_walk.py), the card's (tests/test_torch_walk_cuda.py) and
``chip_smoke.py``'s walk rows.

A case is S scans of N nodes with at most C candidates a node; each lane
has visited about half its scan and holds the distances of the observed
subgraph (direct edges of visited nodes, visited pivots, as
``relax_observed`` leaves them).  Edge lengths are 1 or 2, so costs tie.
Odd seeds add integer noise to the distances, so walks cycle and run to
the hop bound.  The first lanes are the edge cases, in turn: the target is
the current node, the lane does not move, the target is unreachable, and
the trajectory buffer is one short of full or already past it.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from vln_magic_tpu_torch.agent.rollout import MAX_TRAJ, WALK_HOPS, Rollout
from vln_magic_tpu_torch.ops.walk import INF_DIST

# (seed, candidate slots): eight graphs, C 10 and C 16
GRAPHS = [(seed, 10 if seed < 4 else 16) for seed in range(8)]
# wider than a warp: 40 slots, dense enough that least costs and their
# ties fall past slot 31
WIDE = {"c": 40, "n": 48, "chords": 48 * 40}
EDGE_CASES = ("target_is_cur", "not_moving", "unreachable", "nearly_full",
              "full")


def _scan(rng, n, c, chords):
    """A connected scan: a ring plus ``chords`` random chords, at most c
    neighbours a node, in random slot order; returns (ids [N, C] -1 padded,
    dist, the edge lengths [N, N] with INF_DIST off the graph)."""
    adj = np.zeros((n, n), bool)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    for _ in range(chords):
        i, j = rng.integers(0, n, 2)
        if i != j and adj[i].sum() < c and adj[j].sum() < c:
            adj[i, j] = adj[j, i] = True
    w = rng.integers(1, 3, (n, n)).astype(np.float32)
    w = np.minimum(w, w.T)
    ids = np.full((n, c), -1, np.int64)
    dist = np.zeros((n, c), np.float32)
    for i in range(n):
        nb = rng.permutation(np.flatnonzero(adj[i]))
        ids[i, :len(nb)] = nb
        dist[i, :len(nb)] = w[i, nb]
    return ids, dist, np.where(adj, w, np.float32(INF_DIST))


def _observed(edges, visited):
    """Every lane's observed-subgraph distances [B, N, N]: the direct edges
    (``edges``, [B, N, N]) of the visited nodes, then every visited node as
    a pivot.  The lengths are small integers, so every sum is exact."""
    d = torch.where(visited[:, :, None] | visited[:, None, :], edges,
                    INF_DIST)
    d.diagonal(dim1=1, dim2=2).fill_(0.0)
    for v in range(d.shape[1]):
        via = torch.minimum(d, d[:, :, v, None] + d[:, None, v, :])
        d = torch.where(visited[:, v, None, None], via, d)
    return d


def make_case(seed: int, b: int, c: int, n: int = 24, s: int = 3,
              chords: int | None = None, device="cpu"):
    """One walk's inputs on ``device``: (tables, state, target, moving,
    nodes, ln, hops) with tables and state namespaces of the fields the
    walk reads.  ``chords`` (2N by default) sets how densely the candidate
    slots fill."""
    rng = np.random.default_rng(seed)
    scans = [_scan(rng, n, c, 2 * n if chords is None else chords)
             for _ in range(s)]
    ids = np.stack([x[0] for x in scans])
    dist = np.stack([x[1] for x in scans])
    scan = rng.integers(0, s, b)
    cur = rng.integers(0, n, b)
    target = rng.integers(0, n, b)
    moving = rng.random(b) < 0.85
    visited = rng.random((b, n + 1)) < 0.5
    visited[:, n] = False
    visited[np.arange(b), cur] = True
    ln = rng.integers(1, 30, b)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    obs = _observed(t(np.stack([x[2] for x in scans]))[t(scan)],
                    t(visited[:, :n]))
    if seed % 2:
        noise = t(rng.integers(0, 4, (b, n, n)).astype(np.float32))
        obs = torch.where(obs < INF_DIST / 2, obs + noise, obs)
    for i in range(min(b, 5)):
        kind = EDGE_CASES[(i + seed) % len(EDGE_CASES)]
        if kind == "target_is_cur":
            target[i], moving[i] = cur[i], True
        elif kind == "not_moving":
            moving[i] = False
        elif kind == "unreachable":
            far = np.setdiff1d(np.arange(n), np.append(ids[scan[i], cur[i]],
                                                       cur[i]))
            target[i], moving[i] = far[0], True
            obs[i, far[0]] = INF_DIST
            obs[i, :, far[0]] = INF_DIST
            obs[i, far[0], far[0]] = 0.0
        elif kind in ("nearly_full", "full"):
            ln[i] = MAX_TRAJ - 1 if kind == "nearly_full" else MAX_TRAJ + 3
            moving[i] = True
    nodes = rng.integers(-1, n, (b, MAX_TRAJ + 1))
    tables = SimpleNamespace(cand_ids=t(ids), cand_mask=t(ids >= 0),
                             cand_dist=t(dist))
    state = SimpleNamespace(batch_size=b, scan=t(scan), cur=t(cur),
                            visited=t(visited), obs_dist=obs)
    hops = WALK_HOPS if seed % 4 < 2 else 16
    return tables, state, t(target), t(moving), t(nodes), t(ln), hops


def to(ns, device):
    """A namespace's tensors on ``device``."""
    return SimpleNamespace(**{k: v.to(device) if torch.is_tensor(v) else v
                              for k, v in vars(ns).items()})


def walker(tables):
    """A ``Rollout`` that holds only ``tables``: the walk needs no model."""
    r = object.__new__(Rollout)
    r.t = tables
    return r


def rollout_walk(tables, state, target, moving, nodes, ln, hops):
    """``Rollout._walk_observed`` on these tables: (prev, ln, the written
    copy of nodes)."""
    out = nodes.clone()
    prev, new_ln = walker(tables)._walk_observed(state, target, moving,
                                                   hops, out, ln)
    return prev, new_ln, out


def loop_walk(tables, state, target, moving, nodes, ln, hops):
    """``Rollout._walk_loop``, the torch loop, on these tables on their own
    device: (prev, ln, the written copy of nodes)."""
    out = nodes.clone()
    prev, new_ln = walker(tables)._walk_loop(state, target, moving, hops,
                                               out, ln)
    return prev, new_ln, out


def reference_walk(tables, state, target, moving, nodes, ln, hops):
    """``observed_walk_reference`` on the same inputs, as tensors."""
    from vln_magic_tpu_torch.ops.walk import observed_walk_reference

    out = nodes.cpu().numpy().copy()
    host = lambda x: x.cpu().numpy()
    prev, new_ln = observed_walk_reference(
        host(tables.cand_ids), host(tables.cand_mask), host(tables.cand_dist),
        host(state.scan), host(state.cur), host(target), host(moving),
        host(state.visited), host(state.obs_dist), out, host(ln), hops)
    return (torch.from_numpy(prev), torch.from_numpy(new_ln),
            torch.from_numpy(out))
