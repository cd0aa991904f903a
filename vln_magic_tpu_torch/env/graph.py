"""Per-scan navigation graph with all-pairs shortest paths as dense tables.

The reference computes shortest paths with networkx Dijkstra once per scan and
then does per-query dict lookups inside the rollout hot loop
(reference: map_nav_src/r2r/env.py:172-188).  Here the whole graph is lowered
to dense numpy tables (distance matrix, step-count matrix, next-hop matrix) so
the rollout can consume them as device arrays: shortest-path queries become
O(1) gathers and path reconstruction a table walk.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

INF = np.float32(1e9)


@dataclass
class NavGraph:
    """A single scan's connectivity graph and derived dense tables."""

    scan: str
    node_ids: list[str]                 # viewpoint ids, index order is canonical
    positions: np.ndarray               # (n, 3) float32
    adjacency: np.ndarray               # (n, n) bool
    edge_dist: np.ndarray               # (n, n) float32, INF if no edge
    index: dict = field(init=False)     # viewpoint id -> index
    # APSP tables (dist/steps/next_hop) are LAZY: World.__init__ starts the
    # async feature-table device transfer first, then triggers the per-scan
    # Floyd-Warshall while the bytes stream (at 61 Matterport-scale scans the
    # FW sweep is ~25 s of host time that fully overlaps the transfer)
    _apsp: tuple | None = field(init=False, default=None, repr=False)

    def __post_init__(self):
        self.index = {vp: i for i, vp in enumerate(self.node_ids)}

    def _apsp_tables(self):
        if self._apsp is None:
            self._apsp = _floyd_warshall(self.edge_dist)
        return self._apsp

    @property
    def dist(self) -> np.ndarray:      # (n, n) shortest path length
        return self._apsp_tables()[0]

    @property
    def steps(self) -> np.ndarray:     # (n, n) int32 shortest hop count
        return self._apsp_tables()[1]

    @property
    def next_hop(self) -> np.ndarray:  # (n, n) int32 next node on path
        return self._apsp_tables()[2]

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    def distance(self, a: str, b: str) -> float:
        return float(self.dist[self.index[a], self.index[b]])

    def path(self, a: str, b: str) -> list[str]:
        """Shortest path [a, ..., b] by next-hop table walk."""
        return [self.node_ids[i] for i in self.path_indices(self.index[a], self.index[b])]

    def path_indices(self, i: int, j: int) -> list[int]:
        out = [i]
        guard = 0
        while i != j:
            i = int(self.next_hop[i, j])
            if i < 0 or guard > self.num_nodes:
                raise ValueError(f"no path between nodes in scan {self.scan}")
            out.append(i)
            guard += 1
        return out

    def neighbors(self, i: int) -> np.ndarray:
        return np.flatnonzero(self.adjacency[i])


def _floyd_warshall(edge_dist: np.ndarray):
    """Vectorized Floyd–Warshall with hop counts and next-hop reconstruction.

    Scans have <=~350 viewpoints so the O(n^3) dense sweep is milliseconds and
    runs once at world build; equals networkx all_pairs_dijkstra results
    (reference: map_nav_src/r2r/env.py:183-188) up to tie-breaking on
    equal-cost paths (edge weights are Euclidean floats, ties are measure-zero).
    """
    n = edge_dist.shape[0]
    dist = edge_dist.astype(np.float64).copy()
    np.fill_diagonal(dist, 0.0)
    steps = np.where(edge_dist < INF, 1, 0).astype(np.int32)
    np.fill_diagonal(steps, 0)
    # next_hop[i, j] = first node after i on the shortest path i -> j
    nxt = np.where(edge_dist < INF, np.arange(n)[None, :], -1).astype(np.int32)
    np.fill_diagonal(nxt, np.arange(n))

    for k in range(n):
        alt = dist[:, k, None] + dist[None, k, :]
        better = alt < dist - 1e-12
        dist = np.where(better, alt, dist)
        steps = np.where(better, steps[:, k, None] + steps[None, k, :], steps)
        nxt = np.where(better, nxt[:, k, None], nxt)

    unreachable = dist >= INF
    dist = np.where(unreachable, INF, dist).astype(np.float32)
    steps = np.where(unreachable, -1, steps).astype(np.int32)
    nxt = np.where(unreachable, -1, nxt).astype(np.int32)
    return dist, steps, nxt


def load_connectivity(connectivity_dir: str, scan: str) -> NavGraph:
    """Parse a Matterport ``{scan}_connectivity.json`` file.

    Pose layout and inclusion/obstruction semantics match reference
    map_nav_src/utils/data.py:79-104 (position = pose[3], pose[7], pose[11];
    undirected edges between mutually unobstructed included nodes).
    """
    with open(os.path.join(connectivity_dir, f"{scan}_connectivity.json")) as f:
        data = json.load(f)

    included = [item["included"] for item in data]
    node_ids, keep = [], []
    for i, item in enumerate(data):
        if not included[i]:
            continue
        node_ids.append(item["image_id"])
        keep.append(i)
    remap = {orig: new for new, orig in enumerate(keep)}
    n = len(node_ids)

    positions = np.zeros((n, 3), dtype=np.float32)
    adjacency = np.zeros((n, n), dtype=bool)
    for i in keep:
        item = data[i]
        ii = remap[i]
        positions[ii] = [item["pose"][3], item["pose"][7], item["pose"][11]]
        for j, conn in enumerate(item["unobstructed"]):
            if conn and included[j] and data[j]["unobstructed"][i]:
                adjacency[ii, remap[j]] = True

    diff = positions[:, None, :] - positions[None, :, :]
    euclid = np.sqrt((diff**2).sum(-1)).astype(np.float32)
    edge_dist = np.where(adjacency, euclid, INF)
    return NavGraph(scan, node_ids, positions, adjacency, edge_dist)
