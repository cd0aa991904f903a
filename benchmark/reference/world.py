"""Plain geometry and graph search for the reference replay.

Everything here is worked out from a scan's raw node positions and edges:
shortest paths, each node's candidate list with its heading, elevation and
discretized view, and the shortest paths of a partly observed map.  The
formulas are those of the Matterport simulator conventions that VLN-DUET
and VLN-MAGIC use (``map_nav_src/utils/data.py:127-201``): 36 views of 30
degrees, heading = arcsin(dx / |xy|) reflected through pi when dy < 0.
NumPy in float64; nothing here imports the program.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

DEG30 = math.radians(30)
MAX_DIST = 30.0          # distance normaliser of the position features
MAX_STEP = 10.0          # hop normaliser of the position features
VIEW_ANGLES = np.stack([(np.arange(36) % 12) * DEG30,
                        (np.arange(36) // 12 - 1) * DEG30], axis=-1)


def rel_pos(a, b):
    """(heading, elevation, distance) from position ``a`` to ``b``."""
    d = np.asarray(b, np.float64) - np.asarray(a, np.float64)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    xy = np.maximum(np.sqrt(dx ** 2 + dy ** 2), 1e-8)
    xyz = np.maximum(np.sqrt(dx ** 2 + dy ** 2 + dz ** 2), 1e-8)
    heading = np.arcsin(np.clip(dx / xy, -1.0, 1.0))
    heading = np.where(dy < 0, np.pi - heading, heading)
    return heading, np.arcsin(np.clip(dz / xyz, -1.0, 1.0)), xyz


def nearest_view(heading, elevation) -> int:
    """The discretized view whose centre lies closest to the direction."""
    dh = np.angle(np.exp(1j * (heading - VIEW_ANGLES[:, 0])))
    de = elevation - VIEW_ANGLES[:, 1]
    return int(np.argmin(dh ** 2 + de ** 2))


def angle_feature(heading, elevation) -> np.ndarray:
    return np.stack([np.sin(heading), np.cos(heading), np.sin(elevation),
                     np.cos(elevation)], axis=-1)


class Scan:
    """One scan: positions [n, 3], a symmetric edge list with Euclidean
    lengths, all-pairs shortest distances and hop counts, and each node's
    candidates (neighbours in index order) with their view geometry."""

    def __init__(self, positions, adjacency):
        self.pos = np.asarray(positions, np.float64)
        self.adj = np.asarray(adjacency, bool)
        n = self.n = len(self.pos)
        diff = self.pos[:, None] - self.pos[None]
        self.edge = np.where(self.adj, np.sqrt((diff ** 2).sum(-1)), np.inf)
        self.dist, self.hops, self.next_hop = shortest_paths(self.edge)
        self.cands = []
        for i in range(n):
            nb = np.flatnonzero(self.adj[i])
            rows = []
            for j in nb:
                h, e, _ = rel_pos(self.pos[i], self.pos[j])
                rows.append((int(j), float(self.edge[i, j]), float(h),
                             float(e), nearest_view(h, e)))
            self.cands.append(rows)

    def path(self, a: int, b: int, allowed=None) -> list[int]:
        """A shortest path a -> b; with ``allowed`` (Dijkstra) only those
        nodes may lie inside the path."""
        if allowed is not None:
            return dijkstra_path(self.edge, a, b, allowed)
        out = [a]
        while out[-1] != b:
            out.append(int(self.next_hop[out[-1], b]))
        return out


def shortest_paths(edge: np.ndarray):
    """All-pairs shortest distances, the hop counts of those paths and the
    first hop of each (Floyd-Warshall)."""
    n = len(edge)
    dist = edge.copy()
    np.fill_diagonal(dist, 0.0)
    hops = np.where(np.isfinite(edge), 1, 0).astype(np.int64)
    np.fill_diagonal(hops, 0)
    nxt = np.where(np.isfinite(edge), np.arange(n)[None, :], -1)
    np.fill_diagonal(nxt, np.arange(n))
    for k in range(n):
        alt = dist[:, k, None] + dist[None, k, :]
        better = alt < dist - 1e-12
        dist = np.where(better, alt, dist)
        hops = np.where(better, hops[:, k, None] + hops[None, k, :], hops)
        nxt = np.where(better, nxt[:, k, None], nxt)
    return dist, hops, nxt


def dijkstra_path(edge: np.ndarray, a: int, b: int, allowed=None):
    """Shortest path by edge length; ``allowed`` (a set) bounds the
    interior nodes.  Returns the node list, or None when unreachable."""
    best = {a: 0.0}
    prev = {}
    heap = [(0.0, a)]
    while heap:
        d, u = heapq.heappop(heap)
        if u == b:
            break
        if d > best.get(u, np.inf) or (u != a and allowed is not None
                                       and u not in allowed):
            continue
        for v in np.flatnonzero(np.isfinite(edge[u])):
            nd = d + edge[u, v]
            if nd < best.get(int(v), np.inf) - 1e-12:
                best[int(v)] = nd
                prev[int(v)] = u
                heapq.heappush(heap, (nd, int(v)))
    if b not in best:
        return None
    out = [b]
    while out[-1] != a:
        out.append(prev[out[-1]])
    return out[::-1]


def observed_paths(scan: Scan, visited: list[int]):
    """Distances and hop counts over what a robot has seen: the edges from
    each visited node to its candidates, with only visited nodes inside a
    path.  Returns (the nodes seen, node -> row, distances, hops)."""
    seen = set(visited)
    for v in visited:
        seen.update(c[0] for c in scan.cands[v])
    nodes = sorted(seen)
    idx = {v: k for k, v in enumerate(nodes)}
    m = len(nodes)
    w = np.full((m, m), np.inf)
    for v in visited:
        for c, d, *_ in scan.cands[v]:
            w[idx[v], idx[c]] = w[idx[c], idx[v]] = d
    dist = w.copy()
    np.fill_diagonal(dist, 0.0)
    hops = np.where(np.isfinite(w), 1, 0)
    np.fill_diagonal(hops, 0)
    for v in dict.fromkeys(visited):
        k = idx[v]
        alt = dist[:, k, None] + dist[None, k, :]
        better = alt < dist - 1e-12
        dist = np.where(better, alt, dist)
        hops = np.where(better, hops[:, k, None] + hops[None, k, :], hops)
    return nodes, idx, dist, hops
