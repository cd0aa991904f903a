"""The navigation world as static padded device tables.

TPU-first inversion of the reference environment stack
(EnvBatch/MatterSim + R2RNavBatch, reference: map_nav_src/r2r/env.py:26-95,
97-449): since rendering is disabled (env.py:51), navigation is *exactly*
graph lookups + precomputed features.  We therefore lower every scan's
connectivity graph, shortest-path structure, candidate ("navigable
location") table, and view features into dense arrays padded to common
shapes and stacked over scans.  Inside ``jit`` an episode step is pure
gathers over these tables — no host round trips, no C++ simulator.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .geometry import ALL_VIEW_ANGLES, nearest_view_index, rel_pos_features
from .graph import INF, NavGraph


@dataclass
class WorldTables:
    """Stacked, padded per-scan tables.  All arrays are numpy on build and are
    moved to device (and optionally sharded) by the consumer.

    Shapes: S = num scans, N = max nodes per scan, C = max candidates per
    node, V = 36 views, D = image feature dim.
    """

    node_mask: np.ndarray       # (S, N) bool — valid node
    positions: np.ndarray       # (S, N, 3) f32
    dist: np.ndarray            # (S, N, N) f32 shortest-path distance
    steps: np.ndarray           # (S, N, N) i32 shortest-path hop count
    next_hop: np.ndarray        # (S, N, N) i32 next node on shortest path
    cand_ids: np.ndarray        # (S, N, C) i32 neighbor node index, -1 pad
    cand_dist: np.ndarray       # (S, N, C) f32 edge length to the neighbor
    cand_view: np.ndarray       # (S, N, C) i32 discretized view of the neighbor
    cand_heading: np.ndarray    # (S, N, C) f32 absolute heading to neighbor
    cand_elevation: np.ndarray  # (S, N, C) f32 absolute elevation to neighbor
    cand_mask: np.ndarray       # (S, N, C) bool
    features: np.ndarray        # (S, N, V, D) view image features

    @property
    def num_scans(self) -> int:
        return self.node_mask.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_mask.shape[1]

    @property
    def max_candidates(self) -> int:
        return self.cand_ids.shape[2]

    @property
    def feat_dim(self) -> int:
        return self.features.shape[3]


def load_scanvp_candidates(path: str) -> dict:
    """Parse the reference's precomputed candidate-view file
    ``scanvp_candview_relangles.json`` (reference parser.py:261; consumed at
    pretrain_src/data/dataset.py:440,458 and agent.py:406-414).

    Schema: ``{"{scan}_{viewpoint}": {cand_viewpoint: [view_idx, angle_dist,
    rel_heading, rel_elevation]}}`` where ``view_idx`` is the discretized
    30-degree view (0..35) the candidate is closest to and rel_heading/
    rel_elevation are offsets from that view's center (dataset.py:463-469:
    ``heading = view_angle[0] + v[2]``)."""
    import json

    with open(path) as f:
        return json.load(f)


# view-center angles of the 36 discretized views (12 headings x 3 elevation
# rows); the center row starts at index 12, so base view 12 has
# heading 0 / elevation 0 (reference env.py:252-253, dataset.py:441-442)
def _view_center_angles(view_idx):
    view_idx = np.asarray(view_idx)
    heading = (view_idx % 12) * np.float32(np.radians(30))
    elevation = (view_idx // 12 - 1) * np.float32(np.radians(30))
    return heading, elevation


class World:
    """Host-side container: per-scan :class:`NavGraph` objects, id maps, and
    the padded :class:`WorldTables`.

    ``feature_fn(scan, node_ids) -> (n, 36, D)`` supplies view features
    (HDF5-backed for real data, deterministic-random for tests; the
    reference's ImageFeaturesDB serves the same role,
    map_nav_src/utils/data.py:28-77).

    ``scanvp_cands``: the parsed ``scanvp_candview_relangles.json`` dict
    (see :func:`load_scanvp_candidates`).  When given, candidate view
    indices and angles come from the file — the reference's MatterSim-
    derived geometry — instead of the nearest-view synthesis; nodes absent
    from the file fall back to synthesis.
    """

    def __init__(self, graphs: list[NavGraph], feature_fn, feat_dim: int,
                 max_candidates: int | None = None, feat_dtype=np.float32,
                 scanvp_cands: dict | None = None):
        self.graphs = graphs
        self.scan_index = {g.scan: i for i, g in enumerate(graphs)}
        self.feat_dim = feat_dim

        s = len(graphs)
        n = max(g.num_nodes for g in graphs)
        cand_counts = [int(g.adjacency.sum(1).max()) for g in graphs]
        if scanvp_cands:
            cand_counts += [len(v) for v in scanvp_cands.values()]
        c = max_candidates or max(cand_counts)
        if max(cand_counts) > c:
            raise ValueError(f"max_candidates={c} < observed degree {max(cand_counts)}")

        node_mask = np.zeros((s, n), dtype=bool)
        positions = np.zeros((s, n, 3), dtype=np.float32)
        dist = np.full((s, n, n), INF, dtype=np.float32)
        steps = np.full((s, n, n), -1, dtype=np.int32)
        next_hop = np.full((s, n, n), -1, dtype=np.int32)
        cand_ids = np.full((s, n, c), -1, dtype=np.int32)
        cand_dist = np.zeros((s, n, c), dtype=np.float32)
        cand_view = np.zeros((s, n, c), dtype=np.int32)
        cand_heading = np.zeros((s, n, c), dtype=np.float32)
        cand_elevation = np.zeros((s, n, c), dtype=np.float32)
        features = np.zeros((s, n, 36, feat_dim), dtype=feat_dtype)

        # the tables stay numpy here; the rollout's Tables.from_world moves
        # them to the caller's device
        for si, g in enumerate(graphs):
            features[si, : g.num_nodes] = (
                feature_fn(g.scan, g.node_ids).astype(feat_dtype))

        for si, g in enumerate(graphs):
            k = g.num_nodes
            node_mask[si, :k] = True
            positions[si, :k] = g.positions
            dist[si, :k, :k] = g.dist
            steps[si, :k, :k] = g.steps
            next_hop[si, :k, :k] = g.next_hop
            for i in range(k):
                key = f"{g.scan}_{g.node_ids[i]}"
                entry = (scanvp_cands or {}).get(key)
                if entry:
                    # precomputed candidates: view indices + angles from the
                    # reference's file (view-center angle + rel offset,
                    # dataset.py:463-469); traversal distance from the graph
                    # edge when present, Euclidean otherwise (MatterSim
                    # navigability can differ slightly from connectivity)
                    ids = [g.index[vp] for vp in entry if vp in g.index]
                    vals = [entry[vp] for vp in entry if vp in g.index]
                    if not ids:
                        continue
                    views = np.asarray([int(v[0]) for v in vals], np.int32)
                    ch, ce = _view_center_angles(views)
                    h = ch + np.asarray([float(v[2]) for v in vals],
                                        np.float32)
                    e = ce + np.asarray([float(v[3]) for v in vals],
                                        np.float32)
                    ed = g.edge_dist[i, ids]
                    euclid = np.sqrt(((g.positions[ids] - g.positions[i])
                                      ** 2).sum(-1)).astype(np.float32)
                    d = np.where(ed < INF, ed, euclid)
                    m = len(ids)
                    cand_ids[si, i, :m] = ids
                    cand_dist[si, i, :m] = d
                    cand_view[si, i, :m] = views
                    cand_heading[si, i, :m] = h
                    cand_elevation[si, i, :m] = e
                    continue
                nbrs = g.neighbors(i)
                if len(nbrs) == 0:
                    continue
                h, e, _ = rel_pos_features(g.positions[i], g.positions[nbrs])
                view = nearest_view_index(h, e)
                m = len(nbrs)
                cand_ids[si, i, :m] = nbrs
                cand_dist[si, i, :m] = g.edge_dist[i, nbrs]
                cand_view[si, i, :m] = view
                cand_heading[si, i, :m] = h
                cand_elevation[si, i, :m] = e

        self.tables = WorldTables(
            node_mask=node_mask, positions=positions, dist=dist, steps=steps,
            next_hop=next_hop, cand_ids=cand_ids, cand_dist=cand_dist,
            cand_view=cand_view,
            cand_heading=cand_heading, cand_elevation=cand_elevation,
            cand_mask=cand_ids >= 0, features=features,
        )

    # ----- host-side convenience (annotation encoding, eval) -----

    def node_index(self, scan: str, viewpoint: str) -> int:
        g = self.graphs[self.scan_index[scan]]
        return g.index[viewpoint]

    def encode_path(self, scan: str, path: list[str]) -> np.ndarray:
        g = self.graphs[self.scan_index[scan]]
        return np.array([g.index[vp] for vp in path], dtype=np.int32)

    def expand_jumps(self, scan_idx: int, node_seq: list[int]) -> list[list[int]]:
        """Expand a sequence of (possibly non-adjacent) nodes into per-action
        shortest-path segments, mirroring the reference trajectory format
        where each action appends graph.path(cur, target)
        (reference: map_nav_src/r2r/agent.py:384)."""
        g = self.graphs[scan_idx]
        out = [[node_seq[0]]]
        for a, b in zip(node_seq[:-1], node_seq[1:]):
            out.append(g.path_indices(a, b)[1:])
        return out
