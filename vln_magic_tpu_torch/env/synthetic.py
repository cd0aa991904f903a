"""Synthetic Matterport-like worlds for tests and benchmarks.

The reference has no test fakes (SURVEY.md §4); this generator is the
framework's canonical fake backend: random geometric connectivity graphs with
MatterSim-compatible geometry plus deterministic pseudo-random CLIP-like view
features, so every layer (env, models, rollout, eval) runs without datasets.
"""

from __future__ import annotations

import numpy as np

from .graph import INF, NavGraph
from .world import World


def _random_graph(rng: np.random.Generator, num_nodes: int, radius: float) -> tuple[np.ndarray, np.ndarray]:
    """Connected random geometric graph: nodes in a ~[0, L]^2 x [0, 3] box,
    edges between nodes within ``radius``, plus a spanning chain to guarantee
    connectivity (mirrors building floors: mostly planar, small z spread)."""
    size = np.sqrt(num_nodes) * radius * 0.7
    pos = np.stack([
        rng.uniform(0, size, num_nodes),
        rng.uniform(0, size, num_nodes),
        rng.uniform(0, 3.0, num_nodes),
    ], axis=1).astype(np.float32)
    diff = pos[:, None] - pos[None, :]
    euclid = np.sqrt((diff**2).sum(-1))
    adj = (euclid < radius) & ~np.eye(num_nodes, dtype=bool)
    # spanning chain over a random order for connectivity
    order = rng.permutation(num_nodes)
    for a, b in zip(order[:-1], order[1:]):
        adj[a, b] = adj[b, a] = True
    return pos, adj


def _stable_hash(*parts) -> int:
    """Process-stable hash (python's hash() is PYTHONHASHSEED-randomized)."""
    import zlib

    return zlib.crc32("|".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


def _feature_fn(feat_dim: int, seed: int):
    def fn(scan: str, node_ids: list[str]) -> np.ndarray:
        # stable per-scan features: same scan always produces the same tensor
        r = np.random.default_rng(_stable_hash(scan, seed))
        return r.standard_normal((len(node_ids), 36, feat_dim)).astype(np.float32) * 0.5
    return fn


def make_synthetic_world(
    num_scans: int = 2,
    nodes_per_scan: int = 24,
    feat_dim: int = 768,
    seed: int = 0,
    radius: float = 2.5,
    max_candidates: int | None = None,
    feat_dtype=np.float32,
) -> World:
    rng = np.random.default_rng(seed)
    graphs = []
    for s in range(num_scans):
        n = nodes_per_scan
        pos, adj = _random_graph(rng, n, radius)
        diff = pos[:, None] - pos[None, :]
        euclid = np.sqrt((diff**2).sum(-1)).astype(np.float32)
        edge_dist = np.where(adj, euclid, INF)
        node_ids = [f"vp{s}_{i:04d}" for i in range(n)]
        graphs.append(NavGraph(f"scan{s:04d}", node_ids, pos, adj, edge_dist))
    return World(graphs, _feature_fn(feat_dim, seed), feat_dim,
                 max_candidates=max_candidates, feat_dtype=feat_dtype)


def make_synthetic_instructions(
    world: World,
    num_items: int,
    rng: np.random.Generator,
    vocab_size: int = 1000,
    min_len: int = 8,
    max_len: int = 40,
    min_path: int = 3,
    max_path: int = 7,
):
    """Synthetic R2R-style annotation items with shortest-path ground truth."""
    items = []
    for k in range(num_items):
        si = int(rng.integers(world.tables.num_scans))
        g = world.graphs[si]
        for _ in range(100):
            a, b = rng.integers(g.num_nodes, size=2)
            steps = g.steps[a, b]
            if min_path <= steps <= max_path:
                break
        path = g.path_indices(int(a), int(b))
        L = int(rng.integers(min_len, max_len))
        # pseudo-instruction text with direction + landmark words so the
        # backdoor z-dict / speaker paths are exercisable without real
        # annotations (the word classes match agent/interventions.py)
        directions = ("forward", "left", "right", "around", "straight",
                      "through", "past", "into")
        landmarks = ("table", "door", "stairs", "kitchen", "sofa", "window",
                     "hallway", "lamp")
        fillers = ("walk", "then", "turn", "go", "the", "toward", "at")
        words = [str(rng.choice(fillers)) if j % 3 == 0
                 else str(rng.choice(directions)) if j % 3 == 1
                 else str(rng.choice(landmarks))
                 for j in range(max(min(L // 3, 12), 4))]
        items.append({
            "instr_id": f"{k}_0",
            "path_id": k,
            "scan": g.scan,
            "scan_idx": si,
            "path": [g.node_ids[i] for i in path],
            "path_idx": np.array(path, dtype=np.int32),
            "heading": float(rng.uniform(0, 2 * np.pi)),
            "instruction": " ".join(words),
            "instr_encoding": np.concatenate(
                [[0], rng.integers(4, vocab_size, L), [2]]
            ).astype(np.int32),
        })
    return items


def make_synthetic_reverie_items(world, num_items, rng, obj_store, **kw):
    """REVERIE-style items: positive viewpoint sets + a target object id at
    the endpoint (reference ReverieTextPathData expectations: ``pos_vps``
    per item, ``objId`` recoverable from ``instr_id`` =
    pathId_objId_instrId, pretrain_src/data/dataset.py:203,307-319).  The
    target object is drawn from ``obj_store`` at the endpoint so object
    grounding has real labels; ~10% of items reference an absent object
    (the reference's -100 ignore path)."""
    items = make_synthetic_instructions(world, num_items, rng, **kw)
    t = world.tables
    for k, it in enumerate(items):
        si = it["scan_idx"]
        g = world.graphs[si]
        end = int(it["path_idx"][-1])
        near = np.flatnonzero(np.asarray(t.node_mask[si])
                              & (np.asarray(t.dist[si, end]) < 3.0))
        it["pos_vps_idx"] = [end] + [int(n) for n in near if n != end][:2]
        _, attrs = obj_store.get(g.scan, g.node_ids[end])
        ids = attrs["obj_ids"]
        if len(ids) and rng.random() < 0.9:
            objid = str(ids[int(rng.integers(len(ids)))])
        else:
            objid = "absent"
        it["objId"] = objid
        it["instr_id"] = f"{it['path_id']}_{objid}_{k}"
    return items
