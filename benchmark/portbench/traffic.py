"""The benchmark's one traffic generator: synthetic Matterport-like scans and
R2R-style episodes drawn from a seed and a mix's parameters.

A frozen copy of the port's synthetic world (random geometric graphs in a
building-sized box, a spanning chain for connectivity, CLIP-like view
features) and instruction generator, with its own seeding, so that a later
change to the port's generator changes nothing here.  The program receives
what this makes through its public constructors; the reference reads the
same raw arrays.
"""

from __future__ import annotations

import math

import numpy as np

from reference.world import Scan


class Traffic:
    """The scans and the episode stream of one run.  ``mix``: the traffic
    file's parameters; ``seed``: the run's seed.  The scans and their
    features come from the mix's ``world_seed``, the same for every run, as
    a split's buildings are; the run's seed draws the episodes (start,
    goal, heading, instruction) and their order, so every seed decodes
    work of the same sizes."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed % 2 ** 63
        world = mix["world_seed"]
        rng = np.random.default_rng([world, 0])
        self.scans, self.positions, self.adjacency = [], [], []
        for _ in range(mix["scans"]):
            pos, adj = random_graph(rng, mix["nodes_per_scan"], mix["radius"],
                                    mix["max_candidates"])
            self.positions.append(pos)
            self.adjacency.append(adj)
            self.scans.append(Scan(pos, adj))
        self.features = [
            (np.random.default_rng([world, 1, s]).standard_normal(
                (mix["nodes_per_scan"], 36, mix["feat_dim"]),
                dtype=np.float32) * 0.5)
            for s in range(mix["scans"])]

    def node_id(self, scan: int, v: int) -> str:
        return f"vp{scan}_{v:04d}"

    def episodes(self, stream: int, count: int) -> list[dict]:
        """``count`` episodes of stream ``stream``: a scan, a start and goal
        ``min_path``-``max_path`` hops apart (the shortest path is the
        ground truth), a heading and a full-length instruction."""
        m = self.mix
        rng = np.random.default_rng([self.seed, 2, stream])
        out = []
        for k in range(count):
            si = int(rng.integers(m["scans"]))
            scan = self.scans[si]
            for _ in range(100):
                a, b = (int(x) for x in rng.integers(scan.n, size=2))
                if m["min_path"] <= scan.hops[a, b] <= m["max_path"]:
                    break
            path = scan.path(a, b)
            out.append({
                "instr_id": f"{stream}_{k}",
                "path_id": stream * count + k,
                "scan": f"scan{si:04d}",
                "scan_idx": si,
                "path": [self.node_id(si, v) for v in path],
                "path_idx": np.array(path, dtype=np.int32),
                "heading": float(rng.uniform(0, 2 * math.pi)),
                "instruction": "",
                "instr_encoding": rng.integers(
                    m["token_low"], m["token_high"],
                    m["instr_len"]).astype(np.int32),
            })
        return out


def random_graph(rng: np.random.Generator, num_nodes: int, radius: float,
                 max_degree: int):
    """Nodes in a [0, L]^2 x [0, 3] box, edges between nodes within
    ``radius``, plus a chain over a random order so the scan is connected
    (the port's ``env/synthetic.py`` ``_random_graph``); then, while a
    node has more than ``max_degree`` neighbours, the fullest node's
    longest edge off the chain is dropped, so every seed gives the same
    candidate budget (R2R's 16)."""
    size = np.sqrt(num_nodes) * radius * 0.7
    pos = np.stack([rng.uniform(0, size, num_nodes),
                    rng.uniform(0, size, num_nodes),
                    rng.uniform(0, 3.0, num_nodes)], axis=1).astype(np.float32)
    diff = pos[:, None] - pos[None, :]
    length = np.sqrt((diff ** 2).sum(-1))
    adj = (length < radius) & ~np.eye(num_nodes, dtype=bool)
    order = rng.permutation(num_nodes)
    chain = np.zeros_like(adj)
    for a, b in zip(order[:-1], order[1:]):
        adj[a, b] = adj[b, a] = chain[a, b] = chain[b, a] = True
    degree = adj.sum(1)
    while degree.max() > max_degree:
        i = int(np.argmax(degree))
        j = int(np.argmax(np.where(adj[i] & ~chain[i], length[i], -1.0)))
        adj[i, j] = adj[j, i] = False
        degree[i] -= 1
        degree[j] -= 1
    return pos, adj
