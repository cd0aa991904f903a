"""Replay of one navigation episode through the reference model.

Given what the program was handed (a scan's raw positions and edges, the
view features, an instruction, a start node and heading) and what it
decided at each step (a map node to move to, or stop), the replay rebuilds
the topological map that DUET's rollout keeps (visited nodes, the frontier
in order of first observation, each node's averaged embedding, the step
ids, [MEM]) from the reference's own forward (the map's [MEM] token is
masked out of the global branch, so the map here holds [STOP] and the
nodes; the panorama's [MEM] token is attended), and scores every decision
point with the reference: the action logits over the stop token and the
unvisited map nodes, the global and local scores fused as in
``map_nav_src/models/vilmodel.py`` (``GlocalTextPathNavCMT``).

``graph``: ``"full"`` reads distances and hops over the whole scan (the
evaluation loop); ``"observed"`` over what the robot has seen, with only
visited nodes inside a path (a robot served online).  Nothing here imports
the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .world import MAX_DIST, MAX_STEP, VIEW_ANGLES, Scan, angle_feature, \
    observed_paths, rel_pos

STOP = "stop"
UNOFFERED = 1e9         # the gap of an action the reference does not offer


def pos7(a, b, dist, hops, heading, elevation):
    """Angle features of b seen from a at the agent's pose, then the
    straight and graph distances over 30 and the hops over 10."""
    h, e, line = rel_pos(a, b)
    return np.concatenate([angle_feature(h - heading, e - elevation),
                           [line / MAX_DIST, dist / MAX_DIST,
                            hops / MAX_STEP]])


class Episode:
    """The map state of one episode, advanced by the program's decisions."""

    def __init__(self, scan: Scan, start: int, heading: float, graph: str,
                 max_gmap: int, hidden: int, device):
        self.scan, self.graph, self.max_gmap = scan, graph, max_gmap
        self.cur, self.start = start, start
        self.heading, self.elevation = float(np.float32(heading)), 0.0
        self.visited = [start]
        self.order: dict[int, int] = {}
        self.step_id = {start: 1}
        self.emb_sum: dict[int, torch.Tensor] = {}
        self.emb_cnt: dict[int, float] = {}
        self.mem = torch.zeros(hidden, device=device)
        self.observe()

    def observe(self):
        for v in [self.cur] + [c[0] for c in self.scan.cands[self.cur]]:
            self.order.setdefault(v, len(self.order))

    def paths(self):
        """(distance, hops) functions over the scan or the observed map."""
        if self.graph == "full":
            s = self.scan
            return (lambda i, j: s.dist[i, j]), (lambda i, j: s.hops[i, j])
        _, idx, d, h = observed_paths(self.scan, self.visited)
        return (lambda i, j: d[idx[i], idx[j]]), (lambda i, j: h[idx[i],
                                                                 idx[j]])

    def tokens(self) -> list[int]:
        """The map's node tokens: visited, then frontier, each in order of
        first observation, cut to the token budget."""
        vis = set(self.visited)
        nodes = sorted(self.order, key=lambda v: (v not in vis,
                                                  self.order[v]))
        return nodes[:self.max_gmap - 2]

    def move(self, target: int):
        """Walk a shortest path to ``target`` and face along its last
        edge."""
        if self.graph == "full":
            path = self.scan.path(self.cur, target)
        else:
            path = self.scan.path(self.cur, target, set(self.visited))
        prev = path[-2]
        view = next(c[4] for c in self.scan.cands[prev] if c[0] == target)
        self.heading = (view % 12) * (math.pi / 6)
        self.elevation = (view // 12 - 1) * (math.pi / 6)
        self.cur = target
        self.visited.append(target)
        self.observe()


def replay(model, scan: Scan, feats: torch.Tensor, instr, start: int,
           heading: float, decisions: list, graph: str, max_steps: int,
           max_gmap: int) -> list[dict]:
    """Score each decision of one episode.  ``decisions``: a map node per
    step the program moved, then ``STOP`` where it stopped (or was stopped);
    ``feats`` [n, 36, D] on the model's device.  Returns one record per
    step: the logits by action (``STOP`` or a node), whether the program's
    choice was forced on it (the last step, or no unvisited node left),
    and the program's choice."""
    dev = feats.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    hidden = model.cfg["hidden_size"]
    txt = model.language(torch.as_tensor(np.asarray(instr), device=dev,
                                         dtype=torch.long))
    ep = Episode(scan, start, heading, graph, max_gmap, hidden, dev)
    out = []
    for t, choice in enumerate(decisions):
        ep.step_id[ep.cur] = t + 1
        cands = scan.cands[ep.cur]
        used = {c[4] for c in cands}
        views = [v for v in range(36) if v not in used]
        fv = feats[ep.cur]
        img = torch.cat([fv[[c[4] for c in cands]], fv[views]])
        ang = np.concatenate([
            angle_feature(np.float32([c[2] for c in cands]) - ep.heading,
                          np.float32([c[3] for c in cands]) - ep.elevation),
            angle_feature(VIEW_ANGLES[views, 0] - ep.heading,
                          VIEW_ANGLES[views, 1] - ep.elevation)])
        loc = np.concatenate([ang, np.ones((len(ang), 3))], axis=1)
        nav_type = torch.tensor([1] * len(cands) + [0] * len(views),
                                device=dev)
        pano, fused = model.panorama(img, f32(loc), nav_type)

        ep.emb_sum[ep.cur], ep.emb_cnt[ep.cur] = fused, 1.0
        vis = set(ep.visited)
        for k, c in enumerate(cands):
            if c[0] not in vis:
                ep.emb_sum[c[0]] = ep.emb_sum.get(c[0], 0.0) + pano[k]
                ep.emb_cnt[c[0]] = ep.emb_cnt.get(c[0], 0.0) + 1.0

        dist, hops = ep.paths()
        pos = scan.pos
        nodes = ep.tokens()
        null7 = np.concatenate([angle_feature(0.0, 0.0), np.zeros(3)])
        gmap_pos = [null7] + [
            pos7(pos[ep.cur], pos[v], dist(ep.cur, v), hops(ep.cur, v),
                 ep.heading, ep.elevation) for v in nodes]
        pair = np.zeros((len(nodes) + 1,) * 2)
        pair[1:, 1:] = [[dist(a, b) for b in nodes] for a in nodes]
        zero = torch.zeros(hidden, device=dev)
        gmap_img = torch.stack([zero] + [
            ep.emb_sum[v] / max(ep.emb_cnt[v], 1.0) for v in nodes])
        gmap_step = torch.tensor([0] + [ep.step_id.get(v, 0)
                                           for v in nodes], device=dev)
        start7 = pos7(pos[ep.cur], pos[ep.start], dist(ep.cur, ep.start),
                      hops(ep.cur, ep.start), ep.heading, ep.elevation)
        vp_pos = np.zeros((len(cands) + len(views) + 2, 14))
        vp_pos[:, :7] = start7
        for k, c in enumerate(cands):
            vp_pos[2 + k, 7:] = pos7(pos[ep.cur], pos[c[0]],
                                     dist(ep.cur, c[0]), hops(ep.cur, c[0]),
                                     ep.heading, ep.elevation)
        vp_img = torch.cat([torch.stack([zero, ep.mem]), pano])
        g, v, gate, cls = model.navigation(
            txt, gmap_img, gmap_step, f32(np.stack(gmap_pos)), f32(pair),
            vp_img, f32(vp_pos))
        g, v = (g * gate).double().cpu(), (v * (1 - gate)).double().cpu()

        slot = {c[0]: 2 + k for k, c in enumerate(cands)}
        back = sum(float(v[2 + k]) for k, c in enumerate(cands)
                   if c[0] in vis)
        logits = {STOP: float(g[0] + v[0])}
        for k, node in enumerate(nodes):
            if node not in vis:
                logits[node] = float(g[1 + k]) + (
                    float(v[slot[node]]) if node in slot else back)
        forced = t == max_steps - 1 or all(n in vis for n in ep.order)
        out.append({"logits": logits, "forced": forced, "choice": choice})
        ep.mem = cls
        if choice == STOP:
            break
        if choice not in logits:
            break           # the program moved where no action leads
        ep.move(choice)
    return out


def gaps(records: list[dict], choices=None) -> list[float]:
    """Per decision that was not forced: how far the chosen action's logit
    lies below the best (``choices``: another decoder's choice per record,
    else the program's); an action the reference does not offer reads
    ``UNOFFERED``."""
    out = []
    for k, r in enumerate(records):
        if r["forced"]:
            continue
        choice = r["choice"] if choices is None else choices[k]
        lg = r["logits"]
        out.append(max(lg.values()) - lg[choice] if choice in lg
                   else UNOFFERED)
    return out


def argmax_choices(records: list[dict]) -> list:
    """The action a decoder reading these logits would take at each step
    (the first best, stop first)."""
    return [max(r["logits"], key=r["logits"].get) for r in records]
