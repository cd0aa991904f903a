"""The check that decides ``correct``: what the timed path produced, held
against the plain reference (``benchmark/reference``) once the window has
closed.

Evaluation cells: every trajectory the window decoded must start at its
episode's start, walk graph edges along shortest paths to the nodes it
chose, move only to nodes it had not visited, and end with at most one
backtrack to a visited node (``bad_trajectories``, exact); the evaluator's
metrics and the program's live-step count must equal the reference's own
(``metric_mismatches``, exact up to 1e-4 of float rounding); and a sample
of episodes drawn from the seed, the longest among them, is replayed
through the reference model in f32: at every decision the program was free
to make, the chosen action's logit may lie below the reference's best by
at most the cell's limit (``logit_gap``).

Serving cells: every decision of the sessions finished in the window must
plan a walk over graph edges through visited nodes to an unvisited target,
and report a latency (``NavDecision.latency_ms``) within the round the
benchmark timed around it (``bad_decisions``, exact); a sample of sessions
is replayed with the map's distances over what the robot had observed
(``logit_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import metrics as ref_metrics
from reference.replay import (STOP, UNOFFERED, argmax_choices, gaps,
                              replay)


def _walk_ok(scan, a: int, hops: list[int], allowed=None) -> bool:
    """``hops`` is a shortest walk from ``a`` over edges (interior nodes
    within ``allowed`` when given)."""
    nodes = [a] + hops
    if not all(scan.adj[x, y] for x, y in zip(nodes[:-1], nodes[1:])):
        return False
    if allowed is not None and not set(nodes[1:-1]) <= allowed:
        return False
    length = sum(scan.edge[x, y] for x, y in zip(nodes[:-1], nodes[1:]))
    if allowed is not None:
        return True
    return abs(length - scan.dist[a, hops[-1]]) <= 1e-4 * max(1.0, length)


class EvalRecord:
    """What the window's waves returned, and their structural check."""

    def __init__(self, traffic, mix):
        self.traffic, self.mix = traffic, mix
        self.episodes = []          # (item, decisions)
        self.bad = 0
        self.mismatches = 0
        self.waves = []

    def add(self, items, avg, per_item, preds):
        self.waves.append((items, avg, per_item, preds))

    def finalize(self):
        """Read every wave's decisions (after the window, so the check
        costs the window nothing)."""
        for items, avg, _, preds in self.waves:
            steps = 0
            for item, pred in zip(items, preds):
                dec = self._decisions(item, pred)
                self.episodes.append((item, dec))
                steps += len(dec)
            self.mismatches += steps != int(avg["semantic_steps"])

    def _decisions(self, item, pred) -> list:
        """The program's choice at each step (a node, then ``STOP``), read
        from its trajectory; a malformed trajectory counts as bad."""
        scan = self.traffic.scans[item["scan_idx"]]
        segs = [list(map(int, s)) for s in pred["trajectory_idx"]]
        start = int(item["path_idx"][0])
        ok = segs[0] == [start] and pred["instr_id"] == item["instr_id"]
        visited, cur, moves = [start], start, []
        for k, seg in enumerate(segs[1:], 1):
            if not seg or not _walk_ok(scan, cur, seg):
                ok = False
                break
            if seg[-1] in visited:          # the stop-score backtrack
                ok = ok and k == len(segs) - 1
            else:
                moves.append(seg[-1])
                visited.append(seg[-1])
            cur = seg[-1]
        ok = ok and len(moves) <= self.mix["max_action_len"] - 1
        self.bad += not ok
        return moves + [STOP]

    def live_steps(self) -> int:
        return sum(len(d) for _, d in self.episodes)

    def counts(self, rng) -> dict:
        """The exact numbers: bad trajectories, and mismatches of the live
        steps and of the evaluator's metrics of ``check_waves`` waves drawn
        with ``rng``."""
        waves = rng.choice(len(self.waves), min(self.mix["check_waves"],
                                                len(self.waves)),
                           replace=False)
        self.check_metrics(sorted(waves))
        return {"bad_trajectories": self.bad,
                "metric_mismatches": self.mismatches}

    def check_metrics(self, sample_waves: list[int]):
        """The evaluator's per-episode metrics of the waves named, and each
        wave's averages, against the reference evaluator."""
        for w in sample_waves:
            items, avg, per_item, preds = self.waves[w]
            mine = [ref_metrics.episode(
                self.traffic.scans[it["scan_idx"]],
                [n for s in p["trajectory_idx"] for n in s],
                list(map(int, it["path_idx"])))
                for it, p in zip(items, preds)]
            for key, theirs in ref_metrics.PER_ITEM.items():
                for m, value in zip(mine, per_item[theirs]):
                    self.mismatches += not _close(m[key], value)
            for key, value in ref_metrics.average(mine).items():
                self.mismatches += not _close(value, avg[key])

    def sample(self, rng, count: int, longest: int):
        order = sorted(range(len(self.episodes)),
                       key=lambda i: -len(self.episodes[i][1]))
        picked = order[:longest]
        rest = order[longest:]
        picked += list(rng.choice(rest, min(count - longest, len(rest)),
                                  replace=False))
        return [self.episodes[i] for i in picked]


class ServeRecord:
    """The sessions finished in the window, and their structural check."""

    def __init__(self, traffic, mix):
        self.traffic, self.mix = traffic, mix
        self.episodes = []
        self.bad = 0
        self.robots = []

    def add(self, robot):
        self.robots.append(robot)

    def finalize(self):
        for robot in self.robots:
            self._check(robot)

    def _check(self, robot):
        item = robot["item"]
        scan = self.traffic.scans[item["scan_idx"]]
        node = lambda name: int(name.split("_")[1])
        cur = int(item["path_idx"][0])
        visited, dec, ok = {cur}, [], True
        for k, (stop, target, path, timed) in enumerate(robot["decisions"]):
            ok = ok and timed
            if stop:
                ok = ok and k == len(robot["decisions"]) - 1
                dec.append(STOP)
                break
            hops = [node(p) for p in path]
            tgt = node(target)
            ok = (ok and bool(hops) and hops[-1] == tgt
                  and tgt not in visited and _walk_ok(scan, cur, hops,
                                                      visited))
            if not ok:
                break
            dec.append(tgt)
            visited.add(tgt)
            cur = tgt
        ok = ok and dec and dec[-1] == STOP and len(dec) <= self.mix[
            "max_action_len"]
        self.bad += not ok
        self.episodes.append((item, dec))

    sample = EvalRecord.sample

    def counts(self, rng) -> dict:
        return {"bad_decisions": self.bad}


def _close(a, b) -> bool:
    return abs(float(a) - float(b)) <= 1e-4 * max(1.0, abs(float(a)))


def reference_gaps(record, cfg: dict, ref, host_weights: dict, inputs: dict,
                   mix: dict, seed: int, device,
                   control: bool = False) -> dict:
    """Replay the seed's sample of episodes through the f32 reference (the
    configuration's module ``ref``, handed the same weights and fixed
    ``inputs`` as the program): the widest and the mean gap, over the
    decisions replayed, of the program's choices below the reference's
    best; with ``control``, under ``"control"``, the same numbers of the
    fp8 reference's own choice at each of those decisions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = {k: torch.as_tensor(v, device=device)
               for k, v in host_weights.items()}
    model = ref.Navigator(cfg["model"], weights, inputs=inputs)
    low = (ref.Navigator(cfg["model"], weights, "fp8", inputs=inputs)
           if control else None)
    rng = np.random.default_rng([seed, 3])
    graph = "full" if mix["kind"] == "eval" else "observed"
    feats = {}
    prog, ctrl, decisions = [], [], 0
    with torch.no_grad():
        for item, dec in record.sample(rng, mix["check_episodes"],
                                       mix["check_longest"]):
            s = item["scan_idx"]
            if s not in feats:
                feats[s] = torch.as_tensor(record.traffic.features[s],
                                           device=device)
            args = (record.traffic.scans[s], feats[s],
                    item["instr_encoding"], int(item["path_idx"][0]),
                    item["heading"], dec, graph, mix["max_action_len"],
                    mix["max_gmap_len"])
            recs = replay(model, *args)
            prog += gaps(recs)
            decisions += len(recs)
            if control:
                ctrl += gaps(recs, argmax_choices(replay(low, *args)))
    out = _gap_numbers(prog)
    out["replayed_decisions"] = decisions
    if control:
        out["control"] = _gap_numbers(ctrl)
    return out


def _gap_numbers(gap_list) -> dict:
    # a window with nothing to replay passes nothing
    return {"logit_gap": max(gap_list, default=UNOFFERED),
            "mean_logit_gap": (float(np.mean(gap_list)) if gap_list
                               else UNOFFERED)}


def judge(numbers: dict, limits: dict):
    """``correct`` and each compared number beside its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
