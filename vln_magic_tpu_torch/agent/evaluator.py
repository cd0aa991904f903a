"""Trajectory building and navigation metrics.

Metric definitions are numerically identical to the reference
(reference: map_nav_src/r2r/env.py:452-520 and eval_utils.py:6-42):
nav_error, oracle_error, SR (<3 m), SPL, oracle SR, nDTW, SDTW, CLS,
lengths/steps.  They run on host numpy over the dense per-scan distance
tables — evaluation cost is negligible next to the rollout.
"""

from __future__ import annotations

import numpy as np

from ..env.world import World

ERROR_MARGIN = 3.0


def build_trajectories(world: World, items, actions, stop_node, final_cur):
    """Assemble reference-format trajectories from device rollout records.

    ``actions``: [T, B] chosen target node per step (-1 = no move);
    ``stop_node``/``final_cur``: [B].  Each action appends the shortest-path
    segment (excluding the current node), then the stop-score backtrack
    segment if the best stop node differs from the final position
    (reference agent.py:375-404, 1080-1095).
    """
    actions = np.asarray(actions)
    stop_node = np.asarray(stop_node)
    final_cur = np.asarray(final_cur)
    T, B = actions.shape
    trajs = []
    for b in range(B):
        item = items[b]
        si = item["scan_idx"]
        g = world.graphs[si]
        cur = int(item["path_idx"][0])
        segments = [[cur]]
        for t in range(T):
            tgt = int(actions[t, b])
            if tgt >= 0 and tgt != cur:
                segments.append(g.path_indices(cur, tgt)[1:])
                cur = tgt
        if int(stop_node[b]) != int(final_cur[b]):
            segments.append(g.path_indices(cur, int(stop_node[b]))[1:])
        trajs.append({
            "instr_id": item["instr_id"],
            "trajectory": [[g.node_ids[i] for i in seg] for seg in segments],
            "trajectory_idx": segments,
            "scan_idx": si,
        })
    return trajs


def build_trajectories_observed(world, items, actions, traj_nodes, traj_len,
                                stop_node, final_cur):
    """Parity-mode trajectory assembly from the device-recorded expanded
    path buffer (observed-subgraph paths).  Segments are recovered by
    splitting the flat buffer at each action's jump target."""
    actions = np.asarray(actions)
    traj_nodes = np.asarray(traj_nodes)
    traj_len = np.asarray(traj_len)
    stop_node = np.asarray(stop_node)
    final_cur = np.asarray(final_cur)
    T, B = actions.shape
    trajs = []
    for b in range(B):
        item = items[b]
        flat = traj_nodes[b, : min(traj_len[b], traj_nodes.shape[1])].tolist()
        targets = [int(actions[t, b]) for t in range(T)
                   if actions[t, b] >= 0]
        if int(stop_node[b]) != int(final_cur[b]):
            targets.append(int(stop_node[b]))
        segments = [[flat[0]]]
        i = 1
        for tgt in targets:
            j = i
            while j < len(flat) and flat[j] != tgt:
                j += 1
            segments.append(flat[i : min(j + 1, len(flat))] or [tgt])
            i = j + 1
        g = world.graphs[item["scan_idx"]]
        trajs.append({
            "instr_id": item["instr_id"],
            "trajectory": [[g.node_ids[k] for k in seg] for seg in segments],
            "trajectory_idx": segments,
            "scan_idx": item["scan_idx"],
        })
    return trajs


def cal_dtw(dist, prediction, reference, success=None, threshold=ERROR_MARGIN):
    """Dynamic-time-warping alignment metrics over node-index paths.

    Same recurrence as reference eval_utils.py:6-26."""
    np_ = len(prediction)
    nr = len(reference)
    m = np.full((np_ + 1, nr + 1), np.inf)
    m[0, 0] = 0.0
    cost = dist[np.ix_(prediction, reference)]
    for i in range(1, np_ + 1):
        for j in range(1, nr + 1):
            m[i, j] = cost[i - 1, j - 1] + min(m[i - 1, j], m[i, j - 1],
                                               m[i - 1, j - 1])
    dtw = m[np_, nr]
    ndtw = float(np.exp(-dtw / (threshold * nr)))
    if success is None:
        success = float(dist[prediction[-1], reference[-1]] < threshold)
    return {"DTW": float(dtw), "nDTW": ndtw, "SDTW": float(success * ndtw)}


def cal_cls(dist, prediction, reference, threshold=ERROR_MARGIN):
    """Coverage-weighted length score (reference eval_utils.py:28-42)."""
    def length(nodes):
        return float(np.sum([dist[a, b] for a, b in zip(nodes[:-1], nodes[1:])]))

    coverage = float(np.mean(
        [np.exp(-np.min([dist[u, v] for v in prediction]) / threshold)
         for u in reference]))
    expected = coverage * length(reference)
    score = expected / (expected + abs(expected - length(prediction))) \
        if expected > 0 else 0.0
    return coverage * score


class Evaluator:
    """Scores predicted trajectories against ground truth paths."""

    def __init__(self, world: World, items):
        self.world = world
        self.gt = {it["instr_id"]: it for it in items if len(it["path_idx"]) > 1}

    def eval_item(self, scan_idx, pred_segments, gt_path):
        g = self.world.graphs[scan_idx]
        dist = g.dist
        path = [n for seg in pred_segments for n in seg]
        assert path[0] == gt_path[0], "trajectory must start at the gt start"
        goal = gt_path[-1]

        nearest = min(path, key=lambda n: dist[n, goal])
        s = {}
        s["nav_error"] = float(dist[path[-1], goal])
        s["oracle_error"] = float(dist[nearest, goal])
        s["action_steps"] = len(pred_segments) - 1
        s["trajectory_steps"] = len(path) - 1
        s["trajectory_lengths"] = float(
            np.sum([dist[a, b] for a, b in zip(path[:-1], path[1:])]))
        gt_len = float(np.sum([dist[a, b] for a, b in zip(gt_path[:-1], gt_path[1:])]))
        s["success"] = float(s["nav_error"] < ERROR_MARGIN)
        s["spl"] = s["success"] * gt_len / max(s["trajectory_lengths"], gt_len, 0.01)
        s["oracle_success"] = float(s["oracle_error"] < ERROR_MARGIN)
        s.update(cal_dtw(dist, path, list(gt_path), s["success"]))
        s["CLS"] = cal_cls(dist, path, list(gt_path))
        return s

    def eval_metrics(self, preds):
        per = {k: [] for k in (
            "nav_error", "oracle_error", "action_steps", "trajectory_steps",
            "trajectory_lengths", "success", "oracle_success", "spl", "nDTW",
            "SDTW", "CLS")}
        instr_ids = []
        for p in preds:
            gt = self.gt[p["instr_id"]]
            s = self.eval_item(p["scan_idx"], p["trajectory_idx"],
                               list(gt["path_idx"]))
            for k in per:
                per[k].append(s[k])
            instr_ids.append(p["instr_id"])
        avg = {
            "action_steps": float(np.mean(per["action_steps"])),
            "steps": float(np.mean(per["trajectory_steps"])),
            "lengths": float(np.mean(per["trajectory_lengths"])),
            "nav_error": float(np.mean(per["nav_error"])),
            "oracle_error": float(np.mean(per["oracle_error"])),
            "sr": float(np.mean(per["success"]) * 100),
            "oracle_sr": float(np.mean(per["oracle_success"]) * 100),
            "spl": float(np.mean(per["spl"]) * 100),
            "nDTW": float(np.mean(per["nDTW"]) * 100),
            "SDTW": float(np.mean(per["SDTW"]) * 100),
            "CLS": float(np.mean(per["CLS"]) * 100),
        }
        per["instr_id"] = instr_ids
        return avg, per


def submission_format(trajs):
    """Leaderboard flattening: one node per sub-list (agent.py:1151-1158)."""
    out = []
    for t in trajs:
        flat = [[vp] for seg in t["trajectory"] for vp in seg]
        out.append({"instr_id": t["instr_id"], "trajectory": flat})
    return out
