"""R2R's navigation metrics, computed from a trajectory and the scan's own
shortest distances (``map_nav_src/r2r/env.py:452-520``,
``map_nav_src/utils/eval_utils.py:6-42``): navigation and oracle error,
success within 3 m, SPL, nDTW, SDTW and CLS.  Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np

MARGIN = 3.0
# this module's per-episode key -> the evaluator's per-item key
PER_ITEM = {"nav_error": "nav_error", "oracle_error": "oracle_error",
            "success": "success", "spl": "spl", "ndtw": "nDTW",
            "sdtw": "SDTW", "cls": "CLS", "length": "trajectory_lengths",
            "steps": "trajectory_steps"}


def episode(scan, path: list[int], gt: list[int]) -> dict:
    d = scan.dist
    goal = gt[-1]
    walk = lambda nodes: float(sum(d[a, b] for a, b in zip(nodes[:-1],
                                                           nodes[1:])))
    length, gt_length = walk(path), walk(gt)
    out = {"nav_error": float(d[path[-1], goal]),
           "oracle_error": float(min(d[n, goal] for n in path)),
           "length": length, "steps": len(path) - 1}
    out["success"] = float(out["nav_error"] < MARGIN)
    out["spl"] = out["success"] * gt_length / max(length, gt_length, 0.01)
    cost = d[np.ix_(path, gt)]
    dtw = np.full((len(path) + 1, len(gt) + 1), np.inf)
    dtw[0, 0] = 0.0
    for i in range(1, len(path) + 1):
        for j in range(1, len(gt) + 1):
            dtw[i, j] = cost[i - 1, j - 1] + min(dtw[i - 1, j], dtw[i, j - 1],
                                                 dtw[i - 1, j - 1])
    out["ndtw"] = float(np.exp(-dtw[-1, -1] / (MARGIN * len(gt))))
    out["sdtw"] = out["success"] * out["ndtw"]
    coverage = float(np.mean([np.exp(-min(d[u, v] for v in path) / MARGIN)
                              for u in gt]))
    expected = coverage * gt_length
    score = (expected / (expected + abs(expected - length))
             if expected > 0 else 0.0)
    out["cls"] = coverage * score
    return out


def average(per: list[dict]) -> dict:
    """The split's averages, named as the evaluator reports them."""
    mean = lambda k: float(np.mean([p[k] for p in per]))
    return {"nav_error": mean("nav_error"), "oracle_error": mean(
        "oracle_error"), "sr": mean("success") * 100,
        "oracle_sr": float(np.mean([p["oracle_error"] < MARGIN
                                    for p in per])) * 100,
        "spl": mean("spl") * 100, "nDTW": mean("ndtw") * 100,
        "SDTW": mean("sdtw") * 100, "CLS": mean("cls") * 100,
        "lengths": mean("length"), "steps": mean("steps")}
