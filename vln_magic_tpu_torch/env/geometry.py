"""Viewpoint geometry: discretized 36-view panorama angles and relative
position features.

All formulas are numerically identical to the reference implementation
(reference: map_nav_src/utils/data.py:127-201, map_nav_src/r2r/env.py:213-247)
so that greedy decodes can be action-identical.  Everything here is pure
numpy executed once at world-build time; the results live in static device
tables afterwards (the TPU-first inversion: geometry is precomputed, not
recomputed per step as in the reference's MatterSim loop).

The panorama is discretized into 36 views: 12 headings x 3 elevations,
30 degrees apart.  View index ``ix``: heading = (ix % 12) * 30deg,
elevation = (ix // 12 - 1) * 30deg  (row 0 looks down, row 1 at the
horizon, row 2 up).
"""

from __future__ import annotations

import math

import numpy as np

DEG30 = math.radians(30)
MAX_DIST = 30.0  # distance normalizer (reference: map_nav_src/r2r/env.py:22)
MAX_STEP = 10.0  # step normalizer (reference: map_nav_src/r2r/env.py:23)
NUM_VIEWS = 36


def view_heading_elevation(view_index: np.ndarray | int):
    """Absolute heading/elevation of the center of a discretized view."""
    view_index = np.asarray(view_index)
    heading = (view_index % 12) * DEG30
    elevation = (view_index // 12 - 1) * DEG30
    return heading, elevation


# (36, 2) [heading, elevation] of every view center.
ALL_VIEW_ANGLES = np.stack(view_heading_elevation(np.arange(NUM_VIEWS)), axis=-1)


def angle_feature(heading, elevation, angle_feat_size: int = 4) -> np.ndarray:
    """[sin h, cos h, sin e, cos e] tiled to ``angle_feat_size``.

    Matches reference map_nav_src/utils/data.py:127-130.
    """
    base = np.stack(
        [np.sin(heading), np.cos(heading), np.sin(elevation), np.cos(elevation)],
        axis=-1,
    ).astype(np.float32)
    reps = angle_feat_size // 4
    if reps > 1:
        base = np.concatenate([base] * reps, axis=-1)
    return base


def get_angle_fts(headings, elevations, angle_feat_size: int = 4) -> np.ndarray:
    """Vectorized angle features for arrays of headings/elevations.

    Matches reference map_nav_src/utils/data.py:176-182.
    """
    return angle_feature(np.asarray(headings), np.asarray(elevations), angle_feat_size)


def get_view_rel_angles(base_view_id: int = 0) -> np.ndarray:
    """(36, 2) heading/elevation of each view relative to ``base_view_id``.

    Matches reference map_nav_src/utils/data.py:184-201.
    """
    base_heading = (base_view_id % 12) * DEG30
    base_elevation = (base_view_id // 12 - 1) * DEG30
    rel = ALL_VIEW_ANGLES.copy()
    rel[:, 0] -= base_heading
    rel[:, 1] -= base_elevation
    return rel.astype(np.float32)


def rel_pos_features(a: np.ndarray, b: np.ndarray, base_heading=0.0, base_elevation=0.0):
    """Relative (heading, elevation, xyz_dist) from position(s) ``a`` to ``b``.

    Vectorized version of reference map_nav_src/utils/data.py:157-174,
    including its transposed-axis quirk: ``heading = arcsin(dx / xy_dist)``
    reflected through pi when ``dy < 0``.

    a, b: (..., 3) arrays; base_heading/base_elevation broadcastable.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = b - a
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    xy = np.maximum(np.sqrt(dx**2 + dy**2), 1e-8)
    xyz = np.maximum(np.sqrt(dx**2 + dy**2 + dz**2), 1e-8)
    heading = np.arcsin(np.clip(dx / xy, -1.0, 1.0))
    heading = np.where(dy < 0, np.pi - heading, heading)
    heading = heading - base_heading
    elevation = np.arcsin(np.clip(dz / xyz, -1.0, 1.0)) - base_elevation
    return heading, elevation, xyz


def nearest_view_index(heading, elevation) -> np.ndarray:
    """Discretized view whose center is angularly closest to (heading, elevation).

    Reproduces MatterSim's visibility assignment used by the reference's
    ``make_candidate`` (map_nav_src/r2r/env.py:249-334): a neighbor visible
    from several views is represented by the view minimizing
    sqrt(rel_heading^2 + rel_elevation^2).
    """
    heading = np.asarray(heading)[..., None]
    elevation = np.asarray(elevation)[..., None]
    vh = ALL_VIEW_ANGLES[:, 0]
    ve = ALL_VIEW_ANGLES[:, 1]
    dh = np.angle(np.exp(1j * (heading - vh)))  # wrap to [-pi, pi]
    de = elevation - ve
    return np.argmin(dh**2 + de**2, axis=-1)


def gmap_pos_features(
    cur_pos: np.ndarray,
    node_pos: np.ndarray,
    shortest_dist: np.ndarray,
    shortest_steps: np.ndarray,
    cur_heading: float,
    cur_elevation: float,
    angle_feat_size: int = 4,
) -> np.ndarray:
    """7-d global-map position features for a set of nodes relative to the
    current node: 4 angle features + [line_dist/30, graph_dist/30, steps/10].

    Matches reference map_nav_src/r2r/env.py:213-235.
    """
    h, e, dist = rel_pos_features(cur_pos, node_pos, cur_heading, cur_elevation)
    ang = get_angle_fts(h, e, angle_feat_size)
    rel = np.stack(
        [dist / MAX_DIST, shortest_dist / MAX_DIST, shortest_steps / MAX_STEP],
        axis=-1,
    ).astype(np.float32)
    return np.concatenate([ang, rel], axis=-1)
