"""Torch mirrors of :mod:`vln_magic_tpu_torch.env.geometry` for the rollout
(port of ``vln_magic_tpu/agent/geometry_jax.py``; same formulas)."""

from __future__ import annotations

import functools
import math

import torch

from ..env.geometry import ALL_VIEW_ANGLES, MAX_DIST, MAX_STEP


def angle_feature(heading, elevation, angle_feat_size: int = 4):
    base = torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)
    reps = angle_feat_size // 4
    if reps > 1:
        base = torch.cat([base] * reps, dim=-1)
    return base


def _sqrt(x):
    """Correctly rounded f32 square root.  PyTorch's vectorized CPU sqrt
    can be one ulp off, and arcsin near +-1 magnifies that into 1e-5 of
    heading; rounding the f64 root matches the reference exactly."""
    return torch.sqrt(x.double()).to(x.dtype)


def rel_pos(a, b, base_heading=0.0, base_elevation=0.0):
    """(heading, elevation, dist) from a to b; broadcasts over leading dims
    (the simulator's transposed-axis arcsin convention)."""
    d = b - a
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    xy = _sqrt(dx ** 2 + dy ** 2).clamp(min=1e-8)
    xyz = _sqrt(dx ** 2 + dy ** 2 + dz ** 2).clamp(min=1e-8)
    heading = torch.arcsin((dx / xy).clamp(-1.0, 1.0))
    heading = torch.where(dy < 0, math.pi - heading, heading)
    elevation = torch.arcsin((dz / xyz).clamp(-1.0, 1.0))
    return heading - base_heading, elevation - base_elevation, xyz


def pos_features_7(cur_pos, node_pos, graph_dist, graph_steps, cur_heading,
                   cur_elevation, angle_feat_size: int = 4):
    """7-d position features: angle 4 + [line/30, graph/30, steps/10]."""
    h, e, dist = rel_pos(cur_pos, node_pos, cur_heading[..., None],
                         cur_elevation[..., None])
    ang = angle_feature(h, e, angle_feat_size)
    rel = torch.stack([dist / MAX_DIST, graph_dist / MAX_DIST,
                       graph_steps / MAX_STEP], dim=-1)
    return torch.cat([ang, rel], dim=-1)


@functools.lru_cache(maxsize=None)
def _view_angles(device: torch.device) -> torch.Tensor:
    """The 36 view-center angles on ``device``, copied there once: a step
    then makes no host-to-device copy of them."""
    return torch.as_tensor(ALL_VIEW_ANGLES, dtype=torch.float32,
                           device=device)


def view_angles_relative(base_heading, base_elevation):
    """(B, 36, 2) view-center angles relative to the agent's base view."""
    return _view_angles(base_heading.device)[None] - torch.stack(
        [base_heading, base_elevation], dim=-1)[:, None, :]
