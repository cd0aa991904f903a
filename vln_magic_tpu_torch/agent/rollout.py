"""Batched navigation rollout over padded world tables.

Port of ``vln_magic_tpu/agent/rollout.py``: the episode state (current
node, orientation, and the topological map: visited/observed sets,
observation order, averaged node embeddings, stop scores) is a set of
padded tensors, and the time loop runs all ``max_action_len`` steps,
masking episodes that have ended, as the reference's ``lax.scan`` does.

Two loops share the step's parts.  Evaluation (``Rollout.run`` with the
defaults) decodes without autograd and updates the state in place; one
step is ``Rollout.step``, which takes per-lane step clocks, so the wave loop
and the streaming decoder (``agent/streaming.py``) share it.  Training
(``Rollout.run`` with ``train_ml``, ``distill`` or ``deterministic=False``)
runs the student and, for distillation, the teacher in the same step, and
accumulates the imitation (CE) and MAKD losses.  Its step copies the state
fields it writes before writing them, so autograd, which carries gradients
from step to step through the node embeddings and [MEM], never sees a saved
tensor change, and ``torch.utils.checkpoint`` can recompute a step from an
input nothing has mutated since.  Draws (dropout, sampled actions, MKRW)
come from a ``torch.Generator`` made per step from the run's seed.  On a
mesh (``parallel``, an active region) each rank runs its dp rows: draws
are made at the global batch and cut to the rank's rows, and the MAKD
gate reads every rank's live lanes.

Both loops take each role's intervention dictionaries (``zdicts``,
``agent.interventions.build_rollout_zdicts``), broadcast over the batch
into the language, panorama and navigation modes, and ``ensemble_n`` > 1
(MC dropout: each mode averaged over n dropout draws, the panorama's before
the navigation reads it).

Two graph-information modes, as in the reference: the default reads
gmap distances and paths from the full-graph tables; with
``EnvConfig.observed_graph_parity`` they come from the incrementally observed
subgraph (``relax_observed``: visited-pivot all-pairs distances, walks through
visited nodes only), and the expanded trajectory is recorded on the device.

Token layouts match the reference:
  gmap tokens: [stop], [mem], visited (observation order), frontier (obs order)
  vp tokens:   [stop], [mem], candidates..., remaining views...

Where the JAX code contracts one-hot matrices to gather on the TPU, this
port indexes exactly (``gather``, advanced indexing, ``scatter_reduce_``);
rows the reference zeroes through a one-hot of an invalid index are zeroed
with ``where``.  Scatters that must not touch a real node go to a trash slot
at index N.  The state is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from types import SimpleNamespace

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import EnvConfig, ModelConfig
from ..env.world import WorldTables
from ..ops import walk
from ..ops.walk import INF_DIST
from ..parallel.mesh import dp_any, draw_uniform
from ..utils.device import resolve_device
from ..utils.profiling import span
from . import distill as D
from . import geometry as geo
from . import losses as L
from .interventions import zdicts_on

BIG = 1_000_000       # obs-order offset separating frontier from visited
UNOBS = 2_000_000     # obs-order value for unobserved nodes
NEG_INF = -1e9
MAX_TRAJ = 96         # expanded-trajectory buffer (steps x jump hops)
WALK_HOPS = 32        # next-hop walk bound (>= any scan diameter)


@dataclass
class Tables:
    """``WorldTables`` as tensors on one device (indices as int64)."""

    node_mask: torch.Tensor
    positions: torch.Tensor
    dist: torch.Tensor
    steps: torch.Tensor
    next_hop: torch.Tensor
    cand_ids: torch.Tensor
    cand_dist: torch.Tensor
    cand_view: torch.Tensor
    cand_heading: torch.Tensor
    cand_elevation: torch.Tensor
    cand_mask: torch.Tensor
    features: torch.Tensor
    # the EnvEdit feature table, in ``features``' layout, that aug-marked
    # episodes read (JAX ``Tables.aug_features``); None without one
    aug_features: torch.Tensor | None = None

    @classmethod
    def from_world(cls, t: WorldTables, device="cuda",
                   aug_features=None) -> "Tables":
        """``t`` on ``device``; ``aug_features``: an [S, N, 36, D] table
        (``cli.main_nav.build_aug_table``), else None."""
        device = resolve_device(device)

        def conv(a):
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":      # ml_dtypes (--feat_dtype)
                return torch.from_numpy(a.view(np.int16)).to(device).view(
                    torch.bfloat16)
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.int64)
            return torch.from_numpy(a).to(device)

        return cls(**{f.name: conv(getattr(t, f.name))
                      for f in dataclasses.fields(cls)
                      if f.name != "aug_features"},
                   aug_features=(None if aug_features is None
                                 else conv(aug_features)))

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[1]


@dataclass
class EpisodeBatch:
    """Batched episode + topological-map state.  N = max nodes per scan,
    plus one trash slot for masked scatters."""

    scan: torch.Tensor          # [B] i64
    cur: torch.Tensor           # [B] i64
    heading: torch.Tensor       # [B] f32
    elevation: torch.Tensor     # [B] f32
    start: torch.Tensor         # [B] i64
    goal: torch.Tensor          # [B] i64
    gt_path: torch.Tensor       # [B, TG] i64, -1 padded
    gt_len: torch.Tensor        # [B] i64
    visited: torch.Tensor       # [B, N+1] bool
    obs_order: torch.Tensor     # [B, N+1] i64 (UNOBS if unobserved)
    obs_count: torch.Tensor     # [B] i64
    step_ids: torch.Tensor      # [B, N+1] i64
    stop_scores: torch.Tensor   # [B, N+1] f32
    embed_sum: torch.Tensor     # [B, N+1, D] f32
    embed_cnt: torch.Tensor     # [B, N+1] f32
    mem: torch.Tensor           # [B, D] f32 ([MEM] recurrence, cls_embeds)
    traj_nodes: torch.Tensor    # [B, MAX_TRAJ+1] i64 expanded trajectory (-1 pad)
    traj_len: torch.Tensor      # [B] i64
    # observed-subgraph all-pairs distances / hops (parity mode);
    # [B, 1, 1] zeros when the mode is off
    obs_dist: torch.Tensor      # [B, N, N] f32
    obs_steps: torch.Tensor     # [B, N, N] f32
    ended: torch.Tensor         # [B] bool
    # the teacher's node embeddings and [MEM] (distillation), else None
    t_embed_sum: torch.Tensor | None = None   # [B, N+1, DT] f32
    t_embed_cnt: torch.Tensor | None = None   # [B, N+1] f32
    t_mem: torch.Tensor | None = None         # [B, DT] f32
    # episodes that read the tables' aug features (EnvEdit); None in a
    # state saved before the field existed
    aug: torch.Tensor | None = None           # [B] bool

    @property
    def batch_size(self) -> int:
        return self.scan.shape[0]

    def copy_for_step(self) -> "EpisodeBatch":
        """A state whose fields that a step writes in place are copies
        (the others are replaced, never written)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).clone() for f in _WRITTEN_IN_PLACE
            if getattr(self, f) is not None})


def select_lanes(mask, new: EpisodeBatch, old: EpisodeBatch) -> EpisodeBatch:
    """Per lane, ``new``'s state where ``mask`` [B] holds, else ``old``'s,
    as new tensors: neither input is written, so expanded or shared fields
    (the parity distances of ``init_episodes``) are safe.  ``new`` may be
    one lane, broadcast to all."""
    out = {}
    for f in dataclasses.fields(EpisodeBatch):
        o = getattr(old, f.name)
        if o is not None:       # the teacher's fields: no teacher
            m = mask.reshape(mask.shape + (1,) * (o.dim() - 1))
            out[f.name] = torch.where(m, getattr(new, f.name), o)
    return dataclasses.replace(old, **out)


# fields a step updates in place: the step-id stamp, the node embeddings,
# the observation order, the stop scores, visits and the trajectory record
_WRITTEN_IN_PLACE = ("step_ids", "embed_sum", "embed_cnt", "t_embed_sum",
                     "t_embed_cnt", "obs_order", "stop_scores", "visited",
                     "traj_nodes")
ROLE_PREFIX = {"student": "", "teacher": "t_"}


def _role(state: EpisodeBatch, role: str, name: str):
    return getattr(state, ROLE_PREFIX[role] + name)


def init_episodes(tables: Tables, scan_idx, start, heading, gt_path, gt_len,
                  hidden_size: int, observed_parity: bool = False,
                  teacher_size: int | None = None, aug=None) -> EpisodeBatch:
    """Agent at gt_path[0] with the item's heading, elevation 0; the start
    node is visited and it and its candidates are observed.  Inputs may be
    numpy arrays or tensors on the tables' device.  ``teacher_size``: the
    teacher's hidden size, for the teacher's node embeddings and [MEM]
    (distillation); None for none.  ``aug``: [B] bool, the episodes that
    read the aug feature table; None for none of them."""
    dev = tables.dist.device
    i64 = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev)
    scan, start = i64(scan_idx), i64(start)
    gt_path, gt_len = i64(gt_path), i64(gt_len)
    b = scan.shape[0]
    n = tables.num_nodes
    n1 = n + 1
    bi = torch.arange(b, device=dev)
    heading = torch.as_tensor(heading, dtype=torch.float32, device=dev)
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=dev)
    if observed_parity:
        apsp0 = torch.full((n, n), INF_DIST, device=dev).fill_diagonal_(0.0)
        apsp0 = apsp0.expand(b, n, n)
    else:
        apsp0 = zeros(b, 1, 1)
    traj_nodes = torch.full((b, MAX_TRAJ + 1), -1, dtype=torch.int64,
                            device=dev)
    traj_nodes[:, 0] = start
    state = EpisodeBatch(
        scan=scan, cur=start.clone(), heading=heading,
        elevation=zeros(b), start=start,
        goal=gt_path[bi, gt_len - 1], gt_path=gt_path, gt_len=gt_len,
        visited=zeros(b, n1, dtype=torch.bool),
        obs_order=torch.full((b, n1), UNOBS, dtype=torch.int64, device=dev),
        obs_count=zeros(b, dtype=torch.int64),
        step_ids=zeros(b, n1, dtype=torch.int64),
        stop_scores=torch.full((b, n1), NEG_INF, device=dev),
        embed_sum=zeros(b, n1, hidden_size), embed_cnt=zeros(b, n1),
        mem=zeros(b, hidden_size), traj_nodes=traj_nodes,
        traj_len=torch.ones(b, dtype=torch.int64, device=dev),
        obs_dist=apsp0, obs_steps=apsp0, ended=zeros(b, dtype=torch.bool))
    if teacher_size is not None:
        state.t_embed_sum = zeros(b, n1, teacher_size)
        state.t_embed_cnt = zeros(b, n1)
        state.t_mem = zeros(b, teacher_size)
    state.aug = (zeros(b, dtype=torch.bool) if aug is None
                 else torch.as_tensor(aug, dtype=torch.bool, device=dev))
    # the start node carries step id 1 from the outset and is visited
    _set_at(state.step_ids, (bi, start), 1)
    _set_at(state.visited, (bi, start), True)
    if observed_parity:
        relax_observed(state, tables, start,
                       torch.ones(b, dtype=torch.bool, device=dev))
    _observe(state, tables)
    return state


def relax_observed(state: EpisodeBatch, tables: Tables, v, live) -> None:
    """Observed-subgraph all-pairs update on arrival at ``v`` (the
    reference GraphMap's FloydGraph; ``vln_magic_tpu/agent/rollout.py:144``).

    (1) add_edge: d(v, c) takes the direct edge weight of each candidate c
    where it is strictly smaller (a tie keeps the old value); (2) pivot:
    d(i, j) = min(d(i, j), d(i, v) + d(v, j)), strictly.  Only visited nodes
    ever pivot, so a distance is the shortest path whose intermediate nodes
    are all visited.  Rows of ``live`` == False are left as they are."""
    t = tables
    b = state.batch_size
    n = t.num_nodes
    bi = torch.arange(b, device=v.device)
    D, S = state.obs_dist, state.obs_steps

    cand = t.cand_ids[state.scan, v]                          # [B, C]
    valid = t.cand_mask[state.scan, v] & live[:, None] & (cand >= 0)
    safe = cand.clamp(min=0)
    w = t.dist[state.scan[:, None], v[:, None], safe]
    # direct weights onto v's row; amin over candidate slots resolves
    # duplicate candidates, slot n is a trash column
    direct = torch.full((b, n + 1), INF_DIST, device=v.device)
    direct.scatter_reduce_(1, torch.where(valid, safe, n),
                           torch.where(valid, w, INF_DIST), "amin",
                           include_self=True)
    direct = direct[:, :n]
    row_d, row_s = D[bi, v], S[bi, v]                         # [B, N]
    use_direct = direct < row_d
    row_d = torch.where(use_direct, direct, row_d)
    row_s = torch.where(use_direct, 1.0, row_s)
    _set_at(row_d, (bi, v), 0.0)                              # d(v, v) = 0
    _set_at(row_s, (bi, v), 0.0)

    new_d = row_d[:, :, None] + row_d[:, None, :]
    better = (new_d < D) & live[:, None, None]
    state.obs_dist = torch.where(better, new_d, D)
    state.obs_steps = torch.where(better, row_s[:, :, None] + row_s[:, None, :],
                                  S)


def _observe(state: EpisodeBatch, tables: Tables) -> None:
    """Register the current node and its candidates in the gmap, keeping
    first-observation order (new nodes get increasing orders in slot
    order; ``amin`` is a safe combiner because orders only grow)."""
    trash = tables.num_nodes
    bi = torch.arange(state.batch_size, device=state.cur.device)
    live = ~state.ended
    order = state.obs_order

    new = live & (order[bi, state.cur] == UNOBS)
    tgt = torch.where(new, state.cur, trash)
    order.scatter_reduce_(1, tgt[:, None], state.obs_count[:, None], "amin",
                          include_self=True)
    count = state.obs_count + new.long()

    cand = tables.cand_ids[state.scan, state.cur]
    idx = cand.clamp(min=0)
    valid = tables.cand_mask[state.scan, state.cur] & live[:, None] & (cand >= 0)
    new = valid & (order.gather(1, idx) == UNOBS)
    rank = torch.cumsum(new.long(), dim=1) - new.long()
    tgt = torch.where(new, idx, trash)
    order.scatter_reduce_(1, tgt, torch.where(new, count[:, None] + rank, UNOBS),
                          "amin", include_self=True)
    state.obs_count = count + new.sum(dim=1)


def _set_at(x, idx, value) -> None:
    """``x[idx] = value`` for a Python scalar ``value``.  An indexed
    assignment from a Python scalar copies the scalar to the device first,
    one host-to-device copy a call on CUDA; ``new_full`` makes it there."""
    x[idx] = x.new_full((), value)


def _take(x, idx):
    """``x[b, idx[b, ...]]`` along dim 1 for [B, N] or [B, N, F] ``x``."""
    if x.dim() == 2:
        return x.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)
    flat = idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, x.shape[2])
    return x.gather(1, flat).reshape(*idx.shape, x.shape[2])


class Rollout:
    """Rollout bound to world tables, env config, a model and, for
    distillation, a teacher model.  It runs on the device that
    ``Tables.from_world`` put the tables on, which must be the models'."""

    def __init__(self, tables: Tables, env_cfg: EnvConfig, model,
                 teacher_model=None):
        for m in (model, teacher_model):
            model_dev = None if m is None else next(m.parameters()).device
            if m is not None and model_dev != tables.dist.device:
                raise ValueError(f"model on {model_dev}, tables on "
                                 f"{tables.dist.device}")
        self.t = tables
        self.env = env_cfg
        self.model = model
        self.teacher_model = teacher_model
        self.cfg: ModelConfig = model.cfg
        self.parity = env_cfg.observed_graph_parity
        self.policy_key = {"dynamic": "fused_logits", "avg": "fused_logits",
                           "global": "global_logits",
                           "local": "local_logits"}[self.cfg.fusion]
        self.local_acts = self.cfg.fusion == "local"
        # the forward ops a selective remat policy was asked about, by op
        # (``selective_remat``); clear it to count a run
        self.remat_ops: dict = {}

    # ---- step-input assembly -------------------------------------------

    def assemble_pano(self, state: EpisodeBatch) -> dict:
        t = self.t
        b = state.batch_size
        scan, cur = state.scan, state.cur
        cand_ids = t.cand_ids[scan, cur]                      # [B, C]
        cand_mask = t.cand_mask[scan, cur]
        cand_view = t.cand_view[scan, cur]
        feats36 = t.features[scan, cur].float()               # [B, 36, D]
        if t.aug_features is not None and state.aug is not None:
            feats36 = torch.where(state.aug[:, None, None],
                                  t.aug_features[scan, cur].float(), feats36)
        cand_feat = _take(feats36, cand_view)
        size = self.cfg.angle_feat_size
        cand_ang = geo.angle_feature(
            t.cand_heading[scan, cur] - state.heading[:, None],
            t.cand_elevation[scan, cur] - state.elevation[:, None], size)
        view_rel = geo.view_angles_relative(state.heading, state.elevation)
        view_ang = geo.angle_feature(view_rel[..., 0], view_rel[..., 1], size)
        views = torch.arange(36, device=cur.device)
        used = ((cand_view[:, :, None] == views) & cand_mask[:, :, None]).any(1)
        ang = torch.cat([cand_ang, view_ang], dim=1)
        return {
            "view_img_fts": torch.cat([cand_feat, feats36], dim=1),
            "loc_fts": torch.cat([ang, ang.new_ones(ang.shape[:-1] + (3,))],
                                 dim=-1),
            "nav_types": torch.cat([cand_mask.long(),
                                    cand_mask.new_zeros((b, 36), dtype=torch.int64)],
                                   dim=1),
            "pano_masks": torch.cat([cand_mask, ~used], dim=1),
            "cand_ids": cand_ids, "cand_mask": cand_mask,
        }

    def update_node_embeds(self, state: EpisodeBatch, pano_embeds, pano_fused,
                           cand_ids, cand_mask, role="student") -> None:
        """Rewrite the current node with the fused pano embedding and add
        candidate-view embeddings into unvisited nodes (averaged on read),
        in ``role``'s node embeddings."""
        b = state.batch_size
        bi = torch.arange(b, device=cand_ids.device)
        live = ~state.ended
        embed_sum = _role(state, role, "embed_sum")
        embed_cnt = _role(state, role, "embed_cnt")
        cur_t = torch.where(live, state.cur, self.t.num_nodes)
        embed_sum[bi, cur_t] = pano_fused
        _set_at(embed_cnt, (bi, cur_t), 1.0)
        idx = cand_ids.clamp(min=0)
        upd = cand_mask & ~state.visited.gather(1, idx) & live[:, None]
        rows = bi[:, None].expand_as(idx)
        w = upd.float()
        cand_emb = pano_embeds[:, : idx.shape[1]] * w[..., None]
        embed_sum.index_put_((rows, idx), cand_emb, accumulate=True)
        embed_cnt.index_put_((rows, idx), w, accumulate=True)

    def assemble_gmap(self, state: EpisodeBatch, base: dict,
                      role="student") -> dict:
        """Token structure (``base``) + ``role``'s node embeddings and
        [MEM]."""
        n = self.t.num_nodes
        b = state.batch_size
        node_embed = (_role(state, role, "embed_sum")[:, :n]
                      / _role(state, role, "embed_cnt")[:, :n]
                      .clamp(min=1.0)[..., None])
        tok = _take(node_embed, base["token_node"])
        tok = tok * base["token_valid"][..., None]
        zero = tok.new_zeros((b, 1, tok.shape[-1]))
        mem = _role(state, role, "mem")
        img = torch.cat([zero, mem[:, None, :], tok], dim=1)
        return {**base, "gmap_img_embeds": img}

    def _cur_rows(self, state: EpisodeBatch):
        """Graph distances and hop counts from the current node to every
        node [B, N]: the observed subgraph's in parity mode, else the full
        graph's."""
        if self.parity:
            bi = torch.arange(state.batch_size, device=state.cur.device)
            return state.obs_dist[bi, state.cur], state.obs_steps[bi, state.cur]
        return (self.t.dist[state.scan, state.cur],
                self.t.steps[state.scan, state.cur].float())

    def assemble_gmap_base(self, state: EpisodeBatch, ep: dict) -> dict:
        """``ep``: the per-episode world-table slices that ``run`` takes
        once (``dist_f`` [B, N, N], ``pos`` [B, N, 3], and ``nh`` [B, N, N]
        outside parity mode)."""
        t, env = self.t, self.env
        b = state.batch_size
        g = env.max_gmap_len
        n = t.num_nodes
        dev = state.cur.device
        bi = torch.arange(b, device=dev)

        obs_order = state.obs_order[:, :n]
        observed = obs_order < UNOBS
        if env.act_visited_nodes:
            eff_visited = torch.arange(n, device=dev)[None, :] == state.cur[:, None]
        else:
            eff_visited = state.visited[:, :n]
        # visited first (observation order), then frontier (observation order)
        key = obs_order + torch.where(eff_visited, 0, BIG)
        k = min(g - 2, n)
        token_node = torch.argsort(key, dim=1, stable=True)[:, :k]
        token_valid = observed.gather(1, token_node)
        visited_tok = eff_visited.gather(1, token_node)
        step_tok = state.step_ids[:, :n].gather(1, token_node)
        if k < g - 2:   # gmap budget exceeds scan size: pad with dead slots
            pad = lambda x: torch.cat([x, x.new_zeros((b, g - 2 - k))], dim=1)
            token_node, token_valid = pad(token_node), pad(token_valid)
            visited_tok, step_tok = pad(visited_tok), pad(step_tok)

        ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
        gmap_masks = torch.cat([ones, ~ones, token_valid], dim=1)
        gmap_visited = torch.cat([~ones, ones, visited_tok & token_valid], dim=1)
        step_ids = torch.cat([step_tok.new_zeros((b, 2)), step_tok], dim=1)

        # invalid tokens read zeros everywhere downstream
        zero = lambda x: x * token_valid.reshape(
            token_valid.shape + (1,) * (x.dim() - 2)).to(x.dtype)
        pos_b = ep["pos"]
        cur_pos = pos_b[bi, state.cur]                        # [B, 3]
        tok_pos = zero(_take(pos_b, token_node))
        dist_row, steps_row = self._cur_rows(state)            # [B, N]
        gdist = zero(dist_row.gather(1, token_node))
        gsteps = zero(steps_row.gather(1, token_node))
        size = self.cfg.angle_feat_size
        pos7 = geo.pos_features_7(cur_pos[:, None, :], tok_pos, gdist, gsteps,
                                  state.heading, state.elevation, size)
        # [stop]/[mem] slots: angle features of (0, 0) + zero distances
        z = torch.zeros((), device=dev)
        null7 = torch.cat([geo.angle_feature(z, z, size), z.new_zeros(3)])
        pos_fts = torch.cat([null7.expand(b, 2, -1), pos7], dim=1)

        # pairwise graph distances for the sprel bias (slots >= 2)
        dist_b = state.obs_dist if self.parity else ep["dist_f"]
        rows = zero(_take(dist_b, token_node))                 # [B, G', N]
        pair = rows.gather(2, token_node[:, None, :].expand(-1, rows.shape[1], -1))
        pair = pair * token_valid[:, None, :]
        pair_dists = pair.new_zeros((b, g, g))
        pair_dists[:, 2:, 2:] = pair

        no_vp_left = ~((observed & ~eff_visited).any(dim=1))
        return {
            "gmap_step_ids": step_ids, "gmap_pos_fts": pos_fts,
            "gmap_masks": gmap_masks, "gmap_visited_masks": gmap_visited,
            "gmap_pair_dists": pair_dists, "token_node": token_node,
            "token_valid": token_valid, "no_vp_left": no_vp_left,
        }

    def assemble_vp(self, state: EpisodeBatch, pano_embeds, base: dict,
                    role="student") -> dict:
        b = state.batch_size
        d = pano_embeds.shape[-1]
        mem = _role(state, role, "mem")
        img = torch.cat([mem.new_zeros((b, 1, d)), mem[:, None, :],
                         pano_embeds.float()], dim=1)
        return {**base, "vp_img_embeds": img}

    def assemble_vp_base(self, state: EpisodeBatch, pano: dict, gmap: dict,
                         ep: dict) -> dict:
        t = self.t
        b = state.batch_size
        n = t.num_nodes
        dev = state.cur.device
        bi = torch.arange(b, device=dev)
        cand_ids, cand_mask = pano["cand_ids"], pano["cand_mask"]
        size = self.cfg.angle_feat_size

        pos_b = ep["pos"]
        cur_pos = pos_b[bi, state.cur]
        start_pos = pos_b[bi, state.start]
        dist_row, steps_row = self._cur_rows(state)
        start7 = geo.pos_features_7(
            cur_pos[:, None, :], start_pos[:, None, :],
            dist_row[bi, state.start][:, None],
            steps_row[bi, state.start][:, None],
            state.heading, state.elevation, size)[:, 0]

        cand_safe = cand_ids.clamp(min=0)
        cand7 = geo.pos_features_7(
            cur_pos[:, None, :], _take(pos_b, cand_safe),
            dist_row.gather(1, cand_safe), steps_row.gather(1, cand_safe),
            state.heading, state.elevation, size)

        p2 = pano["pano_masks"].shape[1] + 2
        c = cand_ids.shape[1]
        vp_pos_fts = torch.zeros((b, p2, 14), device=dev)
        vp_pos_fts[:, :, :7] = start7[:, None, :]
        vp_pos_fts[:, 2:2 + c, 7:] = cand7 * cand_mask[..., None]

        ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
        vp_masks = torch.cat([ones, ones, pano["pano_masks"]], dim=1)
        vp_nav_masks = torch.cat([ones, ~ones, pano["nav_types"] == 1], dim=1)

        # gmap token -> vp candidate slot (for dynamic fusion); argmax of an
        # int mask picks the first match, as the reference's bool argmax
        eq = ((gmap["token_node"][:, :, None] == cand_ids[:, None, :])
              & cand_mask[:, None, :] & gmap["token_valid"][:, :, None])
        slot = torch.where(eq.any(-1), 2 + eq.int().argmax(-1), -1)
        gmap_local_slot = torch.cat([slot.new_full((b, 2), -1), slot], dim=1)

        cand_visited = state.visited[:, :n].gather(1, cand_safe) & cand_mask
        vp_cand_visited = torch.cat(
            [torch.zeros((b, 2), device=dev), cand_visited.float(),
             torch.zeros((b, 36), device=dev)], dim=1)
        return {
            "vp_pos_fts": vp_pos_fts, "vp_masks": vp_masks,
            "vp_nav_masks": vp_nav_masks, "gmap_local_slot": gmap_local_slot,
            "vp_cand_visited": vp_cand_visited,
        }

    # ---- supervision and action choice --------------------------------

    def teacher_action(self, state: EpisodeBatch, gmap: dict, t_step: int,
                       imitation, ep: dict):
        """The supervision target in the gmap action space (the reference's
        ``_teacher_action``): with ``imitation``, the ground-truth next hop
        at step ``t_step`` (0 past the path's end; ``ignore_id`` when the
        token budget truncated it away); otherwise the DAgger expert, stop
        at the goal or else the unvisited token minimising dist(cur, node)
        + dist(node, goal) (``spl``) or maximising the nDTW of the
        trajectory extended to it (``ndtw``, ``_ndtw_scores``).
        ``imitation`` is a bool or, in the fused dual rollout, a [B] bool
        tensor choosing per row.  Ended rows get ``ignore_id``."""
        imit = lambda: self._imitation_target(state, gmap["token_node"],
                                              gmap["token_valid"], t_step)
        if isinstance(imitation, bool):
            a = imit() if imitation else self._expert_action(state, gmap, ep)
        else:
            a = torch.where(imitation, imit(),
                            self._expert_action(state, gmap, ep))
        return torch.where(state.ended, self.env.ignore_id, a)

    def teacher_action_local(self, state: EpisodeBatch, pano: dict,
                             t_step: int, imitation, ep: dict):
        """The supervision target in the viewpoint branch's action space
        (``fusion='local'``: [stop], [mem], the current node's candidates;
        JAX's ``teacher_action_local``): the ground-truth next hop's
        candidate slot, or the ``spl`` expert's candidate, minimising
        dist(cur, c) + dist(c, goal).  ``imitation`` as in
        ``teacher_action``."""
        cand_ids, cand_mask = pano["cand_ids"], pano["cand_mask"]
        bi = torch.arange(state.batch_size, device=cand_ids.device)

        def expert():
            dist = ep["dist_f"]
            safe = cand_ids.clamp(min=0)
            cost = torch.where(cand_mask,
                               dist[bi, state.cur].gather(1, safe)
                               + dist[bi[:, None], safe, state.goal[:, None]],
                               math.inf)
            return torch.where(state.cur == state.goal, 0,
                               2 + cost.argmin(dim=1))

        imit = lambda: self._imitation_target(state, cand_ids, cand_mask,
                                              t_step)
        if isinstance(imitation, bool):
            a = imit() if imitation else expert()
        else:
            a = torch.where(imitation, imit(), expert())
        return torch.where(state.ended, self.env.ignore_id, a)

    def _imitation_target(self, state: EpisodeBatch, slots, slot_valid,
                          t_step: int):
        """The slot (2 + index into ``slots`` [B, K], gmap tokens or
        candidates) holding the ground-truth next hop at step ``t_step``: 0
        past the path's end, ``ignore_id`` where no valid slot holds it."""
        bi = torch.arange(state.batch_size, device=slots.device)
        tt = (state.gt_len - 1).clamp(max=t_step + 1)
        goal_vp = state.gt_path[bi, tt]
        eq = (slots == goal_vp[:, None]) & slot_valid
        idx = 2 + eq.int().argmax(dim=1)
        return torch.where(t_step >= state.gt_len - 1, 0,
                           torch.where(eq.any(dim=1), idx, self.env.ignore_id))

    def _expert_action(self, state: EpisodeBatch, gmap: dict, ep: dict):
        """The DAgger expert's gmap action (JAX's
        ``_teacher_action_expert``)."""
        env = self.env
        bi = torch.arange(state.batch_size, device=state.cur.device)
        token_node = gmap["token_node"]
        n = self.t.num_nodes
        dist = ep["dist_f"]
        visited_tok = state.visited[:, :n].gather(1, token_node)
        eligible = gmap["token_valid"] & ~visited_tok
        if env.expert_policy == "ndtw":
            score = -self._ndtw_scores(state, gmap, ep)
        elif env.expert_policy == "spl":
            score = (dist[bi, state.cur].gather(1, token_node)
                     + dist[bi[:, None], token_node, state.goal[:, None]])
        else:
            raise ValueError(f"invalid expert_policy {env.expert_policy!r}")
        cost = torch.where(eligible, score, math.inf)
        return torch.where(state.cur == state.goal, 0, 2 + cost.argmin(dim=1))

    def _ndtw_scores(self, state: EpisodeBatch, gmap: dict, ep: dict,
                     k_ext: int = 16, lp: int = 48):
        """nDTW [B, G] of each gmap token's hypothetical trajectory against
        the ground-truth path: the first ``lp`` recorded trajectory nodes,
        then the shortest path (at most ``k_ext`` hops) from the current
        node to the token (the reference's per-candidate host loop,
        eval_utils.py:6-26 via agent.py:357-363; JAX's ``_ndtw_scores``).

        JAX runs the DTW as a scan over prediction rows of a scan over
        ground-truth columns, carrying an invalid row's predecessor forward.
        Here the valid rows are moved to the front (stably) and the DTW
        matrix is swept by anti-diagonals, every cell of one at once:
        lp + k_ext + TG - 1 steps of a few kernels each instead of
        (lp + k_ext) x TG.  A cell is JAX's own f32 arithmetic, the cost
        plus the exact minimum of its three predecessors, so the matrix
        holds JAX's values bit for bit."""
        t = self.t
        b, g = gmap["token_node"].shape
        dev = state.cur.device
        bi = torch.arange(b, device=dev)
        token_node = gmap["token_node"]
        nh = ep["nh"] if "nh" in ep else t.next_hop[state.scan]

        # shortest-path extension cur -> token (bounded next-hop walk)
        p = state.cur[:, None].expand(b, g)
        ext, ext_valid = [], []
        for _ in range(k_ext):
            nxt = nh[bi[:, None], p, token_node]
            stepping = (p != token_node) & (nxt >= 0)
            ext.append(torch.where(stepping, nxt, 0))
            ext_valid.append(stepping)
            p = torch.where(stepping, nxt, p)
        traj = state.traj_nodes[:, :lp]
        traj_valid = ((torch.arange(lp, device=dev)[None, :]
                       < state.traj_len.clamp(max=lp)[:, None])
                      & (traj >= 0))
        pred = torch.cat([traj.clamp(min=0)[:, None, :].expand(b, g, lp),
                          torch.stack(ext, 2)], dim=2)          # [B, G, L]
        valid = torch.cat([traj_valid[:, None, :].expand(b, g, lp),
                           torch.stack(ext_valid, 2)], dim=2)
        # valid rows first, in order; v of them per token
        order = torch.argsort((~valid).to(torch.uint8), dim=2, stable=True)
        pred = pred.gather(2, order)
        v = valid.sum(dim=2)

        gt = state.gt_path.clamp(min=0)
        tg = gt.shape[1]
        L = pred.shape[2]
        cost = ep["dist_f"][bi[:, None, None, None], pred[..., None],
                            gt[:, None, None, :]]               # [B, G, L, TG]

        # DTW over the padded grid P[r, j], r in [0, L], j in [0, TG]:
        # P[0, 0] = 0, the rest of row 0 and column 0 = BIG, and
        # P[r, j] = cost[r-1, j-1] + min(P[r-1, j], P[r, j-1], P[r-1, j-1]).
        # Diagonal e holds the cells r + j = e, indexed by r; its buffer
        # has a leading BIG so that "the cell at r - 1" is a slice.
        big = 1e9
        n_diag = L + tg + 1
        e = torch.arange(n_diag, device=dev)[:, None]
        r = torch.arange(L + 1, device=dev)[None, :]
        j = e - r
        interior = (r >= 1) & (j >= 1) & (j <= tg)              # [E, L+1]
        flat = torch.where(interior, (r - 1) * tg + (j - 1), 0)
        skew = cost.reshape(b, g, L * tg).gather(
            2, flat.reshape(1, 1, -1).expand(b, g, -1)).reshape(
            b, g, n_diag, L + 1)
        diags = torch.full((n_diag, b, g, L + 2), big, device=dev)
        diags[0, :, :, 1] = 0.0         # P[0, 0]; diagonal 1 is all border
        for k in range(2, n_diag):
            prev, prev2 = diags[k - 1], diags[k - 2]
            best = torch.minimum(torch.minimum(prev[..., :-1], prev[..., 1:]),
                                 prev2[..., :-1])
            diags[k, :, :, 1:] = torch.where(interior[k], skew[:, :, k] + best,
                                             big)
        gt_len = state.gt_len[:, None].expand(b, g)
        gi = torch.arange(g, device=dev)[None, :]
        dtw = diags[v + gt_len, bi[:, None], gi, v + 1]
        return torch.exp(-dtw / (3.0 * state.gt_len[:, None]))

    def select_action(self, logits, feedback: str, generator, nav_targets,
                      gmap: dict, explore_mask=None, is_tf=None):
        """The action per feedback mode: ``teacher`` takes the target,
        ``argmax`` the best logit, ``sample`` a draw from softmax(logits)
        (the Gumbel-max trick), ``expl_sample`` the best logit or, with
        probability 1 - ``expl_max_ratio``, a uniform draw among the
        selectable slots: ``explore_mask`` [B, A] (``fusion='local'``: the
        viewpoint branch's navigable slots) or else the unvisited gmap
        tokens.  ``teacher+<mode>`` (the fused dual rollout): the target
        on the rows of ``is_tf`` [B], ``<mode>`` on the others.  Draws
        come from ``generator``."""
        if "+" in feedback:
            dagger = self.select_action(logits, feedback.split("+", 1)[1],
                                        generator, nav_targets, gmap,
                                        explore_mask)
            return torch.where(is_tf, nav_targets.clamp(min=0), dagger)
        if feedback == "teacher":
            return nav_targets.clamp(min=0)     # ignore_id rows have ended
        if feedback == "argmax":
            return logits.argmax(dim=-1)
        # drawn at the global batch on a mesh (parallel.mesh.draw_uniform)
        rand = lambda shape: draw_uniform(shape, generator, logits.device)
        if feedback == "sample":
            gumbel = -torch.log(-torch.log(rand(logits.shape)))
            return (logits.float() + gumbel).argmax(dim=-1)
        if feedback == "expl_sample":
            a = logits.argmax(dim=-1)
            explore = rand(a.shape) > self.env.expl_max_ratio
            mask = (explore_mask if explore_mask is not None else
                    gmap["gmap_masks"] & ~gmap["gmap_visited_masks"])
            rand_a = torch.where(mask, rand(mask.shape), -1.0).argmax(dim=-1)
            return torch.where(explore, rand_a, a)
        raise ValueError(f"invalid feedback {feedback!r}")

    # ---- transition -----------------------------------------------------

    def transition(self, state: EpisodeBatch, gmap: dict, action, stop_prob,
                   t_step, pano: dict, ep: dict,
                   local_actions: bool = False, feedback: str = "argmax",
                   defer_observe: bool = False, is_tf=None):
        """Record the stop probability, end episodes that stop, run out of
        frontier or of steps, and jump the rest to their target, facing
        along the last edge walked.  An episode stops on action 0 and, with
        ``teacher`` or ``sample`` feedback, also at its goal; under
        ``teacher+<mode>`` the rows of ``is_tf`` [B] follow ``teacher``'s
        rule and the others ``<mode>``'s.  ``t_step``
        is the step index, an int or a [B] tensor of per-lane clocks.
        ``defer_observe`` skips the arrival node's registration (the
        observed-graph relax and ``_observe``): online serving
        (``agent/serving.py``) runs it at the top of the next decision,
        once the robot has reported the node's candidates.
        Returns the chosen target per row (-1 when not moving)."""
        t = self.t
        b = state.batch_size
        dev = action.device
        bi = torch.arange(b, device=dev)
        trash = t.num_nodes
        live = ~state.ended

        cur_t = torch.where(live, state.cur, trash)
        state.stop_scores[bi, cur_t] = torch.where(
            live, stop_prob, state.stop_scores[bi, cur_t])

        wants_stop = action == 0
        if "+" in feedback:
            goal_stop = is_tf | (feedback.split("+", 1)[1] == "sample")
            wants_stop = wants_stop | (goal_stop & (state.cur == state.goal))
        elif feedback in ("teacher", "sample"):
            wants_stop = wants_stop | (state.cur == state.goal)
        just_ended = live & (wants_stop | gmap["no_vp_left"]
                             | (t_step == self.env.max_action_len - 1))
        moving = live & ~just_ended

        if local_actions:
            # action slot -> the current node's candidate
            c = pano["cand_ids"].shape[1]
            raw = action - 2
            slot = raw.clamp(0, c - 1)[:, None]
            target = pano["cand_ids"].gather(1, slot)[:, 0]
            valid = ((raw >= 0) & (raw < c)
                     & pano["cand_mask"].gather(1, slot)[:, 0])
            moving = moving & valid
        else:
            slot = (action - 2).clamp(0, gmap["token_node"].shape[1] - 1)
            target = gmap["token_node"].gather(1, slot[:, None])[:, 0]
        target = torch.where(moving, target, state.cur)

        # bounded walk toward the target: its last-but-one node gives the
        # view of the final edge, and in parity mode the walk is the
        # expanded trajectory.  The hop bound is tight: every target is
        # observed, and an observed node is <= T + 1 hops away.  Parity
        # walks the observed subgraph (obs_dist is symmetric, so the
        # target's row is its column), else next_hop.
        hops = max(2, min(WALK_HOPS, self.env.max_action_len + 1))
        if self.parity:
            prev, state.traj_len = self._walk_observed(
                state, target, moving, hops, state.traj_nodes,
                state.traj_len)
        else:
            # the nDTW expert reads the expanded trajectory
            record = self.env.expert_policy == "ndtw"
            col = ep["nh"].gather(
                2, target[:, None, None].expand(-1, trash, 1))[..., 0]
            p = prev = state.cur
            for _ in range(hops):
                nxt = col.gather(1, p[:, None])[:, 0]
                stepping = moving & (p != target) & (nxt >= 0)
                prev = torch.where(stepping & (nxt == target), p, prev)
                if record:
                    state.traj_len = _record_hop(state.traj_nodes,
                                                 state.traj_len, stepping, nxt)
                p = torch.where(stepping, nxt, p)

        cand_prev = t.cand_ids[state.scan, prev]
        eq = cand_prev == target[:, None]
        has_edge = eq.any(dim=1)
        view_row = t.cand_view[state.scan, prev]
        view = view_row.gather(1, eq.int().argmax(dim=1)[:, None])[:, 0]
        turn = moving & has_edge
        state.heading = torch.where(turn, (view % 12).float() * (math.pi / 6),
                                    state.heading)
        state.elevation = torch.where(
            turn, (view // 12 - 1).float() * (math.pi / 6), state.elevation)

        state.cur = torch.where(moving, target, state.cur)
        _set_at(state.visited, (bi, torch.where(moving, state.cur, trash)),
                True)
        state.ended = state.ended | just_ended
        if not defer_observe:
            if self.parity:
                relax_observed(state, t, state.cur, moving)
            _observe(state, t)
        return torch.where(moving, target, -1)

    def _observed_next(self, state: EpisodeBatch, p, dcol, target):
        """Next node from ``p`` on an observed shortest path toward
        ``target`` (``dcol``: obs distances to the target [B, N]): the
        candidate c of p minimising w(p, c) + d(c, target) (first minimum)
        among those that are visited or the target itself, since obs_dist
        routes through visited nodes only.  Returns (next node, found)."""
        t = self.t
        cand = t.cand_ids[state.scan, p]                          # [B, C]
        safe = cand.clamp(min=0)
        stepable = t.cand_mask[state.scan, p] & (
            state.visited.gather(1, safe) | (cand == target[:, None]))
        cost = torch.where(stepable,
                           t.cand_dist[state.scan, p] + dcol.gather(1, safe),
                           INF_DIST)
        j = cost.argmin(dim=1, keepdim=True)
        return (cand.gather(1, j)[:, 0],
                cost.gather(1, j)[:, 0] < INF_DIST / 2)

    def record_backtrack(self, state: EpisodeBatch, stop_node):
        """The trajectory buffer with the stop-score backtrack path (cur ->
        stop node) over the observed subgraph appended, as (traj_nodes,
        traj_len); the state keeps its own.  Parity mode only."""
        nodes = state.traj_nodes.clone()
        _, ln = self._walk_observed(state, stop_node, stop_node != state.cur,
                                    WALK_HOPS, nodes, state.traj_len)
        return nodes, ln

    def _walk_observed(self, state: EpisodeBatch, target, moving, hops,
                       nodes, ln):
        """Walk the ``moving`` rows from their current node toward
        ``target`` over the observed subgraph, at most ``hops`` hops,
        appending each hop to the trajectory ``nodes`` (in place).
        Returns (the node before the target on the walk, the current node
        where no hop reached it; the new trajectory lengths).  CUDA tensors
        take one launch of the walk kernel (``ops/walk.py``), which stops
        each lane at its first hop that does not step; the CPU takes
        ``_walk_loop``."""
        t = self.t
        if target.device.type == "cuda":
            return walk.observed_walk(
                t.cand_ids, t.cand_mask, t.cand_dist, state.scan, state.cur,
                target, moving, state.visited, state.obs_dist, nodes, ln, hops)
        return self._walk_loop(state, target, moving, hops, nodes, ln)

    def _walk_loop(self, state: EpisodeBatch, target, moving, hops, nodes,
                   ln):
        """``_walk_observed`` as a torch loop, every hop on every lane,
        as JAX's ``fori_loop`` walks."""
        bi = torch.arange(state.batch_size, device=target.device)
        dcol = state.obs_dist[bi, target]
        p = prev = state.cur
        for _ in range(hops):
            nxt, ok = self._observed_next(state, p, dcol, target)
            stepping = moving & (p != target) & ok
            prev = torch.where(stepping & (nxt == target), p, prev)
            ln = _record_hop(nodes, ln, stepping, nxt)
            p = torch.where(stepping, nxt, p)
        return prev, ln

    def final_stop_node(self, state: EpisodeBatch):
        """Backtrack target: the node with the highest recorded stop
        probability, or the current node when none was recorded."""
        scores = state.stop_scores[:, : self.t.num_nodes]
        best = scores.argmax(dim=1)     # first maximum, as jnp.argmax
        has = scores.gather(1, best[:, None])[:, 0] > NEG_INF / 2
        return torch.where(has, best, state.cur)

    # ---- the episode loop -----------------------------------------------

    def episode_tables(self, state: EpisodeBatch) -> dict:
        """The per-episode world-table slices a step reads, taken once per
        wave (or per streamed chunk); parity reads obs_dist, not next_hop."""
        t = self.t
        ep = {"dist_f": t.dist[state.scan], "pos": t.positions[state.scan]}
        if not self.parity:
            ep["nh"] = t.next_hop[state.scan]
        return ep

    def _generator(self, seed: int, step: int) -> torch.Generator:
        """The draws of step ``step`` (-1: the instruction encoding) of a run
        seeded ``seed``: a generator on the tables' device seeded from both,
        so a step recomputed under checkpointing draws the same again."""
        gen = torch.Generator(device=self.t.dist.device)
        gen.manual_seed((seed * 1_000_003 + step + 1) % 2 ** 63)
        return gen

    def _stamp(self, state: EpisodeBatch, lane_t):
        """Stamp the current node's step id before any forward; returns the
        lanes live at the top of the step."""
        bi = torch.arange(state.batch_size, device=state.cur.device)
        trash = self.t.num_nodes
        live0 = ~state.ended
        state.step_ids[bi, torch.where(live0, state.cur, trash)] = \
            torch.where(live0, lane_t + 1, state.step_ids[:, trash])
        return live0

    @staticmethod
    def _apply_mc(mode, ensemble_n, drop, *args, **kwargs):
        """``mode(*args, **drop, **kwargs)``; with ``ensemble_n`` > 1 the
        mean of ``ensemble_n`` calls with dropout on, drawn one after
        another from ``drop["generator"]`` (JAX's ``_apply_mc``, a vmap
        over split keys; the reference's ensemble rollout,
        agent_base.py:197-207)."""
        if ensemble_n <= 1:
            return mode(*args, **drop, **kwargs)
        runs = [mode(*args, deterministic=False,
                     generator=drop["generator"],
                     need_maps=drop["need_maps"], **kwargs)
                for _ in range(ensemble_n)]
        mean = lambda xs: torch.stack(xs).mean(0)
        if isinstance(runs[0], dict):
            return {k: mean([r[k] for r in runs]) for k in runs[0]}
        return tuple(mean(list(xs)) for xs in zip(*runs))

    def _model_step(self, model, role, state: EpisodeBatch, pano, gmap_base,
                    vp_base, txt_embeds, txt_masks, txt_kv,
                    deterministic=True, generator=None, need_maps=False,
                    zd=None, ensemble_n=1):
        """One model's part of a step: panorama forward, ``role``'s node
        embedding update, gmap/vp assembly, navigation forward and [MEM].
        Returns (gmap, outs); ``outs`` also carries the panorama outputs.
        ``need_maps``: the caller reads the attention maps or gradients, so
        attention stays off the packed kernel (the training rollout).
        ``zd``: the role's dictionaries on the device (``zdicts_on``): the
        image backdoor's and the viewpoint and map frontdoors'.
        ``ensemble_n`` > 1: each mode averaged over that many dropout
        draws (``_apply_mc``)."""
        zd = zd or {}
        drop = {"deterministic": deterministic, "generator": generator,
                "need_maps": need_maps}
        with span("rollout.panorama"):
            pano_embeds, pano_fused, img_attns = self._apply_mc(
                model.panorama, ensemble_n, drop, pano["view_img_fts"],
                pano["loc_fts"], pano["nav_types"], pano["pano_masks"],
                z_img_feats=zd.get("z_img_feats"),
                z_img_pzs=zd.get("z_img_pzs"))
        with span("rollout.map"):
            # the episode state stays f32 whatever the model's dtype
            self.update_node_embeds(state, pano_embeds.float(),
                                    pano_fused.float(), pano["cand_ids"],
                                    pano["cand_mask"], role)
            gmap = self.assemble_gmap(state, gmap_base, role)
            vp = self.assemble_vp(state, pano_embeds, vp_base, role)
        with span("rollout.navigation"):
            outs = self._apply_mc(
                model.navigation, ensemble_n, drop, txt_embeds, txt_masks,
                gmap["gmap_img_embeds"], gmap["gmap_step_ids"],
                gmap["gmap_pos_fts"], gmap["gmap_masks"],
                gmap["gmap_visited_masks"], gmap["gmap_pair_dists"],
                vp["vp_img_embeds"], vp["vp_pos_fts"], vp["vp_masks"],
                vp["vp_nav_masks"], vp["gmap_local_slot"],
                vp["vp_cand_visited"], txt_cross_kvs=txt_kv,
                front_vp_feats=zd.get("front_vp_feats"),
                front_gmap_feats=zd.get("front_gmap_feats"))
        setattr(state, ROLE_PREFIX[role] + "mem", outs["cls_embeds"].float())
        outs.update({"pano_embeds": pano_embeds,
                     "pano_fused_embeds": pano_fused, "img_attns": img_attns})
        return gmap, outs

    def step(self, state: EpisodeBatch, ep: dict, txt_embeds, txt_masks,
             txt_kv, lane_t, feedback: str = "argmax", generator=None,
             defer_observe: bool = False, zd=None, ensemble_n: int = 1):
        """One evaluation step of every lane (state updated in place).
        ``lane_t``: the step index, an int, or a [B] tensor of per-lane
        clocks (streaming, serving; argmax only), wherever it has
        per-episode meaning: the step-id stamp and the forced stop at
        ``max_action_len - 1``.  ``generator``: the draws of ``sample`` and
        ``expl_sample`` feedback and of the ensemble's dropout.
        ``defer_observe``: see ``transition``.  ``zd``, ``ensemble_n``: see
        ``_model_step``.

        Returns (chosen target per lane, -1 when not moving; lanes live at
        the top of the step; lanes that ended in it; the action taken, a
        gmap token index)."""
        with span("rollout.step"):
            live0 = self._stamp(state, lane_t)
            with span("rollout.observe"):
                pano = self.assemble_pano(state)
                gmap_base = self.assemble_gmap_base(state, ep)
                vp_base = self.assemble_vp_base(state, pano, gmap_base, ep)
            gmap, outs = self._model_step(
                self.model, "student", state, pano, gmap_base, vp_base,
                txt_embeds, txt_masks, txt_kv, generator=generator, zd=zd,
                ensemble_n=ensemble_n)
            logits = outs[self.policy_key]
            targets = (self._targets(state, gmap, pano, lane_t, True, ep)
                       if feedback == "teacher" else None)
            with span("rollout.act"):
                action = self.select_action(logits, feedback, generator,
                                            targets, gmap,
                                            self._explore_mask(vp_base))
                stop_prob = torch.softmax(logits, dim=-1)[:, 0].float()
                chosen = self.transition(state, gmap, action, stop_prob,
                                         lane_t, pano, ep, self.local_acts,
                                         feedback, defer_observe)
            return chosen, live0, state.ended & live0, action

    def run(self, state: EpisodeBatch, txt_ids, txt_masks,
            feedback: str = "argmax", ensemble_n: int = 1, *, seed: int = 0,
            train_ml: float | None = None, deterministic: bool = True,
            distill=None, use_teacher_policy: bool = False,
            remat=False, zdicts: dict | None = None, ability_grads=None,
            train_rl: bool = False, critic=None, gamma: float = 0.9,
            fused_split: int | None = None):
        """Every episode in ``state`` for ``max_action_len`` steps.

        ``feedback``: ``argmax``, ``sample``, ``expl_sample`` or
        ``teacher``; ``seed`` seeds the run's draws.  With the defaults
        this decodes (evaluation): no autograd, ``state`` updated in place.
        With ``train_ml`` (supervision: the CE of each step against
        ``teacher_action``, imitation under ``teacher`` feedback, else the
        DAgger expert), ``distill`` (a ``DistillConfig``: MAKD losses
        against the teacher model, the teacher's own CE, and with
        ``train_teacher`` the reverse ICoD losses), ``train_rl``,
        ``fused_split`` or ``deterministic=False`` (dropout on), it is a
        training rollout that records autograd's graph and leaves
        ``state`` as it was.  ``remat``: True or ``"full"`` recomputes each
        step in the backward pass (``torch.utils.checkpoint``) instead of
        keeping its activations; ``"dots"`` or ``"dots_all"`` keep the
        products that ``selective_remat`` names and recompute the rest.
        ``use_teacher_policy`` acts on the teacher's logits.
        ``zdicts``: ``{role: build_rollout_zdicts(...)}`` for ``student``
        and ``teacher``, broadcast over the batch (JAX's ``zd_for``).
        ``ensemble_n`` > 1: the student's panorama and navigation modes
        averaged over that many dropout draws, as JAX's ``_apply_mc``.
        ``ability_grads``: the five ability-gradient magnitudes
        (``Trainer.update_ability_grads``) that the ``grad`` ability
        weights read (``losses.grad_softmax_weights``).
        ``train_rl`` (A2C): each step records the taken action's log-prob
        under the policy, its entropy, ``critic``'s value of [MEM] and the
        reward (the progress toward the goal, plus 2 or -2 at the end by
        ``error_margin``); the returns, discounted by ``gamma``, give
        ``rl_loss`` (policy and value terms) and ``rl_entropy``.
        ``fused_split`` (the fused dual rollout, ``teacher+<mode>``
        feedback): rows [0, fused_split) are teacher-forced and the others
        follow ``<mode>``, and every loss stays within its half (MKTD
        normalisation, MKRW draws, reductions, the all-ended gate), so the
        halves equal two separate rollouts.

        Returns aux: ``actions`` [T, B] chosen targets (-1 when not
        moving), ``stop_node``, ``final_cur``, ``semantic_steps`` (episodes
        live at the top of each step, summed), ``gmap_overflow`` and, in
        parity mode, the expanded trajectory ``traj_nodes``/``traj_len``
        with the backtrack appended; a training rollout adds the summed
        CE ``ml_loss`` and, with ``distill``, ``t_ml_loss`` (the teacher's
        CE), ``kd_losses`` and ``t_kd_losses`` (dicts over
        ``distill.KD_LOSS_NAMES``, zeros without ICoD); ``fused_split``
        adds each half's: ``ml_loss_vec`` and ``t_ml_loss_vec`` [2],
        ``kd_losses_tf``/``_dg``, ``t_kd_losses_tf``/``_dg`` and
        ``gmap_overflow_tf``/``_dg``."""
        fused = fused_split is not None
        if fused and "+" not in feedback:
            raise ValueError("fused_split requires feedback='teacher+<mode>'")
        if "+" in feedback and not fused:
            raise ValueError(f"feedback={feedback!r} is the fused dual "
                             "rollout: it needs fused_split")
        head, _, mode = feedback.rpartition("+")
        if head not in ("", "teacher") or mode not in (
                "argmax", "sample", "expl_sample", "teacher"):
            raise ValueError(f"invalid feedback {feedback!r}")
        zd = {role: zdicts_on((zdicts or {}).get(role), state.batch_size,
                              state.cur.device)
              for role in ("student", "teacher")}
        if (train_ml is None and distill is None and deterministic
                and not train_rl and not fused):
            return self._decode(state, txt_ids, txt_masks, feedback, seed,
                                zd["student"], ensemble_n)
        return self._run_train(
            state, txt_ids, txt_masks, feedback, seed, train_ml,
            deterministic, distill, use_teacher_policy, remat, zd,
            ensemble_n, ability_grads, train_rl, critic, gamma, fused_split)

    @staticmethod
    def hoisted_kv(model, txt_embeds):
        """The instruction K/V hoisted out of the step loop
        (``text_cross_kv``), or ``None`` where the model projects it in
        place: ``hoist_text_kv`` off, or ``fuse_branches``, whose trunk
        reads no hoisted K/V (JAX ``rollout.py:1166``)."""
        c = model.cfg
        return (model.text_cross_kv(txt_embeds)
                if c.hoist_text_kv and not c.fuse_branches else None)

    @torch.no_grad()
    def _decode(self, state, txt_ids, txt_masks, feedback, seed, zd,
                ensemble_n):
        with span("rollout.language"):
            txt_embeds, _ = self.model.language(
                txt_ids, txt_masks, instr_zdict=zd.get("instr_zdict"),
                front_txt_feats=zd.get("front_txt_feats"))
            txt_kv = self.hoisted_kv(self.model, txt_embeds)
            ep = self.episode_tables(state)
        draws = feedback in ("sample", "expl_sample") or ensemble_n > 1
        actions, live_n = [], []
        for t_step in range(self.env.max_action_len):
            gen = self._generator(seed, t_step) if draws else None
            chosen, live0, _, _ = self.step(state, ep, txt_embeds, txt_masks,
                                            txt_kv, t_step, feedback, gen,
                                            zd=zd, ensemble_n=ensemble_n)
            actions.append(chosen)
            live_n.append(live0.sum())
        return self._aux(state, actions, live_n)

    def _aux(self, state, actions, live_n) -> dict:
        aux = {
            "actions": torch.stack(actions),
            "stop_node": self.final_stop_node(state),
            "final_cur": state.cur,
            "semantic_steps": torch.stack(live_n).sum(),
            "gmap_overflow": (state.obs_count
                              > self.env.max_gmap_len - 2).sum(),
        }
        if self.parity:
            aux["traj_nodes"], aux["traj_len"] = self.record_backtrack(
                state, aux["stop_node"])
        return aux

    def _run_train(self, state, txt_ids, txt_masks, feedback, seed, train_ml,
                   deterministic, distill, use_teacher_policy, remat, zd,
                   ensemble_n, ability_grads, train_rl, critic, gamma,
                   fused_split):
        model, teacher = self.model, self.teacher_model
        kdl = distill is not None and teacher is not None
        awt = (distill.adaptive_ability_weight_type
               if kdl and distill.adaptive_ability_weight else None)
        if kdl and state.t_mem is None:
            raise ValueError("distillation needs the teacher's episode "
                             "state: build it with teacher_size")
        if train_rl and critic is None:
            raise ValueError("train_rl needs the critic")
        dev = state.cur.device
        fused = fused_split is not None
        # the training forwards read the attention maps (MAKD) and the
        # gradients, which the forward-only packed kernel does not give
        drop = {"deterministic": deterministic,
                "generator": self._generator(seed, -1), "need_maps": True}
        c = SimpleNamespace(
            feedback=feedback, train_ml=train_ml, drop_off=deterministic,
            kdl=kdl, distill=distill, use_teacher_policy=use_teacher_policy,
            icod=kdl and distill.train_teacher,
            mktd=kdl and distill.teacher_sample_hard_mining,
            rw=awt == "RW", ab_static=None, s_learned=None, t_learned=None,
            txt_masks=txt_masks, ep=self.episode_tables(state),
            zd=zd["student"], t_zd=zd["teacher"], ensemble_n=ensemble_n,
            split=fused_split, train_rl=train_rl, critic=critic,
            is_tf=(torch.arange(state.batch_size, device=dev) < fused_split
                   if fused else None))
        lang = lambda m, z: m.language(
            txt_ids, txt_masks, instr_zdict=z.get("instr_zdict"),
            front_txt_feats=z.get("front_txt_feats"), **drop)
        c.txt, c.txt_attns = lang(model, c.zd)
        c.txt_kv = self.hoisted_kv(model, c.txt)
        if kdl:
            c.t_txt, c.t_txt_attns = lang(teacher, c.t_zd)
            c.t_txt_kv = self.hoisted_kv(teacher, c.t_txt)
            if awt == "learned_weight":
                c.s_learned = model.kd_ability_weights()
                if c.icod:
                    c.t_learned = teacher.kd_ability_weights()
            elif awt == "grad" and ability_grads is not None:
                c.ab_static = L.grad_softmax_weights(
                    torch.as_tensor(np.asarray(ability_grads, np.float32),
                                    device=dev), distill.rw_temp)

        halves = ("tf", "dg") if fused else (None,)
        ml = t_ml = torch.zeros(2 if fused else (), device=dev)
        kd = {h: D.zero_kd_losses(dev) for h in halves}
        t_kd = {h: D.zero_kd_losses(dev) for h in halves}
        step = self._train_step
        if remat:
            # the step draws from its own generator only, so the default
            # generators' states need no saving
            kw = {"use_reentrant": False, "preserve_rng_state": False}
            if remat not in (True, "full"):
                kw["context_fn"] = selective_remat(remat, self.remat_ops)
            step = lambda *args: checkpoint(self._train_step, *args, **kw)
        recs = []
        for t_step in range(self.env.max_action_len):
            state, rec = step(state, t_step, seed, c)
            ml, t_ml = ml + rec["ml"], t_ml + rec["t_ml"]
            for h in halves:
                if rec["kd"] is not None:
                    kd[h] = D.add_losses(kd[h], rec["kd"][h])
                if rec["t_kd"] is not None:
                    t_kd[h] = D.add_losses(t_kd[h], rec["t_kd"][h])
            recs.append(rec)
        aux = self._aux(state, [r["chosen"] for r in recs],
                        [r["live0"].sum() for r in recs])
        both = lambda acc: (D.add_losses(acc["tf"], acc["dg"]) if fused
                            else acc[None])
        aux.update({"ml_loss": ml.sum(), "t_ml_loss": t_ml.sum(),
                    "kd_losses": both(kd), "t_kd_losses": both(t_kd)})
        if fused:
            over = state.obs_count > self.env.max_gmap_len - 2
            aux.update({
                "ml_loss_vec": ml, "t_ml_loss_vec": t_ml,
                "kd_losses_tf": kd["tf"], "kd_losses_dg": kd["dg"],
                "t_kd_losses_tf": t_kd["tf"], "t_kd_losses_dg": t_kd["dg"],
                "gmap_overflow_tf": over[:fused_split].sum(),
                "gmap_overflow_dg": over[fused_split:].sum()})
        if train_rl:
            aux.update(_a2c_losses(recs, gamma))
        return aux

    def _targets(self, state, gmap, pano, t_step, imitation, ep):
        """The supervision target in the policy's action space."""
        if self.local_acts:
            return self.teacher_action_local(state, pano, t_step, imitation,
                                             ep)
        return self.teacher_action(state, gmap, t_step, imitation, ep)

    def _explore_mask(self, vp_base):
        """``expl_sample``'s random-action support: the viewpoint branch's
        navigable slots under ``fusion='local'`` (JAX passes
        ``vp_nav_masks``), else the default (unvisited gmap tokens)."""
        return vp_base["vp_nav_masks"] if self.local_acts else None

    def _train_step(self, state: EpisodeBatch, t_step: int, seed: int, c):
        """One training step on a copy of ``state``: both models' forwards
        on the shared token structure, the step's CE, the teacher's CE into
        MKTD weights, one MKRW draw, the MAKD losses (gated on any episode
        being live, as the reference leaves its loop once all have ended),
        each per half in the fused dual rollout, the action, the A2C
        records and the transition.  Returns (state, record): ``chosen``,
        ``live0``, ``ml`` and ``t_ml`` (the CE sums, [2] per half when
        fused), ``kd`` and ``t_kd`` (``{half: KD dict}``, half ``None``
        unless fused, or None), and under ``train_rl`` ``logp``,
        ``entropy``, ``value``, ``live`` and ``reward`` [B]."""
        state = state.copy_for_step()
        gen = self._generator(seed, t_step)
        drop = {"deterministic": c.drop_off, "generator": gen,
                "need_maps": True}
        env = self.env
        live0 = self._stamp(state, t_step)
        pano = self.assemble_pano(state)
        gmap_base = self.assemble_gmap_base(state, c.ep)
        vp_base = self.assemble_vp_base(state, pano, gmap_base, c.ep)
        gmap, outs = self._model_step(self.model, "student", state, pano,
                                      gmap_base, vp_base, c.txt, c.txt_masks,
                                      c.txt_kv, **drop, zd=c.zd,
                                      ensemble_n=c.ensemble_n)
        outs["txt_embeds"], outs["txt_attns"] = c.txt, c.txt_attns
        logits = outs[self.policy_key]
        if c.kdl:
            _, t_outs = self._model_step(
                self.teacher_model, "teacher", state, pano, gmap_base,
                vp_base, c.t_txt, c.txt_masks, c.t_txt_kv, **drop,
                zd=c.t_zd)
            t_outs["txt_embeds"], t_outs["txt_attns"] = c.t_txt, c.t_txt_attns
            t_logits = t_outs[self.policy_key]

        split = c.split
        # the halves' rows (None: the whole batch) and per-half sums
        rows = ({"tf": slice(0, split), "dg": slice(split, None)}
                if split is not None else {None: None})
        sums = (lambda x: x.sum() if split is None
                else torch.stack([x[:split].sum(), x[split:].sum()]))
        zero = torch.zeros(() if split is None else 2, device=logits.device)
        rec = {"live0": live0, "ml": zero, "t_ml": zero, "kd": None,
               "t_kd": None}
        targets = None
        if c.train_ml is not None or c.feedback == "teacher" \
                or split is not None:
            imitation = (c.is_tf if split is not None
                         else c.feedback == "teacher")
            targets = self._targets(state, gmap, pano, t_step, imitation,
                                    c.ep)
            step_ce, _ = L.masked_softmax_ce(logits.float(), targets,
                                             env.ignore_id)
            rec["ml"] = sums(step_ce)
        if c.kdl and c.train_ml is not None:
            d = c.distill
            t_ce, _ = L.masked_softmax_ce(t_logits.float(), targets,
                                          env.ignore_id)
            rec["t_ml"] = sums(t_ce)
            rec["kd"], rec["t_kd"] = {}, ({} if c.icod else None)
            for half, sl in rows.items():
                part = (lambda x: x) if sl is None else _rows(sl)
                t_sw = s_sw = None
                if c.mktd:
                    t_sw = L.mktd_sample_weights(
                        part(t_ce), d.sample_preprocess,
                        d.sample_exp_decay).detach()
                    s_sw = L.mktd_sample_weights(
                        part(step_ce), d.sample_preprocess,
                        d.sample_exp_decay).detach()
                ab_w = (L.mkrw_weights(gen, 5, d.rw_temp, logits.device)
                        if c.rw else c.ab_static)
                gate = dp_any(part(live0)).float()
                s_o, t_o, tg = part(outs), part(t_outs), part(targets)
                step_losses = lambda role, a, b, sw, learned: {
                    k: v * gate for k, v in D.makd_step_losses(
                        d, t_step, a, b, self.model.kd_project, tg, ab_w, sw,
                        learned, role=role, ignore_id=env.ignore_id).items()}
                rec["kd"][half] = step_losses("t2s", s_o, t_o, t_sw,
                                              c.s_learned)
                if c.icod:
                    rec["t_kd"][half] = step_losses("s2t", t_o, s_o, s_sw,
                                                    c.t_learned)

        policy = t_logits if c.kdl and c.use_teacher_policy else logits
        action = self.select_action(policy.detach(), c.feedback, gen,
                                    targets, gmap, self._explore_mask(vp_base),
                                    c.is_tf)
        stop_prob = torch.softmax(policy.detach().float(), dim=-1)[:, 0]
        if c.train_rl:
            logp = torch.log_softmax(policy.float(), dim=-1)
            rec["logp"] = logp.gather(1, action[:, None])[:, 0]
            rec["entropy"] = -(logp.exp() * torch.where(
                torch.isfinite(logp), logp, 0.0)).sum(-1)
            rec["value"] = c.critic(outs["cls_embeds"]).float()
            rec["live"] = (~state.ended).float()
            ended_before = state.ended
            goal_dist = lambda: self.t.dist[state.scan, state.cur, state.goal]
            d_before = goal_dist()
        rec["chosen"] = self.transition(state, gmap, action, stop_prob,
                                        t_step, pano, c.ep, self.local_acts,
                                        c.feedback, is_tf=c.is_tf)
        if c.train_rl:
            d_after = goal_dist()
            bonus = torch.where(d_after < env.error_margin, 2.0, -2.0)
            rec["reward"] = ((d_before - d_after) * rec["live"]
                             + torch.where(state.ended & ~ended_before,
                                           bonus, 0.0))
        return state, rec


def _rows(sl):
    """``tree`` (dicts, lists and tuples of tensors, each batch-major) cut
    to the rows ``sl``."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(take(v) for v in tree)
        return tree[sl] if isinstance(tree, torch.Tensor) else tree

    return take


def _a2c_losses(recs, gamma: float) -> dict:
    """The A2C terms of a rollout's step records (JAX ``rollout.py``
    1451-1468): the returns G_t = r_t + gamma * G_{t+1} * live_t, the
    advantage G_t - V_t without gradient, ``rl_loss`` = -sum(logp * adv *
    live) + 0.5 * sum((V - G)^2 * live) and ``rl_entropy`` = sum(entropy *
    live)."""
    stack = lambda k: torch.stack([r[k] for r in recs])       # [T, B]
    reward, live, value = stack("reward"), stack("live"), stack("value")
    g = torch.zeros_like(reward[0])
    returns = []
    for t in reversed(range(len(recs))):
        g = reward[t] + gamma * g * live[t]
        returns.append(g)
    returns = torch.stack(returns[::-1])
    adv = (returns - value).detach()
    policy_loss = -(stack("logp") * adv * live).sum()
    value_loss = 0.5 * (((value - returns) ** 2) * live).sum()
    return {"rl_loss": policy_loss + value_loss,
            "rl_entropy": (stack("entropy") * live).sum()}


def selective_remat(policy: str, counts: dict | None = None):
    """``context_fn`` of ``torch.utils.checkpoint`` for the remat policies
    of JAX's rollout (``jax.checkpoint_policies``), as selective activation
    checkpointing: the outputs of the ops below are saved in the forward,
    everything else is recomputed in the backward.

    ``dots`` (``dots_with_no_batch_dims_saveable``): the weight products.
    ``nn.Linear`` reaches ``aten.mm`` or ``aten.addmm`` (``F.linear``
    folds a 3-D input to 2-D; with a bias, ``addmm``).  ``dots_all``
    (``dots_saveable``): also the batched products, the attention scores
    and outputs (``aten.bmm``) and the branch-fused trunk's per-branch
    linears (``aten.baddbmm``).  These are the products that the port's
    layers reach (``torch.einsum`` and ``torch.matmul`` reach ``bmm``), on
    the CPU (``tests/test_torch_train_options.py``) and on the card
    (``chip_smoke.py`` phase 8; torch 2.11, H100): a full-width MAKD step
    reaches ``addmm`` 6,544 times and ``bmm`` 2,460 times, and ``mm``
    never (every ``nn.Linear`` there has a bias).  ``counts``: each
    forward op the policy decides on is counted there, by op."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    saved = REMAT_SAVED.get(policy)
    if saved is None:
        raise ValueError(f"invalid remat policy {policy!r}: use 'full', "
                         f"{', '.join(map(repr, REMAT_SAVED))}")

    def decide(ctx, op, *args, **kwargs):
        if counts is not None and not ctx.is_recompute:
            counts[op] = counts.get(op, 0) + 1
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(decide)


_aten = torch.ops.aten
# the ops whose outputs each selective remat policy saves
REMAT_SAVED = {
    "dots": (_aten.mm.default, _aten.addmm.default),
    "dots_all": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                 _aten.baddbmm.default),
}


def _record_hop(nodes, ln, stepping, nxt):
    """Append ``nxt`` to the trajectory ``nodes`` (in place) of the
    ``stepping`` rows and return the new lengths; a full buffer keeps
    overwriting its last slot, as the reference's does."""
    bi = torch.arange(nodes.shape[0], device=nxt.device)
    wi = torch.where(stepping, ln.clamp(max=MAX_TRAJ), MAX_TRAJ)
    nodes[bi, wi] = torch.where(stepping, nxt, nodes[bi, wi])
    return ln + stepping.long()
