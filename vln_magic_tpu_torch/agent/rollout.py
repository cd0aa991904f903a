"""Batched greedy navigation rollout over padded world tables.

Port of ``vln_magic_tpu/agent/rollout.py`` for greedy evaluation: the
episode state (current node, orientation, and the topological map:
visited/observed sets, observation order, averaged node embeddings, stop
scores) is a set of padded tensors, and the time loop runs all
``max_action_len`` steps, masking episodes that have ended, as the
reference's ``lax.scan`` does.  One step is ``Rollout.step``, which takes
per-lane step clocks, so the wave loop (``run``) and the streaming decoder
(``agent/streaming.py``) share it.

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

import numpy as np
import torch

from ..config import EnvConfig, ModelConfig
from ..env.world import WorldTables
from ..utils.device import resolve_device
from . import geometry as geo

BIG = 1_000_000       # obs-order offset separating frontier from visited
UNOBS = 2_000_000     # obs-order value for unobserved nodes
NEG_INF = -1e9
INF_DIST = 1e9        # observed-graph distance of an unreached pair
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

    @classmethod
    def from_world(cls, t: WorldTables, device="cuda") -> "Tables":
        device = resolve_device(device)

        def conv(a):
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.int64)
            return torch.from_numpy(a).to(device)

        return cls(**{f.name: conv(getattr(t, f.name))
                      for f in dataclasses.fields(cls)})

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

    @property
    def batch_size(self) -> int:
        return self.scan.shape[0]


def init_episodes(tables: Tables, scan_idx, start, heading, gt_path, gt_len,
                  hidden_size: int,
                  observed_parity: bool = False) -> EpisodeBatch:
    """Agent at gt_path[0] with the item's heading, elevation 0; the start
    node is visited and it and its candidates are observed.  Inputs may be
    numpy arrays or tensors on the tables' device."""
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
    # the start node carries step id 1 from the outset and is visited
    state.step_ids[bi, start] = 1
    state.visited[bi, start] = True
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
    row_d[bi, v] = 0.0                                        # d(v, v) = 0
    row_s[bi, v] = 0.0

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


def _take(x, idx):
    """``x[b, idx[b, ...]]`` along dim 1 for [B, N] or [B, N, F] ``x``."""
    if x.dim() == 2:
        return x.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)
    flat = idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, x.shape[2])
    return x.gather(1, flat).reshape(*idx.shape, x.shape[2])


class Rollout:
    """Greedy rollout bound to world tables, env config and a model.  It
    runs on the device that ``Tables.from_world`` put the tables on, which
    must be the model's."""

    def __init__(self, tables: Tables, env_cfg: EnvConfig, model):
        model_dev = next(model.parameters()).device
        if model_dev != tables.dist.device:
            raise ValueError(f"model on {model_dev}, tables on "
                             f"{tables.dist.device}")
        self.t = tables
        self.env = env_cfg
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.parity = env_cfg.observed_graph_parity
        self.policy_key = {"dynamic": "fused_logits", "avg": "fused_logits",
                           "global": "global_logits",
                           "local": "local_logits"}[self.cfg.fusion]
        self.local_acts = self.cfg.fusion == "local"

    # ---- step-input assembly -------------------------------------------

    def assemble_pano(self, state: EpisodeBatch) -> dict:
        t = self.t
        b = state.batch_size
        scan, cur = state.scan, state.cur
        cand_ids = t.cand_ids[scan, cur]                      # [B, C]
        cand_mask = t.cand_mask[scan, cur]
        cand_view = t.cand_view[scan, cur]
        feats36 = t.features[scan, cur].float()               # [B, 36, D]
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
                           cand_ids, cand_mask) -> None:
        """Rewrite the current node with the fused pano embedding and add
        candidate-view embeddings into unvisited nodes (averaged on read)."""
        b = state.batch_size
        bi = torch.arange(b, device=cand_ids.device)
        live = ~state.ended
        cur_t = torch.where(live, state.cur, self.t.num_nodes)
        state.embed_sum[bi, cur_t] = pano_fused
        state.embed_cnt[bi, cur_t] = 1.0
        idx = cand_ids.clamp(min=0)
        upd = cand_mask & ~state.visited.gather(1, idx) & live[:, None]
        rows = bi[:, None].expand_as(idx)
        w = upd.float()
        cand_emb = pano_embeds[:, : idx.shape[1]] * w[..., None]
        state.embed_sum.index_put_((rows, idx), cand_emb, accumulate=True)
        state.embed_cnt.index_put_((rows, idx), w, accumulate=True)

    def assemble_gmap(self, state: EpisodeBatch, base: dict) -> dict:
        """Token structure (``base``) + node embeddings and [MEM]."""
        n = self.t.num_nodes
        b = state.batch_size
        node_embed = (state.embed_sum[:, :n]
                      / state.embed_cnt[:, :n].clamp(min=1.0)[..., None])
        tok = _take(node_embed, base["token_node"])
        tok = tok * base["token_valid"][..., None]
        zero = tok.new_zeros((b, 1, tok.shape[-1]))
        img = torch.cat([zero, state.mem[:, None, :], tok], dim=1)
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

    def assemble_vp(self, state: EpisodeBatch, pano_embeds, base: dict) -> dict:
        b = state.batch_size
        d = pano_embeds.shape[-1]
        img = torch.cat([state.mem.new_zeros((b, 1, d)), state.mem[:, None, :],
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

    # ---- transition -----------------------------------------------------

    def transition(self, state: EpisodeBatch, gmap: dict, action, stop_prob,
                   t_step, pano: dict, ep: dict,
                   local_actions: bool = False):
        """Greedy (argmax) transition: record the stop probability, end
        episodes that stop, run out of frontier or of steps, and jump the
        rest to their target, facing along the last edge walked.  ``t_step``
        is the step index, an int or a [B] tensor of per-lane clocks.
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

        just_ended = live & ((action == 0) | gmap["no_vp_left"]
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
            col = ep["nh"].gather(
                2, target[:, None, None].expand(-1, trash, 1))[..., 0]
            p = prev = state.cur
            for _ in range(hops):
                nxt = col.gather(1, p[:, None])[:, 0]
                stepping = moving & (p != target) & (nxt >= 0)
                prev = torch.where(stepping & (nxt == target), p, prev)
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
        state.visited[bi, torch.where(moving, state.cur, trash)] = True
        state.ended = state.ended | just_ended
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
        where no hop reached it; the new trajectory lengths)."""
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

    def step(self, state: EpisodeBatch, ep: dict, txt_embeds, txt_masks,
             txt_kv, lane_t):
        """One greedy step of every lane (state updated in place).
        ``lane_t``: the step index, an int, or a [B] tensor of per-lane
        clocks (streaming), wherever it has per-episode meaning: the step-id
        stamp and the forced stop at ``max_action_len - 1``.

        Returns (chosen target per lane, -1 when not moving; lanes live at
        the top of the step; lanes that ended in it)."""
        model = self.model
        bi = torch.arange(state.batch_size, device=state.cur.device)
        trash = self.t.num_nodes
        # stamp the current node's step id before any forward
        live0 = ~state.ended
        state.step_ids[bi, torch.where(live0, state.cur, trash)] = \
            torch.where(live0, lane_t + 1, state.step_ids[:, trash])
        pano = self.assemble_pano(state)
        gmap_base = self.assemble_gmap_base(state, ep)
        vp_base = self.assemble_vp_base(state, pano, gmap_base, ep)

        pano_embeds, pano_fused, _ = model.panorama(
            pano["view_img_fts"], pano["loc_fts"], pano["nav_types"],
            pano["pano_masks"])
        # the episode state stays f32 whatever the model's dtype
        self.update_node_embeds(state, pano_embeds.float(),
                                pano_fused.float(), pano["cand_ids"],
                                pano["cand_mask"])
        gmap = self.assemble_gmap(state, gmap_base)
        vp = self.assemble_vp(state, pano_embeds, vp_base)
        outs = model.navigation(
            txt_embeds, txt_masks, gmap["gmap_img_embeds"],
            gmap["gmap_step_ids"], gmap["gmap_pos_fts"],
            gmap["gmap_masks"], gmap["gmap_visited_masks"],
            gmap["gmap_pair_dists"], vp["vp_img_embeds"],
            vp["vp_pos_fts"], vp["vp_masks"], vp["vp_nav_masks"],
            vp["gmap_local_slot"], vp["vp_cand_visited"],
            txt_cross_kvs=txt_kv)
        state.mem = outs["cls_embeds"].float()

        logits = outs[self.policy_key]
        action = logits.argmax(dim=-1)
        stop_prob = torch.softmax(logits, dim=-1)[:, 0].float()
        chosen = self.transition(state, gmap, action, stop_prob, lane_t, pano,
                                 ep, self.local_acts)
        return chosen, live0, state.ended & live0

    @torch.no_grad()
    def run(self, state: EpisodeBatch, txt_ids, txt_masks,
            feedback: str = "argmax", ensemble_n: int = 1):
        """Greedy decode of every episode in ``state`` (updated in place).

        Returns aux: ``actions`` [T, B] chosen targets (-1 when not
        moving), ``stop_node``, ``final_cur``, ``semantic_steps`` (episodes
        live at the top of each step, summed), ``gmap_overflow`` and, in
        parity mode, the expanded trajectory ``traj_nodes``/``traj_len``
        with the backtrack appended."""
        if feedback != "argmax":
            raise NotImplementedError(
                f"feedback={feedback!r}: only greedy argmax decoding is "
                "ported to vln_magic_tpu_torch yet (see ROADMAP.md)")
        if ensemble_n != 1:
            raise NotImplementedError("ensemble_n > 1 is not ported yet")
        txt_embeds, _ = self.model.language(txt_ids, txt_masks)
        txt_kv = self.model.text_cross_kv(txt_embeds) \
            if self.cfg.hoist_text_kv else None
        ep = self.episode_tables(state)
        actions, live_n = [], []
        for t_step in range(self.env.max_action_len):
            chosen, live0, _ = self.step(state, ep, txt_embeds, txt_masks,
                                         txt_kv, t_step)
            actions.append(chosen)
            live_n.append(live0.sum())

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


def _record_hop(nodes, ln, stepping, nxt):
    """Append ``nxt`` to the trajectory ``nodes`` (in place) of the
    ``stepping`` rows and return the new lengths; a full buffer keeps
    overwriting its last slot, as the reference's does."""
    bi = torch.arange(nodes.shape[0], device=nxt.device)
    wi = torch.where(stepping, ln.clamp(max=MAX_TRAJ), MAX_TRAJ)
    nodes[bi, wi] = torch.where(stepping, nxt, nodes[bi, wi])
    return ln + stepping.long()
