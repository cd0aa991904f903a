"""Greedy-decode navigation agent (port of
``vln_magic_tpu/agent/navigator.py``): waves, observed-graph parity,
streaming evaluation and evaluation over a device mesh (``use_mesh``)."""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..config import MagicConfig
from ..env.world import World
from ..models.vlnbert import DualScaleVLNBert
from ..parallel.sharding import all_gather, all_reduce_tensors, shard_params
from ..utils.device import resolve_device
from ..utils.weights import init_params, load_flax_params
from .evaluator import (Evaluator, build_trajectories,
                        build_trajectories_observed)
from .rollout import Rollout, Tables, init_episodes


def pad_instructions(items, max_len: int, pad_id: int = 1):
    """[B, L] token ids + mask from variable-length encodings; L is
    bucketed to a multiple of 16, capped at ``max_len``."""
    b = len(items)
    L = min(max(len(it["instr_encoding"]) for it in items), max_len)
    L = min(((L + 15) // 16) * 16, max_len)
    ids = np.full((b, L), pad_id, dtype=np.int64)
    mask = np.zeros((b, L), dtype=bool)
    for i, it in enumerate(items):
        enc = np.asarray(it["instr_encoding"])[:L]
        ids[i, : len(enc)] = enc
        mask[i, : len(enc)] = True
    return ids, mask


def episodes_from_items(tables: Tables, items, hidden_size: int,
                        max_gt_len: int = 24, observed_parity: bool = False,
                        teacher_size: int | None = None, aug: bool = False):
    """The episode state of ``items``; ``aug`` marks every episode as
    reading the tables' aug feature table (EnvEdit)."""
    b = len(items)
    scan = np.array([it["scan_idx"] for it in items], np.int64)
    start = np.array([it["path_idx"][0] for it in items], np.int64)
    heading = np.array([it["heading"] for it in items], np.float32)
    gt_path = np.full((b, max_gt_len), -1, np.int64)
    gt_len = np.zeros((b,), np.int64)
    for i, it in enumerate(items):
        p = np.asarray(it["path_idx"])
        gt_path[i, : len(p)] = p
        gt_len[i] = len(p)
    return init_episodes(tables, scan, start, heading, gt_path, gt_len,
                         hidden_size, observed_parity=observed_parity,
                         teacher_size=teacher_size,
                         aug=np.full((b,), True) if aug else None)


class Navigator:
    """Greedy-decode agent: world tables, the model, and ``evaluate``.

    ``params``: flat flax params (``utils.weights.load_flax_params``);
    without them the weights are random from ``seed`` (default
    ``cfg.train.seed``).  ``device`` defaults to ``"cuda"``."""

    def __init__(self, cfg: MagicConfig, world: World, params=None,
                 seed: int | None = None, device="cuda"):
        self.cfg = cfg
        self.world = world
        self.device = resolve_device(device)
        self.tables = Tables.from_world(world.tables, self.device)
        self.model = DualScaleVLNBert(
            cfg.model, dtype=getattr(torch, cfg.train.compute_dtype),
            device=self.device)
        if params is None:
            init_params(self.model, cfg.train.seed if seed is None else seed)
        else:
            load_flax_params(self.model, params)
        self.rollout = Rollout(self.tables, cfg.env, self.model)
        self._streams = {}
        self.mesh = None

    def use_mesh(self, mesh):
        """Evaluate over a dp x mp mesh (JAX ``use_mesh``; the reference's
        per-rank env slices + all_gather, env.py:126-134,
        main_nav.py:606-607): the model sharded in place
        (``parallel.shard_params``), every wave's rows split over dp, each
        rank decoding its rows and the decodes gathered, so every rank
        returns one process's trajectories and metrics.  Streaming
        evaluation stays off, as JAX's.  The eval batch size must divide
        by dp."""
        dp = mesh.shape.get("dp", 1)
        if self.cfg.train.batch_size % dp != 0:
            raise ValueError(
                f"eval batch_size {self.cfg.train.batch_size} not "
                f"divisible by dp={dp}")
        self.mesh = mesh
        shard_params(self.model, mesh)
        return self

    def run_items(self, items, feedback="argmax", ensemble_n=1, zdicts=None):
        """Decode ``items`` as one wave: (the episode state, the rollout's
        aux).  On a mesh the state is this rank's dp rows, and the aux,
        with the rows' ``stop_scores``, is gathered whole."""
        txt_ids, txt_masks = pad_instructions(items, self.cfg.env.max_instr_len)
        mesh = self.mesh
        if mesh is not None:
            rows = mesh.rows(len(items))
            items, txt_ids, txt_masks = (items[rows], txt_ids[rows],
                                         txt_masks[rows])
        state = episodes_from_items(
            self.tables, items, self.cfg.model.hidden_size,
            observed_parity=self.cfg.env.observed_graph_parity)
        with (mesh.active() if mesh is not None else nullcontext()):
            aux = self.rollout.run(
                state, torch.from_numpy(txt_ids).to(self.device),
                torch.from_numpy(txt_masks).to(self.device), feedback,
                ensemble_n=ensemble_n, zdicts=zdicts)
        if mesh is not None:
            aux = _gather_aux(aux, state, mesh)
        return state, aux

    def evaluate(self, items, feedback="argmax", batch_size=None,
                 ensemble_n=1, detailed_output=False, stream=None,
                 zdicts=None):
        """Greedy decode + metrics over an item list.

        ``zdicts``: ``{"student": build_rollout_zdicts(...)}``, the
        intervention dictionaries (``agent/interventions.py``).
        ``ensemble_n`` > 1: MC-dropout ensembles (``Rollout.run``).

        ``detailed_output``: each prediction also gets ``details``, the
        stop probability of every node the episode recorded one for
        (``{node_id: {"stop_prob": p}}``, the reference's
        ``--detailed_output``, agent.py:1091-1095).
        ``stream``: continuous-batching decode (``agent/streaming.py``):
        ended lanes refill from the item queue.  ``None`` turns it on when
        eligible (argmax, ``ensemble_n == 1``, no ``detailed_output``, not
        parity) and there are more items than ``batch_size``, as the JAX
        package does; ``stream=True`` on an ineligible call raises
        ``ValueError``.  Otherwise the items run in waves of
        ``batch_size``, the tail wave padded with copies of its last
        item."""
        bs = batch_size or self.cfg.train.batch_size
        parity = self.cfg.env.observed_graph_parity
        eligible = (feedback == "argmax" and ensemble_n == 1
                    and not detailed_output and not parity
                    and self.mesh is None)
        if stream is None:
            stream = eligible and len(items) > bs
        if stream:
            if not eligible:
                raise ValueError("stream=True needs argmax feedback, "
                                 "ensemble_n == 1, no detailed_output, no "
                                 "mesh and the full-table (non-parity) "
                                 "path")
            return self._evaluate_stream(items, bs, zdicts)
        preds = []
        gmap_overflow = semantic_steps = 0
        for i in range(0, len(items), bs):
            chunk = items[i : i + bs]
            n_real = len(chunk)
            if n_real < bs:
                chunk = chunk + [chunk[-1]] * (bs - n_real)
            state, aux = self.run_items(chunk, feedback,
                                        ensemble_n=ensemble_n, zdicts=zdicts)
            gmap_overflow += int(aux["gmap_overflow"])
            semantic_steps += int(aux["semantic_steps"])
            host = {k: v.cpu().numpy() for k, v in aux.items()}
            if parity:
                chunk_preds = build_trajectories_observed(
                    self.world, chunk, host["actions"], host["traj_nodes"],
                    host["traj_len"], host["stop_node"], host["final_cur"])
            else:
                chunk_preds = build_trajectories(
                    self.world, chunk, host["actions"], host["stop_node"],
                    host["final_cur"])
            chunk_preds = chunk_preds[:n_real]
            if detailed_output:
                scores = host.get("stop_scores")
                if scores is None:
                    scores = state.stop_scores.cpu().numpy()
                for b, p in enumerate(chunk_preds):
                    g = self.world.graphs[p["scan_idx"]]
                    p["details"] = {
                        g.node_ids[i]: {"stop_prob": float(scores[b, i])}
                        for i in np.flatnonzero(
                            scores[b, : g.num_nodes] > -1e8)}
            preds.extend(chunk_preds)
        avg, per_item = Evaluator(self.world, items).eval_metrics(preds)
        # episodes whose observed-node count outgrew max_gmap_len (tokens
        # truncated), the live episode-steps decoded (padding included) and
        # the steps the lanes ran
        avg["gmap_overflow"] = float(gmap_overflow)
        avg["semantic_steps"] = float(semantic_steps)
        avg["scan_steps"] = float(-(-len(items) // bs)
                                  * self.cfg.env.max_action_len)
        return (avg, per_item), preds

    def stream_eval(self, batch_size=None):
        """The continuous-batching decoder, cached per lane width."""
        from .streaming import StreamEval

        bs = batch_size or self.cfg.train.batch_size
        if bs not in self._streams:
            self._streams[bs] = StreamEval(self.rollout, self.cfg.env, bs)
        return self._streams[bs]

    def _evaluate_stream(self, items, bs, zdicts=None):
        out = self.stream_eval(bs).run(items, self.cfg.env.max_instr_len,
                                       zdicts=zdicts)
        preds = build_trajectories(self.world, items, out["actions"].T,
                                   out["stop_node"], out["final_cur"])
        avg, per_item = Evaluator(self.world, items).eval_metrics(preds)
        avg["gmap_overflow"] = float(out["overflow"].sum())
        avg["semantic_steps"] = float(out["semantic_steps"])
        avg["scan_steps"] = float(out["scan_steps"])
        return (avg, per_item), preds


def _gather_aux(aux: dict, state, mesh) -> dict:
    """A dp-split decode's aux whole on every rank: per-episode tensors
    concatenated over dp along their batch axis (``actions`` [T, B], the
    others [B, ...]; plus the state's ``stop_scores``), counts summed."""
    g = lambda x, dim=0: all_gather(x, mesh.dp_group, mesh.dp, mesh.dp_rank,
                                    dim)
    out = {}
    for k, v in aux.items():
        if v.dim() == 0:
            out[k] = v.clone()
            all_reduce_tensors([out[k].view(1)], mesh.dp_group)
        else:
            out[k] = g(v, 1 if k == "actions" else 0)
    out["stop_scores"] = g(state.stop_scores)
    return out
