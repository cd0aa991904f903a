"""Continuous-batching greedy evaluation (streaming rollout).

Port of ``vln_magic_tpu/agent/streaming.py``.  The wave evaluator
(``Navigator.evaluate`` over waves) runs every wave for all
``max_action_len`` steps: episodes that stop early leave their lane masked
but computing until the wave's slowest episode ends.  Here the lanes draw
from an episode queue instead: at every chunk boundary (``chunk`` steps)
each ended lane is refilled with the next queued episode, from banked
episode metadata and a banked language forward, so the lanes stay nearly
full until the queue drains.

Per-episode outputs are written to [Q]-indexed buffers at the step each
episode ends, and the step is the wave path's own (``Rollout.step`` with
per-lane clocks), so the streamed decode equals the wave decode per episode:

- a refilled lane's state is the same ``init_episodes`` math;
- per-lane step clocks (``lane_t``) stand in for the step index wherever it
  has per-episode meaning (the step-id stamp, the forced stop at
  ``max_action_len - 1``);
- the language forward runs once per episode into a bank, in batches of
  the lane width, and is gathered on refill.

The JAX package runs the whole drain as one device program (its chunk loop
is a ``while_loop``, since every host read crossed the network to a remote
TPU).  Here the chunk loop is a Python loop, and checking whether the queue
has drained is one host read per chunk.

Scope: greedy argmax evaluation on the full-table path.  Observed-graph
parity keeps the wave path.
"""

from __future__ import annotations

import numpy as np
import torch

from .interventions import zdicts_on
from .rollout import (EpisodeBatch, Rollout, _set_at, init_episodes,
                      select_lanes)

__all__ = ["StreamEval"]


def _bcast(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


class StreamEval:
    """Queue-refilled greedy decode over a bank of episodes, on the
    rollout's device."""

    def __init__(self, rollout: Rollout, env_cfg, batch_lanes: int):
        if env_cfg.observed_graph_parity:
            raise ValueError(
                "streaming eval supports the full-table path only; parity "
                "mode keeps the wave evaluator")
        self.ro = rollout
        self.env = env_cfg
        self.lanes = int(batch_lanes)
        # the refill granularity: an ended lane idles at most chunk - 1
        # steps, and every boundary pays a refill and a table hoist
        self.chunk = max(2, env_cfg.max_action_len // 3)
        self.device = rollout.t.dist.device

    # ---- banks ----------------------------------------------------------

    def prepare(self, items, max_instr_len: int, max_gt_len: int = 24):
        """The weight-independent episode bank of a queue of items: world
        metadata and tokenized instructions, padded to a lane multiple with
        repeats of the queue's items and moved to the device once.  Hold it
        to decode the same split again (``run(prepared=...)``)."""
        q_real = len(items)
        items = list(items)
        if q_real == 0:
            raise ValueError("empty item list")
        while len(items) % self.lanes:
            items.append(items[len(items) % q_real])
        q = len(items)
        scan = np.array([it["scan_idx"] for it in items], np.int64)
        start = np.array([it["path_idx"][0] for it in items], np.int64)
        heading = np.array([it["heading"] for it in items], np.float32)
        gt_path = np.full((q, max_gt_len), -1, np.int64)
        gt_len = np.zeros((q,), np.int64)
        for i, it in enumerate(items):
            p = np.asarray(it["path_idx"])[:max_gt_len]
            gt_path[i, : len(p)] = p
            gt_len[i] = len(p)
        # one instruction length for the whole queue (padded positions are
        # masked out of attention, so the decode does not depend on it)
        L = min(max(len(it["instr_encoding"]) for it in items), max_instr_len)
        L = min(((L + 15) // 16) * 16, max_instr_len)
        ids = np.full((q, L), 1, np.int64)
        masks = np.zeros((q, L), dtype=bool)
        for i, it in enumerate(items):
            enc = np.asarray(it["instr_encoding"])[:L]
            ids[i, : len(enc)] = enc
            masks[i, : len(enc)] = True
        dev = lambda a: torch.from_numpy(a).to(self.device)
        return {"q_real": q_real, "scan": dev(scan), "start": dev(start),
                "heading": dev(heading), "gt_path": dev(gt_path),
                "gt_len": dev(gt_len), "txt_ids": dev(ids),
                "txt_masks": dev(masks)}

    @torch.no_grad()
    def build_banks(self, prepared, zdicts=None):
        """The prepared bank plus the weight-dependent language forward
        (text embeddings and, when hoisted, the cross-layer instruction
        K/V; none under ``fuse_branches``), run in batches of the lane
        width, with the student's ``zdicts`` (``Rollout.run``)."""
        model = self.ro.model
        zd = self._zd_for(zdicts)
        embs, kvs = [], []
        q = prepared["scan"].shape[0]
        for i in range(0, q, self.lanes):
            emb, _ = model.language(prepared["txt_ids"][i : i + self.lanes],
                                    prepared["txt_masks"][i : i + self.lanes],
                                    instr_zdict=zd.get("instr_zdict"),
                                    front_txt_feats=zd.get("front_txt_feats"))
            embs.append(emb)
            kv = Rollout.hoisted_kv(model, emb)
            if kv is not None:
                kvs.append(kv)
        banks = {k: v for k, v in prepared.items()
                 if k not in ("q_real", "txt_ids")}
        banks["txt_embeds"] = torch.cat(embs)
        txt_kv = (_map_kv(kvs[0], lambda *xs: torch.cat(xs), *kvs[1:])
                  if kvs else None)
        return banks, txt_kv

    def _zd_for(self, zdicts):
        """The student's dictionaries broadcast over the lanes (every lane
        reads the same, so a refill needs none)."""
        return zdicts_on((zdicts or {}).get("student"), self.lanes,
                         self.device)

    # ---- the chunked loop -----------------------------------------------

    def _init_carry(self, banks, txt_kv):
        b, q = self.lanes, banks["scan"].shape[0]
        t_budget = self.env.max_action_len
        dev = self.device
        lane0 = torch.arange(b, device=dev) % q    # q >= b: q is padded
        state = self._episodes(banks, lane0)
        full = lambda shape, val, dtype=torch.int64: torch.full(
            shape, val, dtype=dtype, device=dev)
        return {
            "state": state,
            "ep_idx": lane0,
            "ptr": full((), min(b, q)),
            "lane_t": full((b,), 0),
            "txt_e": banks["txt_embeds"][lane0],
            "txt_m": banks["txt_masks"][lane0],
            "txt_kv": _map_kv(txt_kv, lambda x: x[lane0]),
            # row q is the trash row of lanes with nothing to record
            "bufs": {"actions": full((q + 1, t_budget), -1),
                     "stop": full((q + 1,), -1), "cur": full((q + 1,), -1),
                     "overflow": full((q + 1,), False, torch.bool),
                     "done": full((q + 1,), False, torch.bool)},
            "sem": full((), 0),
        }

    def _episodes(self, banks, idx) -> EpisodeBatch:
        return init_episodes(
            self.ro.t, banks["scan"][idx], banks["start"][idx],
            banks["heading"][idx], banks["gt_path"][idx],
            banks["gt_len"][idx], self.ro.cfg.hidden_size)

    def _max_chunks(self, q: int) -> int:
        """Drain bound: every episode ends within ``max_action_len`` steps
        of its start, plus fewer than ``chunk`` idle steps before its lane
        refills, and lanes hold an undrained episode until the queue is
        empty."""
        return 2 + ((q // self.lanes + 2)
                    * (self.env.max_action_len + self.chunk)
                    + self.chunk - 1) // self.chunk

    def _refill(self, banks, txt_kv_bank, c) -> None:
        """Assign queued episodes to ended lanes and reset their state and
        text, in place."""
        q = banks["scan"].shape[0]
        state: EpisodeBatch = c["state"]
        e_i = state.ended.long()
        rank = torch.cumsum(e_i, 0) - e_i                 # exclusive prefix
        refill = state.ended & (c["ptr"] + rank < q)
        new_idx = torch.where(refill, (c["ptr"] + rank).clamp(max=q - 1),
                              c["ep_idx"])
        c["state"] = select_lanes(refill, self._episodes(banks, new_idx),
                                  state)
        c["txt_kv"] = _map_kv(c["txt_kv"], lambda cur, bank: torch.where(
            _bcast(refill, cur), bank[new_idx], cur), txt_kv_bank)
        c["ep_idx"] = new_idx
        c["ptr"] = c["ptr"] + refill.sum()
        c["lane_t"] = torch.where(refill, 0, c["lane_t"])
        c["txt_e"] = torch.where(_bcast(refill, c["txt_e"]),
                                 banks["txt_embeds"][new_idx], c["txt_e"])
        c["txt_m"] = torch.where(_bcast(refill, c["txt_m"]),
                                 banks["txt_masks"][new_idx], c["txt_m"])

    def _step(self, ep, q, c, zd=None) -> None:
        """One step of every lane (``Rollout.step`` on per-lane clocks),
        then the per-episode records, in place."""
        ro, env = self.ro, self.env
        state: EpisodeBatch = c["state"]
        bufs = c["bufs"]
        ep_idx, lane_t = c["ep_idx"], c["lane_t"]
        chosen, live0, just_ended, _ = ro.step(state, ep, c["txt_e"],
                                               c["txt_m"], c["txt_kv"], lane_t,
                                               zd=zd)
        # this step's action into the episode's row (dead lanes: trash row)
        row = torch.where(live0, ep_idx, q)
        bufs["actions"][row, lane_t.clamp(max=env.max_action_len - 1)] = chosen
        # an episode's results the moment it ends: its lane's state is final
        erow = torch.where(just_ended, ep_idx, q)
        bufs["stop"][erow] = ro.final_stop_node(state)
        bufs["cur"][erow] = state.cur
        bufs["overflow"][erow] = state.obs_count > env.max_gmap_len - 2
        _set_at(bufs["done"], erow, True)
        c["lane_t"] = lane_t + live0.long()
        c["sem"] = c["sem"] + live0.sum()

    # ---- the decode -----------------------------------------------------

    @torch.no_grad()
    def run(self, items=None, max_instr_len=None, prepared=None,
            zdicts=None):
        """Decode every episode in ``items`` through the refilled lanes.

        Returns per-episode numpy outputs: ``actions`` [Q, T] (chosen target
        per step, -1 once stopped), ``stop_node`` [Q], ``final_cur`` [Q],
        ``overflow`` [Q] bool, and ``semantic_steps``, ``scan_steps`` (steps
        run) and ``chunks``.  ``prepared=self.prepare(items, max_instr_len)``
        reuses the item bank across decodes of the same split.  ``zdicts``:
        the student's intervention dictionaries, as ``Rollout.run``."""
        if prepared is None:
            if items is None or max_instr_len is None:
                raise ValueError("run() needs items+max_instr_len or "
                                 "prepared=")
            prepared = self.prepare(items, max_instr_len)
        q_real = prepared["q_real"]
        banks, txt_kv_bank = self.build_banks(prepared, zdicts)
        zd = self._zd_for(zdicts)
        q = banks["scan"].shape[0]
        c = self._init_carry(banks, txt_kv_bank)
        max_chunks = self._max_chunks(q)
        chunks = 0
        while chunks < max_chunks and not self._drained(c, q):
            self._refill(banks, txt_kv_bank, c)
            # per-episode world-table slices, hoisted per chunk
            ep = self.ro.episode_tables(c["state"])
            for _ in range(self.chunk):
                self._step(ep, q, c, zd)
            chunks += 1
        if not self._drained(c, q):
            raise RuntimeError("streaming eval failed to drain the queue in "
                               f"{max_chunks} chunks (bug)")
        bufs = {k: v[:q_real].cpu().numpy() for k, v in c["bufs"].items()}
        if not bufs["done"].all():
            raise RuntimeError("an episode was left undecoded (bug)")
        return {
            "actions": bufs["actions"], "stop_node": bufs["stop"],
            "final_cur": bufs["cur"], "overflow": bufs["overflow"],
            "semantic_steps": int(c["sem"]),
            "scan_steps": chunks * self.chunk, "chunks": chunks,
        }

    @staticmethod
    def _drained(c, q) -> bool:
        """Every lane ended and the queue empty: one host read."""
        return bool(c["state"].ended.all() & (c["ptr"] >= q))


def _map_kv(kv, fn, *others):
    """Apply ``fn`` to every tensor of a ``text_cross_kv`` tree (``None``
    where no K/V is hoisted), zipped with the same tensors of ``others``."""
    if kv is None:
        return None
    return {branch: [None if layer is None else tuple(
        fn(x, *(o[branch][i][j] for o in others))
        for j, x in enumerate(layer))
        for i, layer in enumerate(layers)]
        for branch, layers in kv.items()}
