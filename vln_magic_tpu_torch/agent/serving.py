"""Online step-at-a-time navigation serving (robot deployment).

Port of ``vln_magic_tpu/agent/serving.py``:

    server = NavServer(cfg, params, device="cuda")
    server.warmup()                              # builds the CUDA kernels
    sess = server.new_session(instr_tokens)      # one per episode
    while True:
        plan = sess.step(Observation(node=..., position=..., heading=...,
                                     pano_feats=..., candidates=[...]))
        if plan.stop:
            break
        # drive the robot along plan.path; observe at plan.target
    final = sess.finish()   # stop-score backtrack (agent.py:1080-1095)

A session builds its topological map from the robot's own observations:
the information state of the reference's GraphMap (observed-graph parity,
``agent/rollout.py`` ``relax_observed``), so observations replayed from a
world give the decisions of the offline parity rollout.  ``NavFleet``
advances K sessions in one batched step per control tick; a session of
``NavServer.new_session`` lives in a one-slot fleet of its own, so every
decision is a fleet tick.

What crosses between host and device.  The host keeps each session's map
as small numpy mirrors; the device keeps the episode state, the language
encoding and a feature bank of 36 view rows per node.  Every
host-to-device copy of the serving loop goes through ``NavServer._upload``
(a restore copies the blob's arrays besides):

- a session start (or a fleet join) makes one host-to-device copy, the
  instruction's ids and mask as one int64 buffer; ``new_session`` encodes
  it at once, a fleet in its next tick, every instruction joined since the
  last tick in one batched forward;
- a decision, or a fleet tick for all K lanes, makes one host-to-device
  copy, an f32 buffer [K, 7 + P + 36 D] holding each lane's control values
  (submit, is_first, moved, node, heading, step, feature row index:
  ``CTL``), its packed mirrors (P values) and its arrival node's feature
  row, which is written into the bank in place; and one device-to-host
  copy, the packed int64 result.  The buffer is the fleet's own, made once
  (pinned on the card): each session's mirrors are views of its slot's
  row, so a tick writes only what changed, and waits for the previous
  copy out of the buffer to end before it does;
- ``finish`` makes one copy each way.

A tick runs the step on ``EpisodeBatch.copy_for_step`` and merges lane by
lane, so a lane that does not submit comes back bit for bit.

Formats (torch counterparts of JAX's, which this package cannot read):

- *Session blob*: one ``.npz`` (``np.savez``, read with
  ``allow_pickle=False``) with JAX's keys: ``instr``, ``state.<field>``
  per ``EpisodeBatch`` field, ``features`` [1, n, 36, D] with any row still
  queued folded in, ``mirrors.<name>``, ``names``, ``traj``, ``t_step``,
  ``last_moved``, ``cur``, ``ended``.  ``state.scan`` is 0, so a blob from
  a fleet slot restores on a server and the other way round.
- *Bundle*: a directory with ``meta.json`` (``BUNDLE_FORMAT``, the config,
  the node and candidate budgets, ``quantized``, ``zdicts_baked``, the
  torch and CUDA versions and the exporting device), ``params.npz`` (flat
  flax names; int8 leaves as ``<name>.__int8__``, ``<name>.scale``,
  ``<name>.dtype``) and, when the server had intervention dictionaries,
  ``zdicts.npz`` (the student's, under dotted names:
  ``instr_zdict.direction_features``, ``front_txt_feats``, ...).  It holds
  no compiled program: the kernels build from the package's sources at
  first use, which ``warmup`` pays.

One thread drives a fleet: a tick points the fleet's rollout at its lanes'
tables.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import MagicConfig, config_from_dict, config_to_dict
from ..env import geometry as geo
from ..models.vlnbert import DualScaleVLNBert
from ..utils import quantize as Q
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.weights import export_flax_params, load_flax_params
from .interventions import flat_zdicts, nested_zdicts, zdicts_on
from .rollout import (EpisodeBatch, Rollout, Tables, _observe, init_episodes,
                      relax_observed, select_lanes)
from .streaming import _map_kv

__all__ = ["Candidate", "Observation", "NavDecision", "observation_from_world",
           "NavServer", "NavSession", "NavFleet", "BUNDLE_FORMAT"]

BUNDLE_FORMAT = "vln_magic_tpu_torch.serving_bundle.v1"
# columns of the control block at the head of each lane's upload row
CTL = ("submit", "is_first", "moved", "node", "heading", "t_step", "feat_v")
(SUBMIT, IS_FIRST, MOVED, NODE, HEADING, T_STEP, FEAT_V) = range(len(CTL))
# the mirrors after the control block, in order; the integer tables are
# exact f32 values there and int32 in a session blob
MIRRORS = ("pos", "dist", "cand_ids", "cand_dist", "cand_view",
           "cand_heading", "cand_elev")
INT_MIRRORS = ("cand_ids", "cand_view")


@dataclasses.dataclass
class Candidate:
    """A navigable neighbor visible from the current node.

    ``view``: discretized 30-degree view index (0..35) the neighbor is
    visible in; synthesized from the relative geometry when None (the
    nearest-view rule of the offline world builder, env/world.py).
    ``dist``: traversal distance of the edge (odometry / connectivity).
    """

    node: str
    position: tuple[float, float, float]
    dist: float
    heading: float | None = None      # absolute heading cur -> node
    elevation: float | None = None
    view: int | None = None


@dataclasses.dataclass
class Observation:
    """What the robot reports on arriving at a node.  ``heading`` is only
    read at episode start (afterwards the session tracks pose through its
    own transitions, as the offline rollout does)."""

    node: str
    position: tuple[float, float, float]
    heading: float
    pano_feats: np.ndarray            # [36, D] view features (CLIP)
    candidates: list[Candidate]


@dataclasses.dataclass
class NavDecision:
    stop: bool
    target: str | None                # chosen map node (None when stopping)
    path: list[str]                   # planned hops cur -> target (incl.)
    action_index: int                 # raw gmap-token action
    latency_ms: float                 # wall time of this decision


def observation_from_world(world, scan_idx: int, v: int,
                           heading: float) -> Observation:
    """Replay client: what a robot standing at node ``v`` of an offline
    ``env.world.World`` would report.  A deployment builds
    :class:`Observation` from live sensors instead.  Sessions intern nodes
    in observation order, so map names back with ``world.graphs[s].index``."""
    t = world.tables
    g = world.graphs[scan_idx]
    cands = []
    for j in range(t.cand_ids.shape[2]):
        if not t.cand_mask[scan_idx, v, j]:
            continue
        ci = int(t.cand_ids[scan_idx, v, j])
        cands.append(Candidate(
            node=g.node_ids[ci],
            position=tuple(t.positions[scan_idx, ci]),
            dist=float(t.cand_dist[scan_idx, v, j]),
            heading=float(t.cand_heading[scan_idx, v, j]),
            elevation=float(t.cand_elevation[scan_idx, v, j]),
            view=int(t.cand_view[scan_idx, v, j])))
    return Observation(
        node=g.node_ids[v], position=tuple(t.positions[scan_idx, v]),
        heading=heading,
        pano_feats=np.asarray(t.features[scan_idx, v], np.float32),
        candidates=cands)


class NavServer:
    """Serving endpoint: owns the model, its intervention dictionaries on
    the device and the upload layout, shared by every session.  Each
    session lives in a one-slot :class:`NavFleet` of its own on this model,
    so a decision is a fleet tick at one lane.

    ``params``: flat flax names (``utils.weights.load_flax_params``), or
    ``model``: an existing ``DualScaleVLNBert`` on ``device``, used as it
    is; give one of the two.  ``cfg.env.observed_graph_parity`` is forced
    on.  ``max_nodes`` defaults from ``cfg.env.max_gmap_len`` minus the
    [stop]/[mem] slots, the dataset's own node budget.  ``device`` defaults
    to ``"cuda"`` and raises without a GPU unless ``"cpu"`` is asked for.
    ``zdicts``: ``{"student": build_rollout_zdicts(...)}``, the
    intervention dictionaries of every session, copied to the device once.
    """

    def __init__(self, cfg: MagicConfig, params=None,
                 max_nodes: int | None = None, max_cands: int = 10,
                 model: DualScaleVLNBert | None = None, device="cuda",
                 zdicts: dict | None = None):
        self.cfg = cfg = dataclasses.replace(
            cfg, env=dataclasses.replace(cfg.env, observed_graph_parity=True))
        self.device = resolve_device(device)
        if (params is None) == (model is None):
            raise ValueError("NavServer takes params (flat flax names) or "
                             "a model, one of the two")
        if model is None:
            model = DualScaleVLNBert(
                cfg.model, dtype=getattr(torch, cfg.train.compute_dtype),
                device=self.device)
            load_flax_params(model, params)
        elif next(model.parameters()).device.type != self.device.type:
            raise ValueError(f"model on {next(model.parameters()).device}, "
                             f"server on {self.device}")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self._zd = zdicts_on((zdicts or {}).get("student"), None, self.device)
        if max_nodes is None:
            max_nodes = max(cfg.env.max_gmap_len - 2, 2)
        n = self.n = max_nodes
        c = self.c = max_cands
        self.d = cfg.model.image_feat_size
        # the packed mirrors: positions, distances, then five candidate
        # tables (ids, dist, view, heading, elevation); ints exact in f32
        sizes = [n * 3, n * n] + [n * c] * 5
        self._off = np.cumsum([0] + sizes)
        self._width = len(CTL) + int(self._off[-1]) + 36 * self.d
        self._copied = None    # the event at the end of the last upload

    # ---- host <-> device ------------------------------------------------

    def _upload(self, host) -> torch.Tensor:
        """The one host-to-device copy of a session start, decision, tick or
        finish, from a numpy array or a host tensor.  On the card it goes
        through pinned memory (PyTorch's caching host allocator keeps a
        block it pins until the copy is done; a fleet's upload buffer is
        pinned already) as one asynchronous DMA copy, whose end
        ``_copied`` marks."""
        x = host if isinstance(host, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type != "cuda":
            return x.clone()
        out = (x if x.is_pinned() else x.pin_memory()).to(self.device,
                                                           non_blocking=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record()
        return out

    def _writable(self):
        """Wait until no copy out of host memory is in flight (the last
        upload's event; a copy that a failed tick left too)."""
        if self._copied is not None:
            self._copied.synchronize()

    def _new_bank(self, k: int) -> torch.Tensor:
        """A feature bank [k, n + 1, 36, D] f32; row n is the trash row
        that a lane with no new feature row writes."""
        return torch.zeros((k, self.n + 1, 36, self.d), dtype=torch.float32,
                           device=self.device)

    # ---- the device side ------------------------------------------------

    def _split(self, buf):
        """An upload [k, width] as (control [k, 7], mirrors [k, P], feature
        rows [k, 36, D])."""
        p = len(CTL) + int(self._off[-1])
        return (buf[:, :len(CTL)], buf[:, len(CTL):p],
                buf[:, p:].reshape(buf.shape[0], 36, self.d))

    @staticmethod
    def _write_rows(bank, ctl, rows):
        """Each lane's arrival feature row into its bank, in place."""
        k = bank.shape[0]
        bank[torch.arange(k, device=bank.device), ctl[:, FEAT_V].long()] = rows

    def _unpack_tables(self, packed, bank) -> Tables:
        """Per-lane packed mirrors [k, P] -> ``Tables`` with the lane as the
        scan axis (each session owns its map); JAX's ``_unpack_tables`` and
        ``_unpack_fleet``.  steps/next_hop are unread in parity mode."""
        n, c, off = self.n, self.c, self._off
        k = packed.shape[0]
        part = lambda i, shape: packed[:, off[i]:off[i + 1]].reshape(
            (k,) + shape)
        cand_ids = part(2, (n, c)).long()
        unread = torch.zeros((), dtype=torch.int64,
                             device=packed.device).expand(k, n, n)
        return Tables(
            node_mask=torch.ones((k, n), dtype=torch.bool,
                                 device=packed.device),
            positions=part(0, (n, 3)), dist=part(1, (n, n)),
            steps=unread, next_hop=unread, cand_ids=cand_ids,
            cand_dist=part(3, (n, c)), cand_view=part(4, (n, c)).long(),
            cand_heading=part(5, (n, c)), cand_elevation=part(6, (n, c)),
            cand_mask=cand_ids >= 0, features=bank[:, :n])

    def _blank_tables(self, bank) -> Tables:
        """Tables of k empty maps, made on the device."""
        k = bank.shape[0]
        packed = torch.zeros((k, int(self._off[-1])), device=self.device)
        packed[:, self._off[2]:self._off[3]].fill_(-1)
        return self._unpack_tables(packed, bank)

    def _zd_for(self, b: int) -> dict:
        """The student's dictionaries broadcast over ``b`` lanes: views of
        the device copy made at construction, so a step copies nothing."""
        return zdicts_on(self._zd, b, self.device)

    @torch.no_grad()
    def _lang(self, ids_buf):
        """The instruction encoding from an uploaded int64 buffer of ids and
        mask, [2, L] for one instruction or [m, 2, L] for m: (text
        embeddings [m, L, H], mask [m, L], the hoisted cross-layer K/V or
        None), m = 1 for [2, L]."""
        if ids_buf.dim() == 2:
            ids_buf = ids_buf[None]
        ids, mask = ids_buf[:, 0], ids_buf[:, 1].bool()
        zd = self._zd_for(ids.shape[0])
        emb, _ = self.model.language(ids, mask,
                                     instr_zdict=zd.get("instr_zdict"),
                                     front_txt_feats=zd.get("front_txt_feats"))
        return emb, mask, Rollout.hoisted_kv(self.model, emb)

    # ---- sessions -------------------------------------------------------

    def new_session(self, instr_encoding) -> "NavSession":
        """A session in a one-slot fleet of its own, its instruction
        encoded now, so that no decision's ``latency_ms`` holds it."""
        return self._alone(lambda group: group.join(instr_encoding))

    def _alone(self, start) -> "NavSession":
        """``start(group)``'s session in a new one-slot :class:`NavFleet` on
        this server's model and device dictionaries (``zdicts_on`` copies
        nothing already on the device), its instruction encoded at once."""
        group = NavFleet(self.cfg, model=self.model, slots=1,
                         max_nodes=self.n, max_cands=self.c,
                         device=self.device, zdicts={"student": self._zd})
        sess = start(group)
        with span("fleet.language"):
            group._encode_pending()
        return sess

    def warmup(self):
        """Run every per-step path once before the first real episode:
        the first call builds the CUDA kernels (nvcc) and sets up cuBLAS,
        which a robot must not pay mid-episode.  A first and a second
        decision and a finish go through a session's own ``step`` and
        ``finish``; on a :class:`NavFleet` the session takes a slot, so the
        tick runs at the fleet's K lanes, and the slot is released after."""
        start = self.join if isinstance(self, NavFleet) else self.new_session
        sess = start(np.zeros((4,), np.int64))
        for _ in range(2):
            # a first decision that stops must not leave the next-step tick
            # cold: the second runs all the same (nodes 0 and 1 below)
            sess._ended = False
            here = max(sess._cur, 0)
            sess.step(Observation(
                f"__warm{here}", (float(here), 0.0, 0.0), 0.0,
                np.zeros((36, self.d), np.float32),
                [Candidate(f"__warm{1 - here}", (float(1 - here), 0.0, 0.0),
                           1.0)]))
        sess.finish()
        sess.fleet.release(sess.slot)

    # ---- deployment bundles ---------------------------------------------

    def export_bundle(self, path: str, quantize: bool = False):
        """Write a deployment directory: ``meta.json`` and ``params.npz``
        (module docstring).  ``quantize`` stores the weights per-channel
        int8 (``utils.quantize``, the values JAX's bundle holds) for a file
        about a quarter the size; ``from_bundle`` dequantizes at load, so
        only the weights carry the rounding."""
        os.makedirs(path, exist_ok=True)
        flat = export_flax_params(self.model)
        if quantize:
            flat = Q.flatten(Q.quantize_params(flat))
        with open(os.path.join(path, "params.npz"), "wb") as f:
            np.savez(f, **flat)
        zd = flat_zdicts(self._zd)
        if zd:
            with open(os.path.join(path, "zdicts.npz"), "wb") as f:
                np.savez(f, **zd)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({
                "format": BUNDLE_FORMAT,
                "config": config_to_dict(self.cfg),
                "max_nodes": self.n, "max_cands": self.c,
                "quantized": bool(quantize),
                "zdicts_baked": bool(zd),
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda,
                "device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
            }, f, indent=2)

    @classmethod
    def from_bundle(cls, path: str, device="cuda", **kw):
        """A server (or, on ``NavFleet``, a fleet; ``kw`` its other
        arguments) from an ``export_bundle`` directory, with the bundle's
        intervention dictionaries: it takes no ``zdicts`` of its own, as
        JAX's does not.  A JAX bundle (``vln_magic_tpu.serving_bundle.*``)
        raises ``ValueError``."""
        if "zdicts" in kw:
            raise TypeError("from_bundle takes no zdicts: a bundle serves "
                            "the dictionaries it was exported with")
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):
            raise ValueError(f"not a serving bundle: {path} has no meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        fmt = meta.get("format")
        if fmt != BUNDLE_FORMAT:
            if isinstance(fmt, str) and \
                    fmt.startswith("vln_magic_tpu.serving_bundle."):
                raise ValueError(
                    f"{path} is a JAX serving bundle ({fmt}): its programs "
                    f"are serialized StableHLO, which has no PyTorch "
                    f"runtime, and its weights are flax msgpack.  Export a "
                    f"{BUNDLE_FORMAT} bundle with this package's "
                    f"NavServer.export_bundle")
            raise ValueError(f"not a serving bundle: {path} has format "
                             f"{fmt!r}, this package reads {BUNDLE_FORMAT}")
        params = Q.load_quantized(os.path.join(path, "params.npz"))
        zdicts = None
        if meta.get("zdicts_baked"):
            with np.load(os.path.join(path, "zdicts.npz"),
                         allow_pickle=False) as z:
                zdicts = {"student": nested_zdicts(dict(z))}
        return cls(config_from_dict(meta["config"]), params,
                   max_nodes=int(meta["max_nodes"]),
                   max_cands=int(meta["max_cands"]), device=device,
                   zdicts=zdicts, **kw)


class NavSession:
    """One episode: its node names and trajectory record, in slot ``slot``
    of a :class:`NavFleet`, whose batched buffers hold its map's host
    mirrors (views of the slot's row of the fleet's upload buffer), device
    state, feature rows and instruction encoding.  Obtain with
    :meth:`NavServer.new_session` (a one-slot fleet of its own) or
    :meth:`NavFleet.join`, which uploads the instruction and leaves it
    pending: the fleet's next tick encodes it, and a tick that fails keeps
    it pending."""

    def __init__(self, fleet: "NavFleet", slot: int, instr_encoding):
        self.fleet, self.slot = fleet, slot
        self.cfg = fleet.cfg
        self._instr = np.asarray(instr_encoding)
        self.n, self.c = fleet.n, fleet.c
        self._ids: dict[str, int] = {}
        self._names: list[str] = []
        self.t_step = 0
        self._last_moved = False
        self._cur = -1            # host-tracked current node index
        self._started = False
        self._ended = False
        self._traj: list[str] = []
        fleet._pending_instr[slot] = fleet._upload(self._instr_buf())

    def _instr_buf(self) -> np.ndarray:
        """[2, L] int64: the ids padded to ``max_instr_len`` with 1, and
        the mask."""
        L = self.cfg.env.max_instr_len
        buf = np.zeros((2, L), np.int64)
        buf[0] = 1
        enc = self._instr[:L]
        buf[0, :len(enc)] = enc
        buf[1, :len(enc)] = 1
        return buf

    # ---- world ingestion ------------------------------------------------

    def _intern(self, name: str) -> int:
        if name not in self._ids:
            self._ids[name] = len(self._names)
            self._names.append(name)
        return self._ids[name]

    def _check(self, obs: Observation):
        """Reject an observation before anything changes: one at another
        node than the session's current one, too many candidates, features
        of the wrong shape, or more nodes than ``max_nodes``."""
        if self._started and obs.node != self._names[self._cur]:
            raise ValueError(
                f"observation at '{obs.node}' but the session's current "
                f"node is '{self._names[self._cur]}'")
        if len(obs.candidates) > self.c:
            raise ValueError(
                f"{len(obs.candidates)} candidates > max_cands={self.c}")
        shape = np.shape(obs.pano_feats)
        if shape != (36, self.cfg.model.image_feat_size):
            raise ValueError(f"pano_feats must be [36, "
                             f"{self.cfg.model.image_feat_size}], got {shape}")
        new = {obs.node, *(cand.node for cand in obs.candidates)}
        if len(self._names) + len(new - self._ids.keys()) > self.n:
            raise ValueError(
                f"max_nodes={self.n} exhausted; raise NavServer max_nodes "
                f"for larger deployment sites")

    def _put_feature_row(self, v: int, row: np.ndarray):
        # queued for the next tick's upload, keyed by slot: a session
        # observes one node per tick
        self.fleet._pending_rows[self.slot] = (v, row)

    def _record(self, out: np.ndarray, obs: Observation, pre_len: int,
                latency_ms: float) -> NavDecision:
        """Advance the host record by one decision's packed result."""
        chosen, ended, action, traj_len = (int(x) for x in out[:4])
        if not self._traj:
            self._traj = [obs.node]
        self.t_step += 1
        self._last_moved = chosen >= 0
        self._ended = bool(ended) or chosen < 0
        path = []
        if chosen >= 0:
            self._cur = chosen
            path = [self._names[i] for i in out[4 + pre_len:4 + traj_len]]
            self._traj.extend(path)
        elif self._cur < 0:
            self._cur = self._ids[obs.node]
        return NavDecision(
            stop=self._ended,
            target=self._names[chosen] if chosen >= 0 else None,
            path=path, action_index=action, latency_ms=latency_ms)

    # ---- control-loop API -----------------------------------------------

    def step(self, obs: Observation) -> NavDecision:
        """One decision: a tick of the session's fleet in which this slot
        submits the robot's observation at its current node."""
        return self.fleet.step({self.slot: obs})[self.slot]

    def finish(self) -> dict:
        """Backtrack to the best stop-score node (agent.py:1080-1095) and
        return the final trajectory record."""
        return self.fleet.finish(self.slot)

    def _final(self, out: np.ndarray) -> dict:
        stop_node, tl = int(out[0]), int(out[1])
        backtrack = [self._names[i] for i in out[2 + len(self._traj):2 + tl]]
        return {"stop_node": self._names[stop_node],
                "trajectory": self._traj + backtrack, "steps": self.t_step}

    # ---- crash recovery -------------------------------------------------

    def save(self, path: str):
        """Write the session blob (module docstring) so that a crashed
        control process resumes the episode where it stopped: the slot's
        state and feature rows out of the fleet's buffers, ``state.scan``
        0, any row still queued folded in.  It restores on a
        :class:`NavServer` (:meth:`restore`) or in a fleet slot
        (:meth:`NavFleet.restore_session`)."""
        f, slot = self.fleet, self.slot
        features = f._features[slot:slot + 1, :f.n].cpu().numpy().copy()
        pending = f._pending_rows.get(slot)
        if pending is not None:
            features[0, pending[0]] = pending[1]
        blob = {"instr": self._instr, "features": features,
                "names": np.asarray(self._names, dtype=str),
                "traj": np.asarray(self._traj, dtype=str),
                "t_step": np.int64(self.t_step),
                "last_moved": np.bool_(self._last_moved),
                "cur": np.int64(self._cur), "ended": np.bool_(self._ended)}
        for name, arr in self._mirrors().items():
            blob[f"mirrors.{name}"] = (arr.astype(np.int32)
                                       if name in INT_MIRRORS else arr)
        if self._started:
            state = f._lane_state(slot)
            for fl in dataclasses.fields(EpisodeBatch):
                x = getattr(state, fl.name)
                if x is not None:
                    blob[f"state.{fl.name}"] = x.cpu().numpy()
        with open(path, "wb") as out:
            np.savez(out, **blob)

    def _mirrors(self) -> dict:
        """The map's mirrors by name (``MIRRORS``): views of the slot's row
        of the fleet's upload buffer, all f32."""
        return {name: m[self.slot] for name, m in self.fleet._m.items()}

    def _restore_host(self, blob: dict):
        self.fleet._writable()
        for name, arr in self._mirrors().items():
            got = blob[f"mirrors.{name}"]
            if got.shape != arr.shape:
                raise ValueError(f"session blob mirror {name} is "
                                 f"{got.shape}, this server's {arr.shape} "
                                 f"(max_nodes={self.n}, max_cands={self.c})")
            arr[:] = got
        self._names = [str(x) for x in blob["names"]]
        self._ids = {nm: i for i, nm in enumerate(self._names)}
        self._traj = [str(x) for x in blob["traj"]]
        self.t_step = int(blob["t_step"])
        self._last_moved = bool(blob["last_moved"])
        self._cur = int(blob["cur"])
        self._ended = bool(blob["ended"])

    @classmethod
    def restore(cls, server: NavServer, path: str) -> "NavSession":
        """A session from a blob that :meth:`save` wrote, on a (re)started
        server: :meth:`NavFleet.restore_session` into a one-slot fleet of
        its own, the instruction encoded again at once."""
        return server._alone(lambda group: group.restore_session(path))


class NavFleet(NavServer):
    """Batched serving: ``slots`` concurrent episodes advance in one
    batched step per control tick, which pays the host's per-step cost
    once for K robots.

    Synchronous ticks: every session with an observation is stepped
    together; sessions at different phases coexist (per-lane ``is_first``
    and step clocks).  Lanes that do not submit are frozen: the tick runs
    on a copy of the state and merges lane by lane.  Decisions equal K
    standalone sessions' (tests/test_torch_fleet.py), which are fleets of
    one slot.  A tick makes one host-to-device copy and one device-to-host
    copy (module docstring).

    A join uploads its instruction and encodes nothing: the next tick
    encodes every instruction joined since the last one in one
    ``language`` forward at their number, before it decides.  An
    instruction stays pending until that encoding is written into the
    slot's text buffers, so a tick that is rejected or fails before keeps
    it; ``release`` drops it.

    ``max_feature_gb`` bounds the feature bank, slots x (max_nodes + 1) x
    36 x D f32, the fleet's largest buffer: the node budget defaults from
    the config, so a large ``max_gmap_len`` cannot allocate gigabytes by
    surprise."""

    def __init__(self, cfg: MagicConfig, params=None, slots: int = 8,
                 max_nodes: int | None = None, max_cands: int = 10,
                 model: DualScaleVLNBert | None = None,
                 max_feature_gb: float = 8.0, device="cuda",
                 zdicts: dict | None = None):
        super().__init__(cfg, params, max_nodes=max_nodes,
                         max_cands=max_cands, model=model, device=device,
                         zdicts=zdicts)
        n, d = self.n, self.d
        feat_gb = slots * (n + 1) * 36 * d * 4 / 1e9
        if feat_gb > max_feature_gb:
            raise ValueError(
                f"NavFleet feature bank would be {feat_gb:.3f} GB "
                f"(slots={slots} x (max_nodes={n} + 1) x 36 views x "
                f"feat={d} f32) > max_feature_gb={max_feature_gb}; lower "
                f"slots/max_nodes/image_feat_size or pass a larger "
                f"max_feature_gb if the card has the memory for it")
        self.k = slots
        self._features = self._new_bank(slots)
        self.rollout = Rollout(self._blank_tables(self._features),
                               self.cfg.env, self.model)
        self._txt = None               # (embeddings, masks, K/V), [K, ...]
        self._state: EpisodeBatch | None = None
        self._sessions: dict[int, NavSession] = {}
        # feature rows observed since the last tick, by slot; cleared once
        # a tick has returned, so a failed tick keeps them for a save
        self._pending_rows: dict[int, tuple[int, np.ndarray]] = {}
        # uploaded [2, L] instructions joined since the last encoding, by
        # slot; cleared once the next tick has written them
        self._pending_instr: dict[int, torch.Tensor] = {}
        self._slot_ids = torch.arange(slots, device=self.device)
        # the tick's upload [K, width], written in place and pinned on the
        # card; ``_m`` views its mirrors as [K, ...] tables by name
        self._staging = torch.empty((slots, self._width),
                                    dtype=torch.float32,
                                    pin_memory=self.device.type == "cuda")
        self._rows = self._staging.numpy()
        at = len(CTL) + self._off
        shapes = [(n, 3), (n, n)] + [(n, self.c)] * 5
        self._m = {name: self._rows[:, at[i]:at[i + 1]].reshape(
            (slots,) + shape) for i, (name, shape) in
            enumerate(zip(MIRRORS, shapes))}
        self._clear(slice(None))
        self._fed: set[int] = set()    # rows whose feature columns are set

    def _clear(self, at):
        """Rows ``at`` of the upload buffer empty: no control values, empty
        mirrors (candidate ids -1) and no feature row (``FEAT_V`` = n, the
        bank's trash row)."""
        self._rows[at] = 0
        self._m["cand_ids"][at] = -1
        self._rows[at, FEAT_V] = self.n

    def _encode_pending(self):
        """Encode every pending instruction in one batch and write each into
        its slot's text buffers, one indexed copy a buffer."""
        slots = list(self._pending_instr)
        emb, mask, kv = self._lang(
            torch.stack([self._pending_instr[s] for s in slots]))
        if self._txt is None:
            grow = lambda x: x.new_zeros((self.k,) + x.shape[1:])
            self._txt = (grow(emb), grow(mask), _map_kv(kv, grow))
        # the slots' index from views of a device arange: no host copy
        at = torch.cat([self._slot_ids[s:s + 1] for s in slots])
        txt_buf, mask_buf, kv_buf = self._txt
        txt_buf.index_copy_(0, at, emb)
        mask_buf.index_copy_(0, at, mask)
        _map_kv(kv_buf, lambda buf, x: buf.index_copy_(0, at, x), kv)
        self._pending_instr.clear()

    def _empty_state(self) -> EpisodeBatch:
        """The all-lanes holder before any lane has started: every lane
        ended until it submits."""
        tables = self._blank_tables(self._features)
        zeros = torch.zeros(self.k, dtype=torch.int64, device=self.device)
        state = init_episodes(tables, torch.arange(self.k, device=self.device),
                              zeros, zeros.float(), zeros[:, None],
                              torch.ones_like(zeros),
                              self.cfg.model.hidden_size,
                              observed_parity=True)
        state.ended = torch.ones_like(state.ended)
        return state

    def _lane_state(self, slot: int) -> EpisodeBatch:
        """Lane ``slot`` of the fleet state as a one-lane state with
        ``scan`` 0, the blob's layout."""
        lane = EpisodeBatch(**{
            f.name: (None if getattr(self._state, f.name) is None
                     else getattr(self._state, f.name)[slot:slot + 1].clone())
            for f in dataclasses.fields(EpisodeBatch)})
        lane.scan = torch.zeros_like(lane.scan)
        return lane

    @torch.no_grad()
    def _tick(self, buf, state, any_first: bool):
        """One step for every submitting lane: this tick's feature rows
        into the bank, episode init of the lanes that start
        (``is_first``), the deferred arrival registration, then the step:
        step-id stamp -> assembly -> model -> argmax -> transition, with
        this arrival's registration deferred to the next tick
        (``Rollout.transition(defer_observe=True)``).  Returns (the merged
        state, one packed int64 row per lane: [chosen, ended, action,
        traj_len, traj_nodes...]); ``state`` is not written."""
        ctl, packed, rows = self._split(buf)
        self._write_rows(self._features, ctl, rows)
        tables = self._unpack_tables(packed, self._features)
        submit, is_first = ctl[:, SUBMIT] > 0, ctl[:, IS_FIRST] > 0
        if any_first:
            v = ctl[:, NODE].long()
            fresh = init_episodes(
                tables, torch.arange(self.k, device=self.device), v,
                ctl[:, HEADING], v[:, None], torch.ones_like(v),
                self.cfg.model.hidden_size, observed_parity=True)
            state = select_lanes(is_first, fresh, state)
        # the step writes its state in place: run it on a copy whose lanes
        # that do not submit are ended (everything gates on ~ended), then
        # take the submitting lanes back
        eff = state.copy_for_step()
        eff.ended = state.ended | ~submit
        arrival = submit & (ctl[:, MOVED] > 0) & ~is_first & ~state.ended
        relax_observed(eff, tables, eff.cur, arrival)
        _observe(eff, tables)
        r = self.rollout
        r.t = tables
        chosen, _, just_ended, action = r.step(
            eff, r.episode_tables(eff), *self._txt, ctl[:, T_STEP].long(),
            defer_observe=True, zd=self._zd_for(self.k))
        out = torch.cat([torch.stack([chosen, just_ended.long(), action,
                                      eff.traj_len], dim=1),
                         eff.traj_nodes], dim=1)
        return select_lanes(submit & ~state.ended, eff, state), out

    # ---- control-loop API -----------------------------------------------

    def join(self, instr_encoding) -> NavSession:
        """Claim a free slot for a new episode.  Its instruction is
        uploaded now and encoded by the next tick (class docstring)."""
        with span("fleet.join"):
            for slot in range(self.k):
                if slot not in self._sessions:
                    sess = NavSession(self, slot, instr_encoding)
                    self._sessions[slot] = sess
                    return sess
        raise RuntimeError(f"all {self.k} fleet slots busy; release one")

    def release(self, slot: int):
        self._sessions.pop(slot, None)
        self._writable()
        self._clear(slot)
        # never into a re-claimed slot
        self._pending_rows.pop(slot, None)
        self._pending_instr.pop(slot, None)

    def restore_session(self, path: str) -> NavSession:
        """Resume a saved session (:meth:`NavSession.save`, of a fleet slot
        or a server's session: one blob format) in a free slot: host
        mirrors as saved, the feature rows and the episode lane into the
        fleet's buffers with ``state.scan`` pointed at the new slot."""
        with np.load(path, allow_pickle=False) as f:
            blob = {k: f[k] for k in f.files}
        want = (1, self.n, 36, self.d)
        if blob["features"].shape != want:
            raise ValueError(f"session blob features are "
                             f"{blob['features'].shape}, this server's {want}")
        sess = self.join(blob["instr"])
        slot = sess.slot
        sess._restore_host(blob)
        self._features[slot, :self.n] = torch.from_numpy(
            blob["features"][0]).to(self.device)
        fields = {k[len("state."):]: torch.from_numpy(v).to(self.device)
                  for k, v in blob.items() if k.startswith("state.")}
        sess._started = bool(fields)
        if fields:
            lane = EpisodeBatch(**fields)
            lane.scan = torch.full_like(lane.scan, slot)
            if self._state is None:
                self._state = self._empty_state()
            here = torch.arange(self.k, device=self.device) == slot
            self._state = select_lanes(here, lane, self._state)
        return sess

    def step(self, obs_by_slot: dict[int, Observation]) \
            -> dict[int, NavDecision]:
        """One control tick: check every submission, ingest them, encode
        the instructions joined since the last tick, advance every
        submission in one batched step, return their decisions.  A
        rejected submission raises before any session changes."""
        with span("fleet.step"):
            t0 = time.perf_counter()
            with span("fleet.ingest"):
                any_first, pre_lens = self._submissions(obs_by_slot)
            with span("fleet.upload"):
                buf = self._upload(self._staging)
            if self._pending_instr:
                with span("fleet.language"):
                    self._encode_pending()
            with span("fleet.decide"):
                if self._state is None:
                    self._state = self._empty_state()
                state, out = self._tick(buf, self._state, any_first)
            with span("fleet.fetch"):
                out = out.cpu().numpy()          # the one device-to-host copy
            self._state = state
            self._pending_rows.clear()
            latency = (time.perf_counter() - t0) * 1000.0
            decisions = {}
            with span("fleet.record"):
                for slot, obs in obs_by_slot.items():
                    sess = self._sessions[slot]
                    sess._started = True
                    decisions[slot] = sess._record(out[slot], obs,
                                                   pre_lens[slot], latency)
            return decisions

    def _submissions(self, obs_by_slot):
        """Check every submission, then fold them all into their sessions'
        mirrors and write the tick's control values and queued feature rows
        into the upload buffer: (whether a lane starts its episode, each
        submitting slot's trajectory length before the tick).  A rejected
        submission raises before any session changes."""
        for slot, obs in obs_by_slot.items():
            sess = self._sessions.get(slot)
            if sess is None:
                raise ValueError(f"slot {slot} holds no session; join() "
                                 f"first")
            if sess._ended:
                raise RuntimeError(
                    f"slot {slot}: episode already ended; call finish()")
            sess._check(obs)
        self._writable()
        nodes = self._fold(obs_by_slot)
        rows = self._rows
        rows[:, :len(CTL)] = 0
        rows[:, FEAT_V] = self.n
        any_first, pre_lens = False, {}
        for slot, obs in obs_by_slot.items():
            sess = self._sessions[slot]
            first = not sess._started
            any_first |= first
            rows[slot, :FEAT_V] = (1, first, sess._last_moved, nodes[slot],
                                   obs.heading if first else 0.0,
                                   sess.t_step)
            sess._put_feature_row(nodes[slot],
                                  np.asarray(obs.pano_feats, np.float32))
            pre_lens[slot] = max(len(sess._traj), 1)
        # a lane with no queued row writes zeros into its trash row, so
        # that its whole bank comes back bit for bit
        feats = len(CTL) + int(self._off[-1])
        for slot in self._fed - self._pending_rows.keys():
            rows[slot, feats:] = 0
        self._fed = set(self._pending_rows)
        for slot, (v, row) in self._pending_rows.items():
            rows[slot, FEAT_V] = v
            rows[slot, feats:] = row.ravel()
        return any_first, pre_lens

    def _fold(self, obs_by_slot) -> dict[int, int]:
        """Fold the checked observations into their sessions' mirrors in one
        pass over every candidate edge of the tick, with one geometry call
        for all of them; returns each slot's observed node.  The mirrors
        come out bit for bit as JAX's ``NavSession._ingest`` leaves them,
        one candidate at a time:

        - the observed node and each candidate take their positions (the
          last listing of a node wins), each edge its distance both ways
          (``relax_observed`` reads ``t.dist[scan, v, cand]``);
        - each candidate's row takes the reverse edge to the observed node
          in its first free slot, unless the row holds it already or is
          full (``_reverse_fill``: the observed-graph walk routes through
          frontier nodes by these edges; a full row's node was, or will
          be, observed itself); a node listed twice decides at its first
          listing;
        - then the observed node's candidate ids are reset and its row
          written in listing order.

        Heading, elevation and view come from the geometry where not given
        (a reverse edge's always), at the positions of that moment in the
        loop: a candidate that names the observed node moves it for the
        candidates after it."""
        m, n = self._m, self.n
        slot_o, node_o, pos_o, size_o, node_e, cands = [], [], [], [], [], []
        for slot, obs in obs_by_slot.items():
            sess = self._sessions[slot]
            slot_o.append(slot)
            node_o.append(sess._intern(obs.node))
            pos_o.append(obs.position)
            size_o.append(len(obs.candidates))
            node_e += [sess._intern(c.node) for c in obs.candidates]
            cands += obs.candidates
        if not slot_o:
            return {}
        edges = np.arange(len(cands))
        size_o = np.asarray(size_o)
        start_o = np.cumsum(size_o) - size_o
        o_e = np.repeat(np.arange(len(slot_o)), size_o)
        slot_o, node_o = np.asarray(slot_o), np.asarray(node_o)
        s_e, v_e, node_e = slot_o[o_e], node_o[o_e], np.asarray(node_e, int)
        col_e = edges - start_o[o_e]
        pos_o = np.asarray(pos_o, np.float32).reshape(-1, 3)
        pos_e = np.asarray([c.position for c in cands],
                           np.float32).reshape(-1, 3)
        dist = np.asarray([float(c.dist) for c in cands], np.float64)
        # where the observed node stands at each edge: at its latest
        # listing of itself in its observation, else where it reported
        self_at = np.maximum.accumulate(np.where(node_e == v_e, edges, -1))
        here = np.where((self_at >= start_o[o_e])[:, None],
                        pos_e[np.maximum(self_at, 0)], pos_o[o_e])

        keys = np.concatenate([slot_o * n + node_o, s_e * n + node_e])
        last = _last(keys)
        m["pos"][keys[last] // n, keys[last] % n] = \
            np.concatenate([pos_o, pos_e])[last]
        key_e = s_e * n + node_e
        last = _last(key_e)
        m["dist"][s_e[last], v_e[last], node_e[last]] = dist[last]
        m["dist"][s_e[last], node_e[last], v_e[last]] = dist[last]

        rev = _first(key_e)
        held = m["cand_ids"][s_e[rev], node_e[rev]]
        free = held < 0
        fill = free.any(1) & ~(held == v_e[rev, None]).any(1)
        rev, col_r = rev[fill], free[fill].argmax(1)
        given = np.asarray([c.heading is not None and c.elevation is not None
                            for c in cands], bool)
        heading = np.asarray([c.heading if g else 0.0
                              for c, g in zip(cands, given)], np.float64)
        elev = np.asarray([c.elevation if g else 0.0
                           for c, g in zip(cands, given)], np.float64)
        view = np.asarray([0 if c.view is None else c.view for c in cands],
                          np.int64)
        fwd = np.flatnonzero(~given)
        unseen = np.flatnonzero([c.view is None for c in cands])
        r = len(rev)
        if r or len(fwd) or len(unseen):
            with span("fleet.geometry"):
                h, e, _ = geo.rel_pos_features(
                    np.concatenate([pos_e[rev], here[fwd]]),
                    np.concatenate([here[rev], pos_e[fwd]]))
                heading[fwd], elev[fwd] = h[r:], e[r:]
                views = geo.nearest_view_index(
                    np.concatenate([h[:r], heading[unseen]]),
                    np.concatenate([e[:r], elev[unseen]]))
            view[unseen] = views[r:]
            at = (s_e[rev], node_e[rev], col_r)
            m["cand_ids"][at] = v_e[rev]
            m["cand_dist"][at] = dist[rev]
            m["cand_view"][at] = views[:r]
            m["cand_heading"][at] = h[:r]
            m["cand_elev"][at] = e[:r]

        m["cand_ids"][slot_o, node_o] = -1
        at = (s_e, v_e, col_e)
        m["cand_ids"][at] = node_e
        m["cand_dist"][at] = dist
        m["cand_view"][at] = view
        m["cand_heading"][at] = heading
        m["cand_elev"][at] = elev
        return dict(zip(slot_o.tolist(), node_o.tolist()))

    @torch.no_grad()
    def finish(self, slot: int) -> dict:
        """Backtrack slot ``slot``'s episode to its best stop-score node
        and return its final trajectory record."""
        with span("fleet.finish"):
            sess = self._sessions[slot]
            if not sess._started:
                raise RuntimeError("no steps taken")
            with span("fleet.walk"):
                r, state = self.rollout, self._lane_state(slot)
                at = len(CTL) + self._off
                r.t = self._unpack_tables(
                    self._upload(self._staging[slot:slot + 1, at[0]:at[-1]]),
                    self._features[slot:slot + 1])
                stop = r.final_stop_node(state)
                nodes, ln = r.record_backtrack(state, stop)
                out = torch.cat([stop[:, None], ln[:, None], nodes], dim=1)
            with span("fleet.fetch"):
                return sess._final(out[0].cpu().numpy())


def _first(keys: np.ndarray) -> np.ndarray:
    """The index of each distinct key's first occurrence."""
    return np.unique(keys, return_index=True)[1]


def _last(keys: np.ndarray) -> np.ndarray:
    """The index of each distinct key's last occurrence."""
    return len(keys) - 1 - _first(keys[::-1])
