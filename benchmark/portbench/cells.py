"""The two drivers that traffic files name by ``kind``: ``eval`` (back-to-back
waves of ``Navigator.evaluate``) and ``serve`` (a closed loop of robots on
a ``NavFleet``).  Each builds the program from the configuration and the
traffic, warms up the shapes its traffic uses, runs a measured window,
optionally a profiled stretch, and hands what the program returned to the
correctness check.  Only the public API of ``vln_magic_tpu_torch`` is used.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import flops
from .check import EvalRecord, ServeRecord
from .trace import Profiled, packed_shapes, span
from .traffic import Traffic
from .weights import draw, to_host


def magic_config(cfg: dict, mix: dict, batch: int):
    from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig,
                                            ModelConfig, TrainConfig)

    return MagicConfig(
        model=ModelConfig(**cfg["model"]),
        env=EnvConfig(max_action_len=mix["max_action_len"],
                      max_gmap_len=mix["max_gmap_len"],
                      max_instr_len=mix["instr_len"]),
        train=TrainConfig(batch_size=batch,
                          compute_dtype=cfg["compute_dtype"]))


class Cell:
    """What both drivers share: the traffic (from the run's seed), the
    weights (the names and shapes of the configuration's reference module
    ``ref``, drawn from the configuration's ``weights_seed`` on the device,
    then kept on the host for the reference), the module's fixed
    ``inputs`` (keyword arguments of the program's API, handed to the
    reference too), the FLOP counts and the run's counters."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, ref):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.traffic = Traffic(mix, seed)
        weights = draw(ref.param_shapes(cfg["model"]), cfg["compute_dtype"],
                       cfg["weights_seed"], self.device)
        self.host_weights = to_host(weights)
        del weights
        self.inputs = ref.inputs(cfg) if hasattr(ref, "inputs") else {}
        self.instruction_flops, self.step_flops = flops.counts(ref)
        self.packed_calls: list = []

    def free(self):
        """Drop the program and its device memory before the reference
        runs."""
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()


class EvalCell(Cell):
    """``Navigator.evaluate`` over waves of ``batch`` fresh episodes; the
    measure is live episode-steps decoded per second."""

    def __init__(self, cfg, mix, seed, device, ref):
        super().__init__(cfg, mix, seed, device, ref)
        from vln_magic_tpu_torch.agent.navigator import Navigator
        from vln_magic_tpu_torch.env import NavGraph, World

        tr = self.traffic
        graphs = []
        for s, (pos, adj) in enumerate(zip(tr.positions, tr.adjacency)):
            diff = pos[:, None] - pos[None, :]
            euclid = np.sqrt((diff ** 2).sum(-1)).astype(np.float32)
            graphs.append(NavGraph(
                f"scan{s:04d}", [tr.node_id(s, v) for v in range(len(pos))],
                pos, adj, np.where(adj, euclid, np.float32(1e9))))
        feats = {f"scan{s:04d}": f for s, f in enumerate(tr.features)}
        world = World(graphs, lambda scan, ids: feats[scan], mix["feat_dim"],
                      max_candidates=mix["max_candidates"])
        self.batch = mix["batch"]
        self.program = Navigator(magic_config(cfg, mix, self.batch), world,
                                 params=self.host_weights,
                                 device=self.device)
        self.record = None
        m, lang = cfg["model"], mix["instr_len"]
        self.wave_flops = self.batch * (
            self.instruction_flops(m, lang)
            + mix["max_action_len"] * self.step_flops(
                m, lang, mix["max_gmap_len"],
                world.tables.max_candidates + 36))

    def wave(self, stream: int):
        items = self.traffic.episodes(stream, self.batch)
        (avg, per_item), preds = self.program.evaluate(
            items, batch_size=self.batch, **self.inputs)
        return items, avg, per_item, preds

    def warmup(self):
        for k in range(self.mix["warmup_waves"]):
            self.wave(2 * 10 ** 6 + k)
        self.sync()

    def window(self, seconds: float) -> dict:
        self.record = EvalRecord(self.traffic, self.mix)
        waves = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            items, avg, per_item, preds = self.wave(len(waves))
            self.record.add(items, avg, per_item, preds)
            waves.append(time.perf_counter())
        window_s = waves[-1] - t0
        self.record.finalize()
        steps = self.record.live_steps()
        return {"window_s": window_s, "units": len(waves),
                "unit_wall_s": window_s / len(waves),
                "eval_steps_per_s": steps / window_s,
                "flops": self.wave_flops * len(waves),
                "steps": steps}

    def profile(self) -> dict:
        """A few whole waves under the profiler, after the window."""
        n = self.mix["profile_waves"]
        with packed_shapes(self.packed_calls), Profiled(self.device) as prof:
            for k in range(n):
                with span("eval.wave"):
                    self.wave(10 ** 6 + k)
        out = prof.read()
        out["units"] = n
        return out


class ServeCell(Cell):
    """A ``NavFleet`` of ``slots`` robots in a closed loop: each robot hands
    in its next observation when it gets its decision; an episode that ends
    is finished and its slot joined by a new one before the next tick.  A
    decision lasts from its robot's observation being ready to the
    decision back: the whole round, restarts and tick."""

    def __init__(self, cfg, mix, seed, device, ref):
        super().__init__(cfg, mix, seed, device, ref)
        from vln_magic_tpu_torch.agent.serving import (Candidate, NavFleet,
                                                       Observation)

        tr = self.traffic
        self.slots = mix["slots"]
        self.program = NavFleet(
            magic_config(cfg, mix, self.slots), self.host_weights,
            slots=self.slots, max_cands=mix["max_candidates"],
            device=self.device, **self.inputs)
        # what a robot standing at each node reports, built once
        self.obs = {}
        for s, scan in enumerate(tr.scans):
            for v in range(scan.n):
                cands = [Candidate(node=tr.node_id(s, c),
                                   position=tuple(float(x)
                                                  for x in scan.pos[c]),
                                   dist=d, heading=h, elevation=e, view=vw)
                         for c, d, h, e, vw in scan.cands[v]]
                self.obs[s, v] = (tr.node_id(s, v),
                                  tuple(float(x) for x in scan.pos[v]),
                                  tr.features[s][v], cands)
        self._observation = Observation
        self.record = None          # the window's sessions, once it opens
        self.robots: dict[int, dict] = {}
        self.stream = 0
        self.joins = 0
        self.latency_ms: list[float] = []

    def _start(self, slot):
        item = self.traffic.episodes(self.stream, 1)[0]
        self.stream += 1
        sess = self.program.join(item["instr_encoding"])
        if sess.slot != slot:
            raise RuntimeError(f"joined slot {sess.slot}, wanted {slot}")
        self.joins += 1
        self.robots[slot] = {"item": item, "cur": int(item["path_idx"][0]),
                             "decisions": [], "ended": False}

    def tick(self):
        """One round: finish and replace the robots whose episode ended,
        then one fleet tick for every robot.  Returns the clock when the
        decisions came back (``NavFleet.step`` synchronises: it copies them
        to the host)."""
        t0 = time.perf_counter()
        with span("serve.restart"):
            for slot in range(self.slots):
                r = self.robots.get(slot)
                if r is None or r["ended"]:
                    if r is not None:
                        r["final"] = self.program.finish(slot)
                        self.program.release(slot)
                        if self.record is not None:
                            self.record.add(r)
                    self._start(slot)
        sub = {}
        for slot, r in self.robots.items():
            name, pos, feats, cands = self.obs[r["item"]["scan_idx"],
                                               r["cur"]]
            sub[slot] = self._observation(
                node=name, position=pos, heading=r["item"]["heading"],
                pano_feats=feats, candidates=cands)
        with span("serve.tick"):
            out = self.program.step(sub)
        back = time.perf_counter()
        for slot, dec in out.items():
            r = self.robots[slot]
            # the program's own timing of the tick lies within the round's
            r["decisions"].append((dec.stop, dec.target, list(dec.path),
                                   dec.latency_ms <= (back - t0) * 1e3))
            if dec.stop:
                r["ended"] = True
            else:
                r["cur"] = int(dec.target.split("_")[1])
        return back

    def warmup(self):
        for _ in range(self.mix["warmup_ticks"]):
            self.tick()
        self.sync()

    def window(self, seconds: float) -> dict:
        self.record = ServeRecord(self.traffic, self.mix)
        self.latency_ms = []
        joins0 = self.joins
        ticks, t0 = 0, time.perf_counter()
        # a robot's observation is ready when its last decision came back
        # (a robot whose episode ended starts its next one then); the fleet
        # serves every robot's restart before the tick, so each decision
        # waits the whole round
        ready = end = t0
        while end - t0 < seconds:
            back = self.tick()
            self.latency_ms.extend([(back - ready) * 1e3] * self.slots)
            ready = back
            ticks += 1
            end = time.perf_counter()
        window_s = end - t0
        m, lang = self.cfg["model"], self.mix["instr_len"]
        work = (ticks * self.slots * self.step_flops(
            m, lang, self.mix["max_gmap_len"],
            self.mix["max_candidates"] + 36)
            + (self.joins - joins0) * self.instruction_flops(m, lang))
        return {"window_s": window_s, "units": ticks,
                "unit_wall_s": window_s / ticks,
                "decision_ms_p95": float(np.percentile(self.latency_ms, 95)),
                "decisions": len(self.latency_ms), "flops": work}

    def profile(self) -> dict:
        n = self.mix["profile_ticks"]
        with packed_shapes(self.packed_calls), Profiled(self.device) as prof:
            for _ in range(n):
                self.tick()
        out = prof.read()
        out["units"] = n
        return out

    def close(self):
        """Finish the robots whose episode ended in the last round, so their
        sessions reach the check."""
        for slot, r in self.robots.items():
            if r["ended"]:
                r["final"] = self.program.finish(slot)
                self.record.add(r)
        self.record.finalize()


DRIVERS = {"eval": EvalCell, "serve": ServeCell}
