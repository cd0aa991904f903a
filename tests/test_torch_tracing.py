"""The port's spans (``vln_magic_tpu_torch.utils.profiling.span``): off
records nothing; nesting, parents, roots and self time; recorded under
``torch.profiler`` with no event of their own, on the clock of the
profiler's records; written into ``trace()``'s Chrome trace; the spans of
a tiny ``Navigator.evaluate`` wave and ``NavFleet`` round; and decisions
and metrics equal with recording on and off.

Port only, on the CPU: no JAX program is compiled."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.serving import NavFleet, observation_from_world
from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig, ModelConfig,
                                        TrainConfig)
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
from vln_magic_tpu_torch.utils import profiling
from vln_magic_tpu_torch.utils.weights import export_flax_params

T = 4
ROLLOUT_STEP = {"rollout.observe", "rollout.panorama", "rollout.map",
                "rollout.navigation", "rollout.act"}


@pytest.fixture(autouse=True)
def fresh_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    world = make_synthetic_world(num_scans=2, nodes_per_scan=16, feat_dim=16,
                                 seed=3)
    cfg = MagicConfig(
        model=ModelConfig(vocab_size=100, hidden_size=32,
                          num_attention_heads=2, num_l_layers=1,
                          num_pano_layers=1, num_x_layers=1,
                          image_feat_size=16, max_position_embeddings=64),
        env=EnvConfig(max_action_len=T, max_gmap_len=24, max_instr_len=16),
        train=TrainConfig(batch_size=4))
    items = make_synthetic_instructions(world, 4, np.random.default_rng(3),
                                        vocab_size=100, max_len=16,
                                        min_path=3, max_path=5)
    return world, cfg, items


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def children(spans, parent):
    return sorted(s.name for s in spans if s.parent == parent.id)


def test_off_records_nothing():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        torch.ones(4).sum()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_nesting_parents_roots_and_self_time():
    with profiling.recording():
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("mid"):
                with profiling.span("inner"):
                    time.sleep(0.002)
                time.sleep(0.001)
            with profiling.span("mid2"):
                pass
        with profiling.span("next"):
            pass
    with profiling.span("after"):
        pass
    spans = profiling.recorded()
    assert [s.name for s in spans] == ["outer", "mid", "inner", "mid2",
                                       "next"]
    outer, mid, inner, mid2, nxt = spans
    assert outer.parent is None and outer.root == outer.id
    assert mid.parent == mid2.parent == outer.id and inner.parent == mid.id
    assert {mid.root, inner.root, mid2.root} == {outer.id}
    assert nxt.parent is None and nxt.root == nxt.id
    for s in spans:
        assert s.start_ns <= s.end_ns
    dur = lambda s: s.end_ns - s.start_ns
    assert outer.self_ns == dur(outer) - dur(mid) - dur(mid2)
    assert mid.self_ns == dur(mid) - dur(inner) >= 1_000_000
    assert inner.self_ns == dur(inner) >= 2_000_000
    profiling.reset()
    assert profiling.recorded() == []


def test_spans_past_the_bound_are_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for k in range(5):
            with profiling.span(f"s{k}"):
                pass
    assert [s.name for s in profiling.recorded()] == ["s0", "s1", "s2"]
    assert profiling.dropped() == 2


def test_profiler_turns_spans_on_and_sees_no_event_of_theirs():
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("vln.region"):
            x @ x
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::mm" in names
    assert not any("vln.region" in n for n in names)
    assert [s.name for s in profiling.recorded()] == ["vln.region"]


def test_a_span_contains_its_ops_on_the_profiler_clock():
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x @ x
        time.sleep(0.005)
        with profiling.span("vln.mm"):
            time.sleep(0.001)
            x @ x
            time.sleep(0.001)
        time.sleep(0.005)
        x @ x
    (s,) = profiling.recorded()
    mms = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(mms) == 3
    inside = [m for m in mms if s.start_ns <= m[0] and m[1] <= s.end_ns]
    assert inside == [mms[1]]


def test_trace_writes_the_spans_on_the_trace_base(tmp_path):
    x = torch.randn(256, 256)
    with profiling.trace(str(tmp_path)):
        with profiling.span("vln.outer"):
            with profiling.span("vln.mm"):
                x @ x
    data = json.loads((tmp_path / "trace.json").read_text())
    events = data["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert set(spans) == {"vln.outer", "vln.mm"}
    s, outer = spans["vln.mm"], spans["vln.outer"]
    assert s["args"]["parent"] == outer["args"]["id"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert s["tid"] == outer["tid"] != mm["tid"]
    assert s["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= s["ts"] + s["dur"]


def test_evaluate_records_one_wave_of_T_steps(tiny):
    world, cfg, items = tiny
    nav = Navigator(cfg, world, seed=5, device="cpu")
    (avg_off, per_off), preds_off = nav.evaluate(items)
    assert profiling.recorded() == []
    with profiling.recording():
        (avg_on, per_on), preds_on = nav.evaluate(items)
    assert avg_on == avg_off and per_on == per_off and preds_on == preds_off
    spans = profiling.recorded()
    (wave,) = by_name(spans, "eval.wave")
    (score,) = by_name(spans, "eval.score")
    assert wave.parent is None and score.parent is None
    assert children(spans, wave) == sorted(
        ["eval.prepare", "rollout.language", "eval.fetch",
         "eval.trajectories"] + ["rollout.step"] * T)
    steps = by_name(spans, "rollout.step")
    assert len(steps) == T
    for step in steps:
        assert set(children(spans, step)) == ROLLOUT_STEP
        assert step.root == wave.id
    assert all(s.root in (wave.id, score.id) for s in spans)


def test_fleet_round_records_its_spans(tiny):
    world, cfg, items = tiny
    params = export_flax_params(Navigator(cfg, world, seed=5,
                                          device="cpu").model)

    def serve():
        fleet = NavFleet(cfg, params, slots=2,
                         max_nodes=world.tables.max_nodes,
                         max_cands=world.tables.max_candidates, device="cpu")
        sessions = [fleet.join(it["instr_encoding"]) for it in items[:2]]
        obs = {s.slot: observation_from_world(
            world, it["scan_idx"], int(it["path_idx"][0]),
            float(it["heading"])) for s, it in zip(sessions, items)}
        decisions = fleet.step(obs)
        return ([(d.stop, d.target, d.path, d.action_index)
                 for d in decisions.values()], fleet.finish(0))

    off = serve()
    assert profiling.recorded() == []
    with profiling.recording():
        on = serve()
    assert on == off
    spans = profiling.recorded()
    joins = by_name(spans, "fleet.join")
    assert len(joins) == 2
    for join in joins:
        assert join.parent is None
        assert children(spans, join) == []
    # both joins' instructions encoded once, in the tick
    (tick,) = by_name(spans, "fleet.step")
    assert tick.parent is None
    assert children(spans, tick) == sorted(
        ["fleet.ingest", "fleet.upload", "fleet.language", "fleet.decide",
         "fleet.fetch", "fleet.record"])
    (decide,) = by_name(spans, "fleet.decide")
    (step,) = by_name(spans, "rollout.step")
    assert step.parent == decide.id and step.root == tick.id
    (finish,) = by_name(spans, "fleet.finish")
    assert finish.parent is None
    assert children(spans, finish) == ["fleet.fetch", "fleet.walk"]
