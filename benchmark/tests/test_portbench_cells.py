"""Each traffic mix dry-run on the CPU at a tiny size, through the whole
run (set-up, warm-up, window, profiled stretch, check), and the check
seeing ``correct`` come out false when the timed path is broken
underneath: a decision altered where it is made, a step whose map state is
left unchanged, half of a wave's episodes left out.  A configuration that
brings its own reference module and inputs as new files (``tiny-front``,
GOAT's map frontdoor) runs the head on both kinds and is held to it."""

from __future__ import annotations

import pytest
import torch
from portbench_testkit import add_front_his, run_tiny, tiny_benchmark

KINDS = ("eval", "serve")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def bench(tmp_path):
    return tiny_benchmark(tmp_path)


@pytest.fixture
def front(tmp_path):
    path = tiny_benchmark(tmp_path)
    add_front_his(path)
    return path


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("trace", (False, True))
def test_tiny_run_is_correct(bench, kind, trace):
    out = run_tiny(bench, f"tiny.{kind}", trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    names = set(out["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert len(out["breakdown"]["device_ops"]) <= 10
        assert len(out["breakdown"]["idle_gaps"]) <= 10
        want = {"eval": {"eval.launches_per_step", "mfu.eval",
                         "device.idle.eval"},
                "serve": {"serve.launches_per_round", "mfu.serve",
                          "device.idle.serve"}}[kind]
        assert want <= names
    else:
        e2e = {"eval": "eval_steps_per_s", "serve": "decision_ms_p95"}[kind]
        assert names == {e2e, "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())


def _worst_action(monkeypatch):
    """Every decision takes the worst action on offer instead of the best:
    a token altered where it is produced."""
    from vln_magic_tpu_torch.agent import rollout

    real = rollout.Rollout.select_action

    def worst(self, logits, feedback, *args, **kwargs):
        if feedback != "argmax":
            return real(self, logits, feedback, *args, **kwargs)
        valid = logits > rollout.NEG_INF / 2
        return torch.where(valid, -logits, torch.full_like(
            logits, float("-inf"))).argmax(dim=-1)

    monkeypatch.setattr(rollout.Rollout, "select_action", worst)


def _frozen_map(monkeypatch):
    """The map's node embeddings are never updated: a step that leaves
    that part of its state unchanged."""
    from vln_magic_tpu_torch.agent import rollout

    monkeypatch.setattr(rollout.Rollout, "update_node_embeds",
                        lambda self, *a, **k: None)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", (_worst_action, _frozen_map))
def test_broken_path_is_not_correct(bench, monkeypatch, kind, fault):
    fault(monkeypatch)
    out = run_tiny(bench, f"tiny.{kind}")
    assert not out["correct"], out["checks"]


def test_half_a_wave_left_out_is_not_correct(bench, monkeypatch):
    from vln_magic_tpu_torch.agent.navigator import Navigator

    real = Navigator.evaluate

    def half(self, items, **kw):
        (avg, per), preds = real(self, items[: len(items) // 2], **kw)
        return (avg, per), preds

    monkeypatch.setattr(Navigator, "evaluate", half)
    out = run_tiny(bench, "tiny.eval")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", KINDS)
def test_control_reads_above_the_program(bench, kind):
    """The control (the reference in fp8 put in the program's place) reads
    wider gaps than the bf16 program on the same episodes, and goes through
    the run's own check: with limits set between the two readings (as the
    card's readings at the cell's own size set the real ones,
    ``benchmark/readings.py``) the program comes out correct and the
    control not, at a size a test run holds."""
    _control_above(bench, f"tiny.{kind}")


@pytest.mark.parametrize("kind", KINDS)
def test_a_head_the_base_lacks_runs_correct_from_new_files(front, kind):
    out = run_tiny(front, f"tiny-front.{kind}")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_inputs_withheld_from_the_program_are_not_correct(front, monkeypatch,
                                                          kind):
    """The program handed no dictionary skips the frontdoor; the reference
    applies it, and the check sees the difference."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.agent.serving import NavFleet

    for cls, name in ((Navigator, "evaluate"), (NavFleet, "__init__")):
        real = getattr(cls, name)

        def without(self, *a, _real=real, **kw):
            kw.pop("zdicts", None)
            return _real(self, *a, **kw)

        monkeypatch.setattr(cls, name, without)
    out = run_tiny(front, f"tiny-front.{kind}")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", KINDS)
def test_front_door_control_reads_above_the_program(front, kind):
    _control_above(front, f"tiny-front.{kind}")


def _control_above(bench, workload):
    import json
    import os

    gaps = ("logit_gap", "mean_logit_gap")
    runs = [run_tiny(bench, workload, seed=seed, seconds=0.3,
                     control=True) for seed in (11, 12, 13)]
    lower = {k: max(r["checks"][k]["value"] for r in runs) for k in gaps}
    upper = {k: min(r["control"]["checks"][k]["value"] for r in runs)
             for k in gaps}
    assert all(upper[k] > lower[k] for k in gaps), (lower, upper)
    path = os.path.join(os.path.dirname(bench), "benchmark", "limits",
                        f"{workload}.json")
    with open(path) as f:
        limits = json.load(f)
    limits.update({k: (lower[k] * upper[k]) ** 0.5 for k in gaps})
    with open(path, "w") as f:
        json.dump(limits, f)
    out = run_tiny(bench, workload, seed=12, seconds=0.3, control=True)
    assert out["correct"], out["checks"]
    ctrl = out["control"]
    assert not ctrl["correct"], ctrl
    assert set(ctrl["checks"]) == set(out["checks"])
