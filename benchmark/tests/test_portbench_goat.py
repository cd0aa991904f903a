"""GOAT (``goat-t768``: the teacher with its five causal-intervention heads,
``reference/goat.py``) in the benchmark, on the CPU: a tiny copy runs
``correct`` on both kinds of cell with seeded random weights, its fp8
control reads above the program, and an eval cell whose program is handed
its dictionaries with the image backdoor's or the viewpoint frontdoor's
withheld is not ``correct`` (the others at ``goat-t768``'s widths on the
card, since the tiny model's decisions hardly see them); the module's weight names are the
program's, at the tiny size and at ``goat-t768``'s own widths; its FLOP
counts restate ``portbench.flops`` with the heads off and count the heads
on top."""

from __future__ import annotations

import os

import pytest
import torch
from goat_testkit import SEEN_WITHHELD, add_goat, withheld
from portbench_testkit import run_tiny, tiny_benchmark

from portbench.harness import Spec

KINDS = ("eval", "serve")
SEEDS = (11, 12, 13)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def goat(tmp_path):
    path = tiny_benchmark(tmp_path)
    add_goat(path)
    return path


@pytest.mark.parametrize("kind", KINDS)
def test_goat_runs_correct(goat, kind):
    out = run_tiny(goat, f"tiny-goat.{kind}", trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    metric = {"eval": "eval.launches_per_step",
              "serve": "serve.launches_per_round"}[kind]
    assert metric in out["metrics"]


@pytest.mark.parametrize("kind", KINDS)
def test_goat_control_reads_above_the_program(goat, kind):
    """Over three seeds the program is ``correct`` and the fp8 control not,
    and the control's smallest mean gap lies above the bf16 program's
    largest.  The serve windows are longer, so that each leaves the
    control free decisions."""
    seconds = {"eval": 0.5, "serve": 2.0}[kind]
    runs = [run_tiny(goat, f"tiny-goat.{kind}", seed=seed, seconds=seconds,
                     control=True) for seed in SEEDS]
    assert all(r["correct"] and not r["control"]["correct"] for r in runs)
    k = "mean_logit_gap"
    assert min(r["control"]["checks"][k]["value"] for r in runs) > max(
        r["checks"][k]["value"] for r in runs)


@pytest.mark.parametrize("which", SEEN_WITHHELD)
def test_a_withheld_dictionary_is_not_correct(goat, monkeypatch, which):
    from vln_magic_tpu_torch.agent.navigator import Navigator

    real = Navigator.evaluate

    def without(self, *a, **kw):
        kw["zdicts"] = withheld(kw["zdicts"], which)
        return real(self, *a, **kw)

    monkeypatch.setattr(Navigator, "evaluate", without)
    out = run_tiny(goat, "tiny-goat.eval")
    assert not out["correct"], out["checks"]


def _program_names(m: dict) -> dict:
    """The program's flax names and shapes at the model ``m``, built on the
    meta device, so no weight is allocated."""
    from vln_magic_tpu_torch.config import ModelConfig
    from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
    from vln_magic_tpu_torch.utils.weights import _flax_names

    real_to = torch.nn.Module.to
    torch.nn.Module.to = lambda self, *a, **k: self
    try:
        with torch.device("meta"):
            model = DualScaleVLNBert(ModelConfig(**m), device="cpu")
    finally:
        torch.nn.Module.to = real_to
    return {n: tuple(p.shape[::-1] if t else p.shape)
            for n, (p, t) in _flax_names(model).items()}


@pytest.mark.parametrize("size", ("tiny", "goat-t768"))
def test_the_goat_weight_names_are_the_programs(goat, size):
    if size == "tiny":
        spec = Spec(goat, os.path.join(os.path.dirname(goat), "benchmark"))
        cfg = spec.config("tiny-goat")
        ref = spec.reference("tiny-goat")
    else:
        spec = Spec()
        cfg = spec.config(size)
        ref = spec.reference(size)
    assert ref.__name__ == "reference.goat"
    shapes = ref.param_shapes(cfg["model"])
    assert shapes == _program_names(cfg["model"])
    assert {n.rsplit(".", 2)[0] for n in shapes
            if ".norm." in n and "_sap_head" not in n
            and "sap_fuse" not in n} == {
        f"params.{h}" for h in (
            "txt_backdoor_direction", "txt_backdoor_landmark",
            "txt_frontdoor", "vp_frontdoor", "gmap_frontdoor",
            "pano_encoder.img_backdoor")}


@pytest.mark.parametrize("config", ("magic-s128", "magic-t768"))
@pytest.mark.parametrize("traffic", ("eval", "serve64"))
def test_the_goat_counts_restate_the_base(config, traffic):
    """With its heads off, the module counts what ``portbench.flops``
    counts, at both traffics' shapes."""
    from portbench import flops

    spec = Spec()
    goat = spec.reference("goat-t768")
    m, mix = spec.config(config)["model"], spec.traffic(traffic)
    assert not any(k.startswith("do_") and v for k, v in m.items())
    lang, pano = mix["instr_len"], mix["max_candidates"] + 36
    assert goat.instruction_flops(m, lang) == flops.instruction(m, lang)
    assert goat.step_flops(m, lang, mix["max_gmap_len"], pano) == \
        flops.step(m, lang, mix["max_gmap_len"], pano)


def test_a_goat_wave_counts_the_heads():
    """A wave of the ``eval`` traffic on ``goat-t768``: 256 episodes, each
    an instruction and 15 steps, the heads 7.35 % on top of the base's
    72,549,508,055,040."""
    spec = Spec()
    ref = spec.reference("goat-t768")
    m, mix = spec.config("goat-t768")["model"], spec.traffic("eval")
    lang, pano = mix["instr_len"], mix["max_candidates"] + 36
    wave = mix["batch"] * (ref.instruction_flops(m, lang)
                           + mix["max_action_len"] * ref.step_flops(
                               m, lang, mix["max_gmap_len"], pano))
    assert wave == 77_882_970_341_376
