"""The benchmark is driven by data: every cell of ``BENCHMARK.json`` loads
from its files alone, and a new configuration (with a reference module of
its own), traffic mix, cell and per-layer metric are new files and new
entries, with no file edited.  The configurations that name no module
keep the base navigator's weights and FLOP counts."""

from __future__ import annotations

import json
import os

import pytest
import torch
from portbench_testkit import BENCH_DIR, ROOT, add_front_his, real_spec, \
    run_tiny, tiny_benchmark

from portbench.harness import Spec

SPEC = real_spec()


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_cell_loads_from_data_alone(workload):
    spec = Spec()
    w = spec.workload(workload)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert cfg["compute_dtype"] in ("bfloat16", "float32")
    ref = spec.reference(w["config"])
    assert callable(ref.param_shapes) and callable(ref.Navigator)
    assert mix["kind"] in ("eval", "serve")
    limits = spec.limits(workload)
    assert limits and all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in spec.end_to_end(workload)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(workload)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("config",
                         [c["name"] for c in SPEC["configs"]] + ["tiny-front"])
def test_the_reference_weights_are_the_programs(config, tmp_path):
    """The weight names and shapes (flax layout) of the configuration's
    reference module are exactly what the program's loader takes, checked
    on the configuration's structure at a small width; ``tiny-front``: a
    configuration with an intervention head and a module of its own."""
    from vln_magic_tpu_torch.config import ModelConfig
    from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
    from vln_magic_tpu_torch.utils.weights import _flax_names

    if config == "tiny-front":
        path = tiny_benchmark(tmp_path)
        add_front_his(path)
        spec = Spec(path, os.path.join(str(tmp_path), "benchmark"))
    else:
        spec = Spec()
    m = dict(spec.config(config)["model"], hidden_size=64,
             num_attention_heads=2, vocab_size=100, image_feat_size=16,
             kd_target_size=32)
    model = DualScaleVLNBert(ModelConfig(**m), device="cpu")
    theirs = {n: tuple(p.shape[::-1] if t else p.shape)
              for n, (p, t) in _flax_names(model).items()}
    assert spec.reference(config).param_shapes(m) == theirs


# the parent's ``portbench.flops`` at each cell's traffic: an instruction,
# a step, and (eval) a wave of ``batch`` episodes of ``max_action_len``
# steps
PARENT_FLOPS = {
    "magic-s128.eval": (620953600, 619488256, 2537799024640),
    "magic-t768.eval": (18667929600, 17648572416, 72549508055040),
    "magic-s128.serve64": (620953600, 619488256, None),
}


@pytest.mark.parametrize("workload", sorted(PARENT_FLOPS))
def test_the_configurations_without_a_module_keep_the_base(workload):
    """A configuration that names no module draws the base navigator's
    weights, and its windows count the FLOPs ``portbench.flops`` counted
    before configurations could bring their own."""
    from portbench import flops
    from reference import model

    spec = Spec()
    w = spec.workload(workload)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert "reference" not in cfg
    ref = spec.reference(w["config"])
    assert os.path.samefile(ref.__file__, model.__file__)
    shapes = ref.param_shapes(cfg["model"])
    assert sorted(shapes.items()) == sorted(
        model.param_shapes(cfg["model"]).items())
    instruction, step = flops.counts(ref)
    assert (instruction, step) == (flops.instruction, flops.step)
    lang = mix["instr_len"]
    one = (instruction(cfg["model"], lang),
           step(cfg["model"], lang, mix["max_gmap_len"],
                mix["max_candidates"] + 36))
    wave = (mix["batch"] * (one[0] + mix["max_action_len"] * one[1])
            if mix["kind"] == "eval" else None)
    assert one + (wave,) == PARENT_FLOPS[workload]


def test_new_config_mix_cell_and_metric_by_adding_files(tmp_path):
    torch.set_num_threads(1)
    path = tiny_benchmark(tmp_path)
    bench = os.path.join(os.path.dirname(path), "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["model"]["hidden_size"] = 64
    with open(os.path.join(bench, "configs", "tiny64.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "eval.json")) as f:
        mix = dict(json.load(f), batch=4, nodes_per_scan=24)
    with open(os.path.join(bench, "traffic", "eval4.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "limits", "tiny64.eval4.json"), "w") as f:
        json.dump({"logit_gap": 1.0, "bad_trajectories": 0,
                   "metric_mismatches": 0}, f)
    with open(os.path.join(bench, "metrics", "eval.waves.py"), "w") as f:
        f.write('"""Waves in the window."""\n\n\ndef read(run):\n'
                '    return run.window["units"]\n')
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny64", "source": "tiny",
                            "file": "benchmark/configs/tiny64.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny64.eval4", "config": "tiny64",
                              "traffic": "eval4", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("tiny64.eval4")
    spec["per_layer"].append({"name": "eval.waves", "unit": "waves",
                              "better": "higher", "source": "host_clock",
                              "layer": "a test", "moves": "eval_steps_per_s",
                              "workloads": ["tiny64.eval4"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    out = run_tiny(path, "tiny64.eval4", trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["eval.waves"]["value"] >= 1
    out = run_tiny(path, "tiny64.eval4")
    assert set(out["metrics"]) == {"eval_steps_per_s", "setup_s"}


def test_every_file_under_the_benchmark_is_named_from_a_name():
    allowed = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                  "0123456789_.-/")
    for top, dirs, files in os.walk(BENCH_DIR):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(top, f), ROOT)
            assert set(rel) <= allowed, rel
