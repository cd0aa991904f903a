"""What the benchmark may load: nothing whose top-level module name is
``jax``, ``jaxlib``, ``flax``, ``optax`` or ``vln_magic_tpu`` (compared
whole: the port's name begins with the JAX package's), and a reference
that loads nothing of the port."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench_testkit import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vln_magic_tpu"}


def _loaded_after(code: str, tmp_path) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter with the benchmark's directory on the path."""
    script = (f"import sys, json; sys.path[:0] = [{BENCH_DIR!r}, "
              f"{os.path.join(BENCH_DIR, 'tests')!r}, {ROOT!r}]\n{code}\n"
              "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = ("import torch; torch.set_num_threads(1)\n"
            "from portbench_testkit import tiny_benchmark, run_tiny\n"
            "import pathlib\n"
            f"p = tiny_benchmark(pathlib.Path({str(tmp_path)!r}))\n"
            "assert run_tiny(p, 'tiny.eval', trace=True)['correct']\n"
            "assert run_tiny(p, 'tiny.serve')['correct']")
    loaded = _loaded_after(code, tmp_path)
    assert "vln_magic_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    """Every reference module, and the tests' module of a configuration
    with a head of its own (loaded as the harness loads one, under
    ``reference.``)."""
    ref_dir = os.path.join(BENCH_DIR, "reference")
    files = {f[:-3]: os.path.join(ref_dir, f) for f in os.listdir(ref_dir)
             if f.endswith(".py") and f != "__init__.py"}
    files["front_his"] = os.path.join(BENCH_DIR, "tests",
                                      "front_his_reference.py")
    loaded = _loaded_after(
        "import importlib.util\n" + "".join(
            f"s = importlib.util.spec_from_file_location('reference.{m}', "
            f"{path!r})\ns.loader.exec_module("
            "importlib.util.module_from_spec(s))\n"
            for m, path in sorted(files.items())), tmp_path)
    assert not loaded & (FORBIDDEN | {"vln_magic_tpu_torch", "portbench"})
    for m, path in files.items():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] in {"__future__", "math", "heapq",
                                              "numpy", "torch"}, (m, name)


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, BENCH_DIR)
    import run

    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vln_magic_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vln_magic_tpu.agent", sys)
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert run.forbidden_modules() == ["flax", "vln_magic_tpu"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "magic-s128.eval", "--seed", str(2 ** 31 + 11), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
