"""The port's CLIs on a mesh: ``main_nav --mode valid|train`` and
``train_pretrain`` under ``--dp``/``--mp``, each case two gloo processes on
the CPU started as torchrun starts them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), held against one
process of the same CLI at the same global batch; and a ``dp x mp`` that is
not the world size exiting before any group starts."""

import json
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from vln_magic_tpu_torch.cli import main_nav as cli
from vln_magic_tpu_torch.cli import train_pretrain as pcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_main_nav.py's tiny synthetic flags, at a per-device batch
MODEL = ["--student_hidden_size", "32", "--student_num_attention_heads", "2",
         "--teacher_hidden_size", "48", "--teacher_num_attention_heads", "2",
         "--num_l_layers", "1", "--num_pano_layers", "1", "--num_x_layers",
         "1", "--max_instr_len", "32"]
TINY = MODEL + ["--max_action_len", "4", "--max_gmap_len", "16",
                "--synthetic_scans", "1", "--synthetic_nodes", "12",
                "--synthetic_items", "8", "--synthetic_feat_dim", "16",
                "--device", "cpu"]
PRETRAIN = ["--synthetic_scans", "1", "--synthetic_nodes", "12",
            "--synthetic_items", "8", "--synthetic_feat_dim", "16",
            "--num_train_steps", "2", "--valid_steps", "2", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# tensorboard's import (TensorFlow's, some 14 s) is no part of what these
# tests hold: the metrics logger runs without it, as where it is missing
NO_TENSORBOARD = "import sys; sys.modules['torch.utils.tensorboard'] = None"


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(module: str, argv: list, world: int = 2) -> list[str]:
    """``python -m <module> <argv>`` as ``world`` ranks; their stdout."""
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
               "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", NO_TENSORBOARD + "; import runpy; "
             f"runpy.run_module({module!r}, run_name='__main__')", *argv],
            env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, outs
    return outs


def out_args(tmp_path, name):
    return ["--output_dir", str(tmp_path), "--name", name]


def records(tmp_path, name, file):
    """A run's log file (``--mode valid`` logs under ``test/``)."""
    mode = "test" if file == "valid.txt" else "navigator"
    return (tmp_path / mode / name / "logs" / file).read_text()


def split_metrics(text: str) -> dict:
    """``{split: metrics}`` of a valid.txt."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"(val_\w+): (\{.*\}) \(cost time", line)
        if m:
            assert m.group(1) not in out, f"{m.group(1)} written twice"
            out[m.group(1)] = json.loads(m.group(2))
    return out


def test_valid_dp2_matches_one_process(tmp_path):
    """``--mode valid --dp 2`` at 2 episodes a device equals one process
    at 4: the same metrics of every split, written once, by rank 0."""
    cli.main(TINY + ["--mode", "valid", "--batch_size", "4"]
             + out_args(tmp_path, "one"))
    outs = run_ranks("vln_magic_tpu_torch.cli.main_nav",
                     TINY + ["--mode", "valid", "--batch_size", "2", "--dp",
                             "2"] + out_args(tmp_path, "mesh"))
    one = split_metrics(records(tmp_path, "one", "valid.txt"))
    text = records(tmp_path, "mesh", "valid.txt")
    assert text.count("mesh: dp=2 x mp=1") == 1
    assert split_metrics(text) == one and one
    assert "mesh: dp=2 x mp=1 (global batch 4)" in outs[0]
    assert "mesh:" not in outs[1] and "val_" not in outs[1]


@pytest.mark.parametrize("axis", ["dp", "mp"])
def test_train_on_mesh(tmp_path, axis):
    """``--mode train`` for 2 iterations at ``--dp 2`` (2 episodes a
    device, global batch 4) and at ``--mp 2`` (4 on the one dp rank): the
    record line with the global batch, and the interval's loss equal to
    one process's at batch 4."""
    base = TINY + ["--mode", "train", "--iters", "2", "--log_every", "2",
                   "--train_alg", "imitation"]
    cli.main(base + ["--batch_size", "4"] + out_args(tmp_path, "one"))
    per_device = "2" if axis == "dp" else "4"
    run_ranks("vln_magic_tpu_torch.cli.main_nav",
              base + ["--batch_size", per_device, f"--{axis}", "2"]
              + out_args(tmp_path, axis))
    text = records(tmp_path, axis, "train.txt")
    dp, mp = (2, 1) if axis == "dp" else (1, 2)
    assert text.count(f"mesh: dp={dp} x mp={mp}, global batch 4") == 1
    loss = lambda t: re.findall(r"iter 2/2 loss=([-\d.]+)", t)
    assert loss(text) == loss(records(tmp_path, "one", "train.txt"))
    assert len(loss(text)) == 1
    ckpts = tmp_path / "navigator" / axis / "ckpts"
    assert (ckpts / "latest_dict.pt").exists()


def test_pretrain_dp2_matches_one_process(tmp_path):
    """``train_pretrain --dp 2`` at 2 a device: the mesh line, the same
    logged loss and validation as one process at 4, the checkpoints."""
    mc = tmp_path / "model_config.json"
    mc.write_text(json.dumps({
        "student_hidden_size": 32, "student_num_attention_heads": 2,
        "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1}))
    argv = PRETRAIN + ["--model_config", str(mc)]
    pcli.main(argv + ["--train_batch_size", "4", "--output_dir",
                      str(tmp_path / "one")])
    outs = run_ranks("vln_magic_tpu_torch.cli.train_pretrain",
                     argv + ["--train_batch_size", "2", "--dp", "2",
                             "--output_dir", str(tmp_path / "mesh")])
    assert "mesh: dp=2 x mp=1 (global batch 4)" in outs[0]
    line = lambda d: (tmp_path / d / "pretrain.txt").read_text()
    assert line("mesh") == line("one")
    assert (tmp_path / "mesh" / "ckpts" / "model_step_2.pt").exists()


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--mp", "2"],
                                   ["--world_size", "4"]])
def test_mesh_wider_than_world_exits(tmp_path, flags):
    """One process (no ``WORLD_SIZE``): a mesh of more devices exits with
    JAX's "needs N devices" before any process group starts."""
    with pytest.raises(SystemExit, match="needs"):
        cli.main(TINY + ["--mode", "valid", "--batch_size", "4"] + flags
                 + out_args(tmp_path, "x"))
    if flags[0] != "--world_size":      # main_nav's flag only, as JAX's
        with pytest.raises(SystemExit, match="needs"):
            pcli.main(PRETRAIN + ["--output_dir", str(tmp_path / "p")]
                      + flags)
    assert not torch.distributed.is_initialized()
