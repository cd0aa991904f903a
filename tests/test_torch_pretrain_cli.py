"""The port's pretraining CLI (vln_magic_tpu_torch.cli.train_pretrain):
``parse_args`` and ``reference_pretrain_flags`` equal to JAX's on the same
argv and JSON blobs; a tiny run of two intervals writing ``latest``,
``model_step_N``, the reference ``model_step_N.pt`` (which JAX reads) and
``metrics.jsonl``; ``--checkpoint`` starting from ``latest``; the mesh
flags and the default device refusing.
"""

import json
import os

import numpy as np
import pytest
import torch

from vln_magic_tpu.cli import train_pretrain as jax_cli
from vln_magic_tpu.utils.checkpoint import (flatten_params,
                                            load_torch_checkpoint)
from vln_magic_tpu_torch.cli import train_pretrain as cli
from vln_magic_tpu_torch.utils.checkpoint import CheckpointManager
from vln_magic_tpu_torch.utils.weights import export_flax_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BLOBS = {
    "empty": {},
    "reference": {
        "learning_rate": 5e-5, "grad_norm": 5.0, "max_txt_len": 100,
        "num_train_steps": 300, "warmup_steps": 30, "train_batch_size": 16,
        "kdl": {"knowledge_distillation": True, "kd_alpha": 0.3,
                "kd_temperature": 2.0, "kd_loss": "mse",
                "kdl_logits_loss": "kd", "train_teacher": False},
        "train_datasets": {"R2R": {"tasks": ["mlm", "sap", "cfp"],
                                   "mix_ratio": [2, 1, 1]}}},
    "tasks_only": {"train_datasets": {"R2R": {"tasks": ["mlm", "mrc"]}}},
}


@pytest.mark.parametrize("name", sorted(BLOBS))
def test_reference_pretrain_flags_match_jax(name):
    assert cli.reference_pretrain_flags(BLOBS[name]) == \
        jax_cli.reference_pretrain_flags(BLOBS[name])


ARGVS = {
    "defaults": [],
    "flags": ["--num_train_steps", "7", "--learning_rate=1e-4",
              "--train_kdl", "--dp", "1", "--seed", "3"],
    "config": ["--config", "{config}", "--valid_steps", "9"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_args_matches_jax(name, tmp_path):
    """Every JAX flag parses to JAX's value, the JSON config merging
    under the command line's; the port adds ``--device`` (default
    ``cuda``)."""
    config = tmp_path / "pretrain.json"
    config.write_text(json.dumps(dict(BLOBS["reference"], valid_steps=3,
                                      seed=5)))
    argv = [a.format(config=config) for a in ARGVS[name]]
    got, want = vars(cli.parse_args(argv)), vars(jax_cli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


def _run(tmp_path, *extra):
    mc = tmp_path / "model_config.json"
    mc.write_text(json.dumps({
        "student_hidden_size": 32, "student_num_attention_heads": 2,
        "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1}))
    return cli.main([
        "--output_dir", str(tmp_path / "pt"), "--model_config", str(mc),
        "--num_train_steps", "2", "--valid_steps", "1",
        "--train_batch_size", "2", "--synthetic_scans", "1",
        "--synthetic_nodes", "12", "--synthetic_items", "16",
        "--synthetic_feat_dim", "16", "--device", "cpu", *extra])


def test_two_intervals_write_checkpoints_and_resume(tmp_path):
    tr = _run(tmp_path)
    out = tmp_path / "pt"
    ckpts = out / "ckpts"
    assert {"latest", "model_step_1", "model_step_2", "model_step_1.pt",
            "model_step_2.pt"} <= set(os.listdir(ckpts))
    records = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 1, 2, 2]
    assert "pretrain/loss" in records[0] and "val/mlm_acc" in records[1]
    assert (out / "pretrain.txt").read_text().count("step ") == 2
    assert tr.iteration == 2
    # the reference export, read by JAX: the trained student, epoch 2
    params, epoch, _, _ = load_torch_checkpoint(str(ckpts / "model_step_2.pt"))
    assert epoch == 2
    want = export_flax_params(tr.model)
    got = flatten_params(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    latest = CheckpointManager(str(ckpts)).restore("latest")
    for k, v in tr.model.state_dict().items():
        assert torch.equal(latest[k], v), k
    # --checkpoint latest starts from the saved student
    resumed = _run(tmp_path, "--checkpoint", "latest",
                   "--num_train_steps", "0")
    for k, v in tr.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    fresh = _run(tmp_path, "--num_train_steps", "0")
    assert any(not torch.equal(fresh.model.state_dict()[k], v)
               for k, v in tr.model.state_dict().items())


def test_default_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--output_dir", str(tmp_path), "--synthetic_scans", "1",
                  "--synthetic_nodes", "12", "--synthetic_items", "8",
                  "--synthetic_feat_dim", "16", "--num_train_steps", "1"])
