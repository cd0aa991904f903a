"""The port's navigation CLI on the card: ``--mode valid`` on a tiny tree in
the reference's layout and ``--mode serve`` over a scripted stdin, each
equal to the same run on the CPU, and the nDTW expert's scores and actions
on the card equal to the CPU's along a rollout of random moves.

These tests need an NVIDIA GPU; elsewhere they skip.  They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_main_nav_cuda.py

The tree writer and the serve protocol's messages are ``chip_smoke.py``'s
(phase 13), imported from the repository's root.
"""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from vln_magic_tpu_torch.agent.navigator import episodes_from_items
from vln_magic_tpu_torch.agent.rollout import Rollout, Tables
from vln_magic_tpu_torch.agent.serving import observation_from_world
from vln_magic_tpu_torch.cli import main_nav as cli
from vln_magic_tpu_torch.config import EnvConfig, ModelConfig
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ["--student_hidden_size", "32", "--student_num_attention_heads", "2",
         "--num_l_layers", "1", "--num_pano_layers", "1", "--num_x_layers",
         "1", "--max_instr_len", "32", "--batch_size", "4",
         "--max_action_len", "5", "--max_gmap_len", "16"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _weights(tmp_path, argv):
    """A ``.pt`` of seeded weights for ``argv``'s student."""
    from vln_magic_tpu_torch.utils.checkpoint import save_reference_checkpoint
    from vln_magic_tpu_torch.utils.weights import init_params

    cfg = cli.build_config(cli.parse_args(argv))
    model = DualScaleVLNBert(cfg.model, device="cpu")
    init_params(model, 3, std=0.2)
    path = str(tmp_path / "student.pt")
    save_reference_checkpoint(model, path)
    return path


@pytest.mark.parametrize("detailed", [False, True])
def test_valid_on_the_card_equals_the_cpu(chip_smoke, tmp_path, detailed):
    """Streamed, as ``run_r2r_valid.sh`` runs, and in waves under
    ``--detailed_output``."""
    root = tmp_path / "datasets"
    chip_smoke.write_dataset_tree(str(root), 1, 16,
                                  {"train": 4, "val_seen": 7, "val_unseen": 5},
                                  r2r_tokens=40)
    argv = MODEL + ["--mode", "valid", "--root_dir", str(root),
                    "--image_feat_size", "16", "--submit",
                    "--output_dir", str(tmp_path)]
    argv += ["--detailed_output"] * detailed
    argv += ["--resume_file", _weights(tmp_path, argv + ["--name", "w"])]
    runs = {dev: cli.main(argv + ["--name", dev, "--device", dev])
            for dev in ("cuda", "cpu")}
    for split, avg in runs["cpu"].items():
        for k, v in avg.items():
            np.testing.assert_allclose(runs["cuda"][split][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{split} {k}")
        preds = [json.loads((tmp_path / "test" / dev / "preds" /
                             f"submit_{split}.json").read_text())
                 for dev in ("cuda", "cpu")]
        assert preds[0] == preds[1]


def test_serve_on_the_card_equals_the_cpu(chip_smoke, tmp_path, monkeypatch):
    world = make_synthetic_world(num_scans=1, nodes_per_scan=12, feat_dim=16,
                                 seed=6)
    argv = MODEL + ["--mode", "serve", "--synthetic_feat_dim", "16",
                    "--serve_max_nodes", "12", "--serve_max_cands",
                    str(world.tables.max_candidates),
                    "--output_dir", str(tmp_path)]
    argv += ["--resume_file", _weights(tmp_path, argv + ["--name", "w"])]
    outs = {}
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        g = world.graphs[0]

        def robot():
            yield json.dumps({"type": "session",
                              "instruction": list(range(4, 24))})
            cur = 3
            for _ in range(5):
                yield json.dumps(chip_smoke.observation_message(
                    observation_from_world(world, 0, cur, 0.2)))
                dec = json.loads(out.getvalue().splitlines()[-1])
                if dec["type"] != "decision" or dec["stop"]:
                    break
                cur = g.index[dec["target"]]
            yield json.dumps({"type": "finish"})

        monkeypatch.setattr("sys.stdout", out)
        monkeypatch.setattr("sys.stdin", robot())
        cli.main(argv + ["--name", dev, "--device", dev])
        monkeypatch.undo()
        outs[dev] = [json.loads(line) for line in out.getvalue().splitlines()]
        for m in outs[dev]:
            m.pop("latency_ms", None)
    assert outs["cuda"] == outs["cpu"]
    assert [m["type"] for m in outs["cpu"]][-1] == "final"


def test_ndtw_on_the_card_equals_the_cpu(chip_smoke):
    """Scores within 1e-5 and equal expert actions at every step of a
    rollout of random moves."""
    spec = {"num_scans": 1, "nodes_per_scan": 40, "feat_dim": 16, "seed": 4}
    world = make_synthetic_world(**spec)
    items = make_synthetic_instructions(world, 8, np.random.default_rng(2),
                                        min_path=3, max_path=8)
    env = EnvConfig(max_action_len=12, max_gmap_len=40, max_instr_len=32,
                    expert_policy="ndtw")
    cfg = ModelConfig(hidden_size=32, num_attention_heads=2, num_l_layers=1,
                      num_pano_layers=1, num_x_layers=1, image_feat_size=16)
    sides = {}
    for dev in ("cuda", "cpu"):
        r = Rollout(Tables.from_world(world.tables, dev), env,
                    DualScaleVLNBert(cfg, device=dev))
        sides[dev] = (r, episodes_from_items(r.t, items, 8))
    rng = np.random.default_rng(3)
    for t_step in range(env.max_action_len - 1):
        got = {}
        for dev, (r, st) in sides.items():
            ep = r.episode_tables(st)
            gmap = r.assemble_gmap_base(st, ep)
            got[dev] = (r._ndtw_scores(st, gmap, ep).cpu(),
                        r.teacher_action(st, gmap, t_step, False, ep).cpu(),
                        gmap, ep)
        assert float((got["cuda"][0] - got["cpu"][0]).abs().max()) <= 1e-5
        assert torch.equal(got["cuda"][1], got["cpu"][1])
        gmap = got["cpu"][2]
        sel = (gmap["gmap_masks"] & ~gmap["gmap_visited_masks"]).numpy()
        logits = np.where(sel, rng.standard_normal(sel.shape), -1e9)
        logits[:, 0] = -5.0
        action = torch.from_numpy(logits.argmax(1))
        stop = torch.from_numpy(rng.random(len(items)).astype(np.float32))
        for dev, (r, st) in sides.items():
            g = gmap if dev == "cpu" else got["cuda"][2]
            r.transition(st, g, action.to(dev), stop.to(dev), t_step,
                         r.assemble_pano(st), got[dev][3])
        assert torch.equal(sides["cuda"][1].traj_nodes.cpu(),
                           sides["cpu"][1].traj_nodes)
