"""The image backdoor's dictionary on the port's normal path, port only: the
rollout z-dicts carry it (``build_rollout_zdicts(img=)``) and the panorama
reads it; its TSV round-trips at ``image_feat_size``; the navigation CLI
runs the head from ``--img_backdoor_dict_file`` in ``valid`` and keeps it
through a refresh and in serving, and refuses ``--do_back_img`` without
the file; a serving bundle keeps it; one ``evaluate`` with every head
records the five ``intervention.*`` spans.  Tiny sizes on the CPU, no JAX.
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vln_magic_tpu_torch.agent.interventions import Zdict, build_rollout_zdicts
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.serving import NavServer
from vln_magic_tpu_torch.cli import main_nav as cli
from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig, ModelConfig,
                                        TrainConfig)
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.utils import profiling
from vln_magic_tpu_torch.utils.weights import init_params

FEAT = 16
HEADS = dict(do_back_txt=True, do_back_img=True, do_front_txt=True,
             do_front_img=True, do_front_his=True)
SPANS = {"intervention.backdoor_txt", "intervention.frontdoor_txt",
         "intervention.backdoor_img", "intervention.frontdoor_vp",
         "intervention.frontdoor_gmap"}
# the CLI's tiny synthetic flags (tests/test_torch_main_nav.py's TINY)
TINY = ["--student_hidden_size", "32", "--student_num_attention_heads", "2",
        "--num_l_layers", "1", "--num_pano_layers", "1", "--num_x_layers",
        "1", "--max_instr_len", "32", "--batch_size", "4",
        "--max_action_len", "4", "--max_gmap_len", "16",
        "--synthetic_scans", "1", "--synthetic_nodes", "12",
        "--synthetic_items", "8", "--synthetic_feat_dim", str(FEAT),
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _img(rows=5, dim=FEAT, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random(rows) + 0.1
    return Zdict(rng.standard_normal((rows, dim)).astype(np.float32),
                 p / p.sum(), [f"img{i}" for i in range(rows)])


def _cfg(**heads):
    return MagicConfig(
        model=ModelConfig(vocab_size=100, hidden_size=32,
                          num_attention_heads=2, num_l_layers=1,
                          num_pano_layers=1, num_x_layers=1,
                          image_feat_size=FEAT, max_position_embeddings=64,
                          **heads),
        env=EnvConfig(max_action_len=4, max_gmap_len=16, max_instr_len=24),
        train=TrainConfig(batch_size=4))


def _all_dicts(d=32):
    rng = np.random.default_rng(1)
    back = {k: Zdict(rng.standard_normal((n, d)).astype(np.float32),
                     np.full(n, 1.0 / n)) for k, n in (("direction", 3),
                                                       ("landmark", 4))}
    front = {k: rng.standard_normal((6, d)).astype(np.float32)
             for k in ("txt", "vp", "gmap")}
    return build_rollout_zdicts(back, front, pad_entries=8, img=_img())


def test_rollout_zdicts_carry_the_image_dictionary_and_the_head_reads_it():
    img = _img()
    z = build_rollout_zdicts(pad_entries=81, img=img)
    assert sorted(z) == ["z_img_feats", "z_img_pzs"]
    np.testing.assert_array_equal(z["z_img_feats"], img.features)
    assert z["z_img_pzs"].shape == (5, 1)          # unpadded
    assert "z_img_feats" not in build_rollout_zdicts(pad_entries=81)
    model = DualScaleVLNBert(_cfg(do_back_img=True).model, device="cpu")
    init_params(model, 0)
    rng = np.random.default_rng(2)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    args = (t(rng.standard_normal((2, 6, FEAT))), t(rng.random((2, 6, 7))),
            torch.ones((2, 6), dtype=torch.long),
            torch.ones((2, 6), dtype=torch.bool))
    with torch.no_grad():
        plain = model.panorama(*args)[0]
        with_dict = model.panorama(
            *args, z_img_feats=t(z["z_img_feats"]).expand(2, 5, FEAT),
            z_img_pzs=t(z["z_img_pzs"]).expand(2, 5, 1))[0]
    # at BERT-init weights the head's term is small beside its LayerNorm,
    # yet far above f32 rounding
    assert (plain - with_dict).abs().max() > 1e-5


def test_the_image_tsv_round_trips(tmp_path):
    img = _img(rows=50, dim=24)
    img.save_tsv(str(tmp_path / "image_z_dict_clip_50.tsv"))
    back = Zdict.load_tsv(str(tmp_path / "image_z_dict_clip_50.tsv"), 24)
    assert back.keys == img.keys
    np.testing.assert_array_equal(back.features, img.features)
    np.testing.assert_allclose(back.pzs, img.pzs, rtol=1e-7)


@pytest.mark.parametrize("heads", [["--do_back_img"],
                                   ["--do_back_img", "--do_back_txt"]],
                         ids=["image", "image_and_rebuilt_text"])
def test_valid_runs_the_image_backdoor_from_its_file(tmp_path, heads):
    """The image file alone, or beside text dictionaries rebuilt from the
    model on the train split."""
    path = str(tmp_path / "img.tsv")
    _img().save_tsv(path)
    argv = TINY + ["--mode", "valid", "--img_backdoor_dict_file", path,
                   "--output_dir", str(tmp_path), "--name", "v"] + heads
    profiling.reset()
    with profiling.recording():
        results = cli.main(argv)
    names = {s.name for s in profiling.recorded()}
    profiling.reset()
    assert sorted(results) == ["val_seen", "val_unseen"]
    assert "intervention.backdoor_img" in names
    assert ("intervention.backdoor_txt" in names) == (len(heads) == 2)
    # a refresh rebuilds each role's dictionaries and keeps the image one
    args = cli.parse_args(argv)
    cfg = cli.build_config(args)
    trainer = SimpleNamespace(kdl=False, model=None,
                              autocast=contextlib.nullcontext)
    zd = cli.refresh_intervention_dicts(args, cfg, trainer, None, [], 1)
    assert trainer.zdicts is zd
    np.testing.assert_array_equal(zd["student"]["z_img_feats"],
                                  _img().features)


def test_do_back_img_without_its_file_refuses_to_start(tmp_path):
    argv = TINY + ["--mode", "valid", "--do_back_img",
                   "--output_dir", str(tmp_path), "--name", "v"]
    for extra in ([], ["--img_backdoor_dict_file", str(tmp_path / "no")]):
        with pytest.raises(SystemExit, match="--img_backdoor_dict_file"):
            cli.main(argv + extra)


def test_a_serving_bundle_keeps_the_image_dictionary(tmp_path):
    """``--mode serve`` hands the file's dictionary to the server, whose
    exported bundle serves with it."""
    path = str(tmp_path / "img.tsv")
    _img().save_tsv(path)
    cli.main(TINY + ["--mode", "serve", "--do_back_img",
                     "--img_backdoor_dict_file", path,
                     "--export_serve_bundle", str(tmp_path / "b"),
                     "--output_dir", str(tmp_path), "--name", "s"])
    back = NavServer.from_bundle(str(tmp_path / "b"), device="cpu")
    assert back.cfg.model.do_back_img
    np.testing.assert_array_equal(back._zd["z_img_feats"].numpy(),
                                  _img().features)
    np.testing.assert_array_equal(back._zd["z_img_pzs"].numpy(),
                                  _img().pzs)


def test_evaluate_records_the_five_intervention_spans():
    cfg = _cfg(**HEADS)
    world = make_synthetic_world(num_scans=1, nodes_per_scan=12,
                                 feat_dim=FEAT, seed=3)
    items = make_synthetic_instructions(world, 4, np.random.default_rng(3),
                                        vocab_size=100, max_len=20)
    nav = Navigator(cfg, world, device="cpu")
    profiling.reset()
    with profiling.recording():
        nav.evaluate(items, zdicts={"student": _all_dicts()})
    names = {s.name for s in profiling.recorded()}
    profiling.reset()
    assert SPANS <= names
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **{k: False for k in HEADS}))
    with profiling.recording():
        Navigator(cfg, world, device="cpu").evaluate(
            items, zdicts={"student": _all_dicts()})
    names = {s.name for s in profiling.recorded()}
    profiling.reset()
    assert not names & SPANS
