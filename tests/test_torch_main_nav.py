"""The port's navigation CLI (vln_magic_tpu_torch.cli.main_nav) held
against vln_magic_tpu.cli.main_nav: ``parse_args`` of the shipped scripts'
flags; ``--mode valid`` on the synthetic tiny flags (student and MAGIC
teacher, in waves under ``--detailed_output``) and on a small tree in the
reference's layout (connectivity, ``R2R_*_enc.json``, the HDF5 CLIP views;
streamed, as ``run_r2r_valid.sh`` runs), JAX's weights reaching both CLIs
as a ``.pt`` that JAX's ``save_torch_checkpoint`` wrote: metrics to 1e-5,
equal trajectories and submission files, ``--detailed_output`` stop
probabilities to 1e-5; ``--mode serve`` over a scripted stdin giving JAX's
decisions; ``--mode train`` (port only): two intervals write their files,
``best_*.pt`` decodes in JAX's ``Navigator`` as in the port's,
``--auto_resume`` and ``--resume_optimizer`` continue, a SIGTERM saves the
train state after the step in flight; the refused flags and the default
device raise.

One JAX CLI run per configuration, each in a module fixture.
"""

import dataclasses
import functools
import io
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from test_torch_train_rollout import random_flax_params
from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import navigator as jax_navigator
from vln_magic_tpu.cli import main_nav as jax_cli
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.utils.checkpoint import (load_torch_checkpoint,
                                            save_torch_checkpoint)
from vln_magic_tpu_torch.agent import navigator as port_navigator
from vln_magic_tpu_torch.agent import trainer as port_trainer
from vln_magic_tpu_torch.agent.rollout import Tables
from vln_magic_tpu_torch.agent.serving import observation_from_world
from vln_magic_tpu_torch.cli import main_nav as cli
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.utils.checkpoint import restore_reference_checkpoint

TOL = 1e-5
MODEL = ["--student_hidden_size", "32", "--student_num_attention_heads", "2",
         "--teacher_hidden_size", "48", "--teacher_num_attention_heads", "2",
         "--num_l_layers", "1", "--num_pano_layers", "1", "--num_x_layers",
         "1", "--max_instr_len", "32"]
# tests/test_cli_orchestration.py's tiny synthetic flags
TINY = MODEL + ["--batch_size", "4", "--max_action_len", "4",
                "--max_gmap_len", "16", "--synthetic_scans", "1",
                "--synthetic_nodes", "12", "--synthetic_items", "8",
                "--synthetic_feat_dim", "16"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def shape_only_jax_init():
    """JAX's CLI makes its template parameters with a jitted flax ``init``,
    whose compile is most of a tiny run's time, and every JAX run here then
    loads all the weights from ``--resume_file``.  The template is made
    from the shapes alone and filled with NaN, so a weight that the
    checkpoint did not set shows as NaN in JAX's results."""
    orig = FlaxModel.init

    def init(self, rng, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(orig, self), rng, *args,
                                **kwargs)
        return jax.tree_util.tree_map(
            lambda s: jnp.full(s.shape, jnp.nan, s.dtype), shapes)

    FlaxModel.init = init
    yield
    FlaxModel.init = orig


def out_args(path, name):
    return ["--output_dir", str(path), "--name", name]


def config_of(argv):
    """The port's configuration of ``argv`` (build_config, as main)."""
    return cli.build_config(cli.parse_args(argv))


def write_weights(path, cfg, seed):
    """JAX-shaped random weights of ``cfg``'s model, written by JAX's
    ``save_torch_checkpoint``."""
    jax_model_cfg = jcfg.ModelConfig(**dataclasses.asdict(cfg))
    save_torch_checkpoint(random_flax_params(jax_model_cfg, seed), str(path),
                          epoch=5)
    return str(path)


# ---- flags ----------------------------------------------------------------

SCRIPTS = {
    "run_r2r_valid": chip_smoke.R2R_VALID_FLAGS,
    "run_r2r_kdl": chip_smoke.R2R_KDL_FLAGS + ["--iters", "100000",
                                               "--log_every", "1000"],
    "run_rxr_kdl": chip_smoke.RXR_KDL_FLAGS + ["--iters", "100000"],
    "serve": ["--mode", "serve", "--serve_bundle_int8",
              "--export_serve_bundle", "b", "--loadOptim", "--unknown", "1"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_parse_args_matches_jax(tmp_path, name):
    """Every flag parses to JAX's value, the directories made alike; the
    port adds ``--device`` (default ``cuda``) and
    ``--img_backdoor_dict_file`` (default None)."""
    argv = SCRIPTS[name] + ["--root_dir", str(tmp_path / "data")] + \
        out_args(tmp_path, name)
    got, want = vars(cli.parse_args(argv)), vars(jax_cli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got.pop("img_backdoor_dict_file") is None
    assert got == want
    assert os.path.isdir(got["ckpt_dir"]) and os.path.isdir(got["pred_dir"])
    for a in (cli, jax_cli):
        assert a.default_max_gmap_len(want["dataset"]) == \
            {"r2r": 128, "rxr": 208}[want["dataset"]]


def test_scripts_match_the_shipped_files():
    """chip_smoke.py's flag lists are the shipped scripts' flags."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, flags in (("run_r2r_valid", chip_smoke.R2R_VALID_FLAGS),
                        ("run_r2r_kdl", chip_smoke.R2R_KDL_FLAGS),
                        ("run_rxr_kdl", chip_smoke.RXR_KDL_FLAGS)):
        with open(os.path.join(root, "scripts", f"{name}.sh")) as f:
            text = f.read()
        tokens = text.split('flag="', 1)[1].split('"', 1)[0].split()
        drop = {"--root_dir", "--output_dir", "--iters", "--log_every"}
        kept, skip = [], False
        for tok in tokens:
            if tok in drop or skip:
                skip = tok in drop
                continue
            if not tok.startswith("$"):
                kept.append(tok)
        assert kept == flags, name


def test_bf16_feature_table_matches_jax(tmp_path):
    """``--feat_dtype bfloat16``: JAX's rounded table, kept in bf16 on the
    device (``Tables.from_world``) and read as f32."""
    argv = TINY + ["--mode", "valid", "--feat_dtype", "bfloat16"] + \
        out_args(tmp_path, "bf16")
    args = cli.parse_args(argv + CPU)
    cfg = cli.build_config(args)
    world, _ = cli.build_dataset(args, cfg)
    jargs = jax_cli.parse_args(argv)
    jworld, _, _ = jax_cli.build_dataset(
        jargs, jcfg.config_from_dict(dataclasses.asdict(cfg)))
    table = np.asarray(world.tables.features)
    assert table.dtype.name == "bfloat16"
    np.testing.assert_array_equal(table.astype(np.float32),
                                  np.asarray(jworld.tables.features,
                                             np.float32))
    features = Tables.from_world(world.tables, "cpu").features
    assert features.dtype == torch.bfloat16
    np.testing.assert_array_equal(features.float().numpy(),
                                  table.astype(np.float32))


# ---- valid ----------------------------------------------------------------

def _run_valid(main, argv, module):
    """``main(argv)`` with the navigators' ``evaluate`` recorded: (results,
    the predictions of each call, how many of the calls streamed)."""
    nav = module.Navigator
    orig, orig_stream = nav.evaluate, nav._evaluate_stream
    calls, streamed = [], []

    def evaluate(self, items, *a, **kw):
        out = orig(self, items, *a, **kw)
        calls.append(out[1])
        return out

    def evaluate_stream(self, *a, **kw):
        streamed.append(1)
        return orig_stream(self, *a, **kw)

    nav.evaluate, nav._evaluate_stream = evaluate, evaluate_stream
    try:
        return main(argv), calls, len(streamed)
    finally:
        nav.evaluate, nav._evaluate_stream = orig, orig_stream


def _valid_pair(tmp_path, argv):
    """The same valid run through JAX's CLI and the port's."""
    got = _run_valid(cli.main, argv + out_args(tmp_path, "port") + CPU,
                     port_navigator)
    want = _run_valid(jax_cli.main, argv + out_args(tmp_path, "jax"),
                      jax_navigator)
    return got, want


@pytest.fixture(scope="module")
def synthetic_valid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("synthetic_valid")
    base = TINY + ["--mode", "valid", "--train_kdl"]
    cfg = config_of(base + out_args(tmp, "cfg") + CPU)
    argv = base + [
        "--submit", "--test", "--detailed_output",
        "--resume_file", write_weights(tmp / "student.pt", cfg.model, 2),
        "--teacher_resume_file",
        write_weights(tmp / "teacher.pt", cfg.teacher_model, 7)]
    return tmp, _valid_pair(tmp, argv)


@pytest.fixture(scope="module")
def real_valid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("real_valid")
    root = tmp / "datasets"
    chip_smoke.write_dataset_tree(
        str(root), 1, 16, {"train": 6, "val_seen": 7, "val_unseen": 5,
                           "test": 4}, r2r_tokens=40, hdf5_dim=24)
    base = MODEL + ["--mode", "valid", "--root_dir", str(root),
                    "--image_feat_size", "16", "--batch_size", "3",
                    "--max_action_len", "5", "--max_gmap_len", "16"]
    cfg = config_of(base + out_args(tmp, "cfg") + CPU)
    assert cfg.model.vocab_size == 50265          # no synthetic rewrite
    # no --detailed_output: each split streams, as run_r2r_valid.sh's
    argv = base + ["--submit", "--resume_file",
                   write_weights(tmp / "student.pt", cfg.model, 8)]
    return tmp, _valid_pair(tmp, argv)


def _check_valid(tmp, pair, splits):
    ((got, got_calls, _), (want, want_calls, _)) = pair
    assert sorted(got) == sorted(want) == sorted(splits)
    assert all(avg["action_steps"] >= 1 for avg in want.values())   # moves
    for split, avg in want.items():
        assert sorted(got[split]) == sorted(avg)
        for k, v in avg.items():
            np.testing.assert_allclose(got[split][k], v, rtol=TOL, atol=TOL,
                                       err_msg=f"{split} {k}")
    assert len(got_calls) == len(want_calls)
    for g, w in zip(got_calls, want_calls):
        assert [p["instr_id"] for p in g] == [p["instr_id"] for p in w]
        for a, b in zip(g, w):
            assert a["trajectory"] == b["trajectory"], a["instr_id"]
            assert ("details" in a) == ("details" in b)
            for node, d in b.get("details", {}).items():
                np.testing.assert_allclose(a["details"][node]["stop_prob"],
                                           d["stop_prob"], rtol=0, atol=TOL)
    subs = sorted(os.listdir(tmp / "test" / "jax" / "preds"))
    assert subs == sorted(os.listdir(tmp / "test" / "port" / "preds"))
    assert subs
    for name in subs:
        assert json.loads((tmp / "test" / "port" / "preds" / name)
                          .read_text()) == \
            json.loads((tmp / "test" / "jax" / "preds" / name).read_text())


def test_synthetic_valid_matches_jax(synthetic_valid):
    """Student and teacher decodes in waves (``--detailed_output`` turns
    streaming off), ``submit_*.json`` and ``details``."""
    tmp, pair = synthetic_valid
    _check_valid(tmp, pair, ["val_seen", "val_unseen", "teacher_val_seen",
                             "teacher_val_unseen"])
    assert len(pair[0][1]) == 6                   # 3 splits x 2 models
    assert pair[0][2] == pair[1][2] == 0
    assert all("details" in p for c in pair[0][1] for p in c)
    record = (tmp / "test" / "port" / "logs" / "valid.txt").read_text()
    assert "test: 4 predictions written" in record


def test_real_layout_valid_matches_jax(real_valid):
    """The reference's layout: annotations split per instruction, the HDF5
    views sliced to --image_feat_size, RoBERTa-sized vocabulary; each split
    streamed (``shard_items``, the streamed ``evaluate``,
    ``gather_predictions``), as ``run_r2r_valid.sh`` runs."""
    tmp, pair = real_valid
    _check_valid(tmp, pair, ["val_seen", "val_unseen"])
    assert [len(c) for c in pair[0][1]] == [7, 5, 4]
    assert pair[0][2] == pair[1][2] == 3
    assert not any("details" in p for c in pair[0][1] for p in c)


# ---- serve ----------------------------------------------------------------

class Robot:
    """The serve protocol's client as a stdin: each line is written after
    the server answered the one before, so an observation follows the last
    decision; the replies are read from ``out``."""

    def __init__(self, world, out, blob):
        self.world, self.out, self.blob = world, out, blob

    def last(self):
        return json.loads(self.out.getvalue().strip().splitlines()[-1])

    def __iter__(self):
        g = self.world.graphs[0]
        instr = np.random.default_rng(4).integers(4, 2000, 20).tolist()
        yield json.dumps({"type": "session", "instruction": instr})
        cur = 2
        for step in range(6):
            msg = chip_smoke.observation_message(
                observation_from_world(self.world, 0, cur, 0.4))
            if step % 2:
                msg["pano_feats"] = np.asarray(
                    self.world.tables.features[0, cur]).tolist()
            yield json.dumps(msg)
            dec = self.last()
            if step == 0:
                yield json.dumps({"type": "save", "path": self.blob})
                yield json.dumps({"type": "restore", "path": self.blob})
            if dec["type"] != "decision" or dec["stop"]:
                break
            cur = g.index[dec["target"]]
        yield json.dumps({"type": "bogus"})
        yield json.dumps({"type": "finish"})
        yield json.dumps({"type": "quit"})


def _serve(main, argv, world, tmp, monkeypatch):
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    monkeypatch.setattr("sys.stdin", Robot(world, out, f"{tmp}.blob"))
    main(argv)
    monkeypatch.undo()
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_serve_matches_jax(synthetic_valid, tmp_path, monkeypatch):
    """The JSON-lines protocol with JAX's decisions: session, observations
    (base64 and list features), save/restore after the first decision, an
    unknown message, finish."""
    tmp, _ = synthetic_valid
    world = make_synthetic_world(num_scans=1, nodes_per_scan=12, feat_dim=16,
                                 seed=6)
    cands = world.tables.max_candidates
    argv = TINY + ["--mode", "serve", "--serve_max_nodes", "12",
                   "--serve_max_cands", str(cands),
                   "--resume_file", str(tmp / "student.pt")]
    got = _serve(cli.main, argv + out_args(tmp_path, "port") + CPU, world,
                 tmp_path / "port", monkeypatch)
    want = _serve(jax_cli.main, argv + out_args(tmp_path, "jax"), world,
                  tmp_path / "jax", monkeypatch)
    assert [m["type"] for m in got] == [m["type"] for m in want]
    kinds = [m["type"] for m in want]
    assert kinds.count("decision") >= 2 and "error" in kinds
    for a, b in zip(got, want):
        a.pop("latency_ms", None), b.pop("latency_ms", None)
        if a["type"] in ("saved", "error"):
            a.pop("path", None), b.pop("path", None)
            a.pop("message", None), b.pop("message", None)
        assert a == b


def test_serve_bundle_export_and_load(synthetic_valid, tmp_path,
                                      monkeypatch):
    """``--export_serve_bundle`` (int8) writes the port's bundle and exits;
    ``--serve_bundle`` serves from it, warning about the flags it pins; a
    JAX bundle is refused."""
    tmp, _ = synthetic_valid
    bundle = str(tmp_path / "bundle")
    base = TINY + ["--mode", "serve", "--serve_max_nodes", "12"] + CPU
    cli.main(base + out_args(tmp_path, "export") + [
        "--resume_file", str(tmp / "student.pt"), "--export_serve_bundle",
        bundle, "--serve_bundle_int8"])
    meta = json.loads((tmp_path / "bundle" / "meta.json").read_text())
    assert meta["quantized"] and meta["max_nodes"] == 12
    world = make_synthetic_world(num_scans=1, nodes_per_scan=12, feat_dim=16,
                                 seed=6)
    out = _serve(cli.main, base + out_args(tmp_path, "bundle") + [
        "--serve_bundle", bundle, "--fusion", "global"], world,
        tmp_path / "b", monkeypatch)
    kinds = [m["type"] for m in out]
    assert kinds[:3] == ["warning", "loaded", "ready"] and "final" in kinds
    assert "--fusion" in out[0]["message"]
    (tmp_path / "jax_bundle").mkdir()
    (tmp_path / "jax_bundle" / "meta.json").write_text(json.dumps(
        {"format": "vln_magic_tpu.serving_bundle.v3"}))
    with pytest.raises(ValueError, match="JAX serving bundle"):
        cli.main(base + out_args(tmp_path, "jb") + [
            "--serve_bundle", str(tmp_path / "jax_bundle")])


# ---- train (port only) ----------------------------------------------------

def test_train_writes_resumes_and_decodes_in_jax(tmp_path, monkeypatch):
    # tensorboard is optional; its import would dominate this tiny run
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    argv = TINY + ["--mode", "train", "--train_kdl", "--log_every", "1",
                   "--save_optimizer"] + out_args(tmp_path, "tr") + CPU
    trainer = cli.main(argv + ["--iters", "2"])
    assert trainer.iteration == 2
    a = cli.parse_args(argv)
    assert {"best_val_seen.pt", "best_val_unseen.pt", "latest_dict.pt",
            "train_state"} <= set(os.listdir(a.ckpt_dir))
    assert os.path.isdir(os.path.join(a.ckpt_dir, "latest_dict.pt.opt"))
    assert {"training_args.json", "metrics.jsonl", "train.txt"} <= set(
        os.listdir(a.log_dir))
    records = [json.loads(line) for line in open(
        os.path.join(a.log_dir, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [1, 1, 1, 2, 2, 2]
    assert all(np.isfinite(v) for r in records for v in r.values())

    # best_val_seen.pt decodes in JAX's Navigator as in the port's (in
    # waves, the programs of synthetic_valid's JAX run)
    cfg = cli.build_config(a)
    world, splits = cli.build_dataset(a, cfg)
    items = splits["val_seen"]
    nav = port_navigator.Navigator(cfg, world, device="cpu")
    best = os.path.join(a.ckpt_dir, "best_val_seen.pt")
    restore_reference_checkpoint(nav.model, best)
    (_, _), got = nav.evaluate(items, detailed_output=True)
    ja = jax_cli.parse_args([x for x in argv if x not in CPU])
    jc = jcfg.config_from_dict(dataclasses.asdict(cfg))
    jw, jsplits, _ = jax_cli.build_dataset(ja, jc)
    jnav = jax_navigator.Navigator(jc, jw)
    jnav.params, epoch, missing, _ = load_torch_checkpoint(
        best, template=jnav.params)
    assert not missing and epoch in (1, 2)
    (_, _), want = jnav.evaluate(jsplits["val_seen"],
                                 detailed_output=True)
    assert [p["trajectory"] for p in got] == [p["trajectory"] for p in want]

    # --auto_resume continues from iteration 2
    trainer = cli.main(argv + ["--iters", "3", "--auto_resume"])
    assert trainer.iteration == 3
    record = open(os.path.join(a.log_dir, "train.txt")).read()
    assert "auto-resumed train state at iter 2" in record
    # --resume_file with the optimizer sidecar; a JAX (orbax) one refuses
    latest = os.path.join(a.ckpt_dir, "latest_dict.pt")
    resumed = cli.main(argv + ["--iters", "3", "--resume_file", latest,
                               "--resume_optimizer"])
    assert resumed.iteration == 3
    saved, loaded = trainer.opt.state_dict(), resumed.opt.state_dict()
    assert saved["count"] == loaded["count"] == 3
    assert all(torch.equal(x, y) for x, y in zip(saved["mu"], loaded["mu"]))
    os.makedirs(os.path.join(tmp_path, "jax.pt.opt", "opt_state"))
    torch.save({}, os.path.join(tmp_path, "jax.pt"))
    with pytest.raises(ValueError, match="orbax"):
        cli.main(argv + ["--iters", "3", "--resume_file",
                         os.path.join(tmp_path, "jax.pt"), "--loadOptim"])


def test_sigterm_saves_after_the_step_in_flight(tmp_path, monkeypatch):
    """A SIGTERM that lands inside a train step is acted on when the step
    has ended: the train state saved is the whole step's, exit 143."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    orig = port_trainer.Trainer.train_step

    def step(self, items):
        if self.iteration == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, items)

    monkeypatch.setattr(port_trainer.Trainer, "train_step", step)
    argv = TINY + ["--mode", "train", "--iters", "4", "--log_every", "4"] + \
        out_args(tmp_path, "sig") + CPU
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 143
    a = cli.parse_args(argv)
    state = port_trainer.CheckpointManager(a.ckpt_dir).restore("train_state")
    assert state["iteration"] == 2
    assert "SIGTERM at iter 2" in open(os.path.join(a.log_dir,
                                                    "train.txt")).read()
    assert signal.getsignal(signal.SIGTERM) is not None


# ---- the default device ---------------------------------------------------

@pytest.mark.parametrize("mode", ["valid", "train", "serve"])
def test_default_device_needs_a_gpu(tmp_path, mode):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(TINY + ["--mode", mode] + out_args(tmp_path, mode))
