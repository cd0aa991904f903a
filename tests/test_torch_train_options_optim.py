"""The port's optimizers ``radam``, ``ralamb``, ``rangerlars`` and ``rms``
and the ``fix_*`` freezing held against vln_magic_tpu's ``make_optimizer``
(optax, with ``optax.masked(set_to_zero)`` after the chain as JAX's
``Trainer`` adds it) over seven steps on a seeded tree with flax names, so
that one lookahead sync falls inside (to 1e-5 relative, 1e-7 absolute);
``PretrainTrainer`` taking them; and the navigation CLI's ``--env_edit``,
``--use_aug_env``, ``--aug`` and ``--kdl_adaptive_ability_weight_type
grad`` at the tiny synthetic flags, the aug table equal to JAX's.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import optax

from chip_smoke import (FIX_FLAGS, GOLDEN_OPTIONS_SPEC as SPEC,
                        options_optimizer_run, seeded_flax_params,
                        write_dataset_tree)
from test_torch_main_nav import CPU, MODEL, TINY, out_args
from test_torch_train_options import check_fixture
from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.cli import main_nav as jax_cli
from vln_magic_tpu.utils.checkpoint import flatten_params, unflatten_params
from vln_magic_tpu_torch.cli import main_nav as cli

RUNS = [tuple(r) for r in SPEC["optim"]["runs"]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_optimizer_run(kind, fix):
    """JAX's optimizer ``kind`` (``fix``: every ``fix_*`` flag on, the
    trainer's mask after the chain) on the seeded tree and gradients of
    ``chip_smoke.options_optimizer_run``: the parameters after each step,
    by name [steps, ...]."""
    o = SPEC["optim"]
    names = sorted(o["tree"])
    params = unflatten_params(seeded_flax_params(o["tree"], SPEC["seed"]))[0]
    cfg = jcfg.MagicConfig(train=jcfg.TrainConfig(
        optim=kind, lr=o["lr"], grad_clip=o["grad_clip"],
        weight_decay=o["weight_decay"], **{f: fix for f in FIX_FLAGS}))
    opt = jax_trainer.make_optimizer(cfg)
    if fix:
        mask = jax_trainer.Trainer._frozen_mask(
            types.SimpleNamespace(cfg=cfg), params)
        opt = optax.chain(opt, optax.masked(optax.set_to_zero(), mask))
    state = opt.init(params)
    update = jax.jit(opt.update)
    rng = np.random.default_rng(SPEC["seed"] + 1)
    out = {k: [] for k in names}
    for _ in range(o["steps"]):
        grads = unflatten_params({k: np.asarray(
            o["grad_std"] * rng.standard_normal(tuple(o["tree"][k])),
            np.float32) for k in names})[0]
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, v in flatten_params(params).items():
            out[k].append(np.asarray(v))
    return {k: np.stack(v) for k, v in out.items()}


def optim_arrays() -> dict:
    return {f"optim/{kind}/{int(fix)}/{k}": v for kind, fix in RUNS
            for k, v in jax_optimizer_run(kind, fix).items()}


@pytest.mark.parametrize("kind,fix", RUNS)
def test_optimizer_matches_optax(kind, fix):
    want = jax_optimizer_run(kind, fix)
    got = options_optimizer_run(kind, fix)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    frozen = [k for k in want if fix and any(
        s in k for s in ("embeddings", "local_", "pano_encoder"))]
    for k in frozen:        # the mask holds a frozen leaf at its start
        np.testing.assert_array_equal(got[k][-1], seeded_flax_params(
            SPEC["optim"]["tree"], SPEC["seed"])[k])
    assert len(frozen) == (5 if fix else 0)


def test_rangerlars_state_resumes_the_slow_weights(tmp_path):
    """``save_state`` carries the lookahead's slow weights: a trainer
    restored after one step takes the next step as the original does."""
    from test_torch_train_options import port_options_trainer

    a, items = port_options_trainer("a2c", optim="rangerlars", lr=1e-3)
    a.train_step(items)
    a.save_state(str(tmp_path))
    b, _ = port_options_trainer("a2c", optim="rangerlars", lr=1e-3)
    assert b.load_state(str(tmp_path))
    for x, y in zip(a.opt.slow, b.opt.slow):
        assert torch.equal(x, y)
    a.train_step(items)
    b.train_step(items)
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)


def test_optimizer_fixture_is_a_fresh_jax_run():
    check_fixture(optim_arrays())


def test_pretrain_trainer_takes_the_new_optimizers():
    """``PretrainTrainer`` builds its optimizer with ``make_optimizer``, as
    JAX's does, so the new families reach pretraining."""
    from test_torch_pretrain import spec_config
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer
    from vln_magic_tpu_torch import config as tcfg

    world = make_synthetic_world(num_scans=1, nodes_per_scan=10, feat_dim=16,
                                 seed=3)
    tr = PretrainTrainer(spec_config(tcfg, optim="rangerlars"), world,
                         device="cpu")
    assert tr.opt.kind == "rangerlars" and len(tr.opt.slow) == len(
        list(tr.model.parameters()))


# ---- the navigation CLI ---------------------------------------------------

@pytest.mark.parametrize("layout", ["synthetic", "tree"])
def test_aug_table_matches_jax(tmp_path, layout):
    """``--env_edit``'s feature table: the hash store at ``--seed`` + 1 on
    the synthetic world, at seed 1 on a dataset tree (no EnvEdit file), as
    JAX's ``build_dataset`` builds it."""
    argv = TINY + ["--mode", "train", "--env_edit"] + out_args(tmp_path, "a")
    if layout == "tree":
        root = str(tmp_path / "datasets")
        write_dataset_tree(root, 1, 12, {"train": 4, "val_seen": 4},
                           r2r_tokens=20)
        argv = MODEL + ["--mode", "train", "--env_edit", "--root_dir", root,
                        "--image_feat_size", "16"] + out_args(tmp_path, "a")
    args = cli.parse_args(argv + CPU)
    cfg = cli.build_config(args)
    world, _ = cli.build_dataset(args, cfg)
    got = cli.aug_feature_table(args, world)
    ja = jax_cli.parse_args(argv)
    _, _, want = jax_cli.build_dataset(
        ja, jcfg.config_from_dict(dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.asarray(world.tables.features))


def _metrics(a):
    return [json.loads(line) for line in open(
        os.path.join(a.log_dir, "metrics.jsonl"))]


@pytest.mark.parametrize("flags", [["--env_edit", "--aug", "aug.json"],
                                   ["--use_aug_env", "--aug", "aug.json",
                                    "--aug_times", "2"],
                                   ["--aug", "aug.json"]])
def test_cli_trains_on_aug_batches(tmp_path, monkeypatch, flags):
    """Train and aug batches alternate every ``--aug_times``; the aug
    feature table is built only under ``--env_edit``/``--use_aug_env``."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    argv = TINY + ["--mode", "train", "--iters", "3", "--log_every", "3"] + \
        flags + out_args(tmp_path, "aug") + CPU
    trainer = cli.main(argv)
    a = cli.parse_args(argv)
    edited = "--env_edit" in flags or "--use_aug_env" in flags
    assert (trainer.tables.aug_features is not None) == edited
    times = int(flags[flags.index("--aug_times") + 1]) \
        if "--aug_times" in flags else 1
    share = np.mean([it % (times + 1) != 0 for it in range(3)])
    loss = [r for r in _metrics(a) if "loss/aug" in r]
    assert loss and np.isclose(loss[0]["loss/aug"], share)
    assert all(np.isfinite(v) for r in loss for v in r.values())


def test_cli_refreshes_the_grad_ability_weights(tmp_path, monkeypatch):
    """``--kdl_adaptive_ability_weight_type grad``: the norms are measured
    at iteration 0 and every ``--aw_update_iter``, and logged as
    ``ability_grad/<i>`` after each interval."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    from vln_magic_tpu_torch.agent import trainer as port_trainer

    calls = []
    orig = port_trainer.Trainer.update_ability_grads

    def counted(self, items, *args, **kwargs):
        calls.append(self.iteration)
        return orig(self, items, *args, **kwargs)

    monkeypatch.setattr(port_trainer.Trainer, "update_ability_grads",
                        counted)
    argv = TINY + ["--mode", "train", "--iters", "2", "--log_every", "1",
                   "--train_kdl", "--kdl_adaptive_ability_weight",
                   "--kdl_adaptive_ability_weight_type", "grad",
                   "--aw_update_iter", "2"] + out_args(tmp_path, "aw") + CPU
    trainer = cli.main(argv)
    assert calls == [0, 2]
    logged = [r for r in _metrics(cli.parse_args(argv))
              if "ability_grad/0" in r]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(r[f"ability_grad/{i}"] > 0 for r in logged for i in range(4))
    assert np.all(trainer.ability_grads > 0)
