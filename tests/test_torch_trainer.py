"""The port's Trainer (vln_magic_tpu_torch.agent.trainer) held against
vln_magic_tpu's on the same weights and items: ``compute_grads`` of the
DAgger step with distillation, ICoD, MKTD and learned ability weights (the
objective, and every gradient leaf of the student and the teacher to 1e-4
of the leaf's largest magnitude), one ``sgd`` and one ``adamw`` step, the
learning-rate schedules against optax's, ``remat``, the entry points that
stay unported, and the golden fixture that ``chip_smoke.py`` checks on the card.

One JAX trainer and one ``compute_grads`` serve the whole file (module
fixture).  Its configuration is the golden fixture's (``GOLDEN``): dropout
0 and argmax DAgger feedback make the step deterministic on both sides.

Regenerate the fixture with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_trainer.py``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import optax

from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import trainer as port_trainer
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import (
    make_synthetic_instructions as port_instructions)
from vln_magic_tpu_torch.utils.weights import load_trainer_params

HERE = os.path.dirname(__file__)
# the golden training step: configuration, world, items and the rollout
# seed, as JSON so that chip_smoke.py can rebuild it with no JAX
GOLDEN = {
    "seed": 7,
    "world": {"num_scans": 1, "nodes_per_scan": 14, "feat_dim": 16,
              "seed": 9},
    "items": {"num_items": 4, "vocab_size": 120, "min_path": 2,
              "max_path": 4},
    "model": {"vocab_size": 120, "hidden_size": 32, "num_attention_heads": 2,
              "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
              "image_feat_size": 16, "max_position_embeddings": 64,
              "kd_heads": True, "kd_target_size": 64, "hidden_dropout": 0.0,
              "attention_dropout": 0.0},
    "teacher_model": {"hidden_size": 64, "kd_target_size": 32},
    "env": {"max_action_len": 4, "max_gmap_len": 16, "max_instr_len": 32},
    "train": {"batch_size": 4, "train_alg": "dagger", "ml_weight": 0.2,
              "dagger_sample": "argmax"},
    "distill": {"train_kdl": True, "train_teacher": True, "t_lr": 1e-4,
                "teacher_sample_hard_mining": True,
                "adaptive_ability_weight": True,
                "adaptive_ability_weight_type": "learned_weight"},
}
FIXTURE = os.path.join(HERE, "fixtures", f"golden_train_{GOLDEN['seed']}.npz")
# gradient leaves the fixture keeps, per partition (the teacher's own
# projection heads take no gradient: they project nothing in training)
_LEAVES = ("params.cls_fuse.kernel",
           "params.lang_encoder.layer_0.attention.query.kernel",
           "params.global_encoder.layer_0.ffn.output.bias",
           "params.kdl_global_weight")
GOLDEN_LEAVES = {"params": _LEAVES + ("params.kdl_img_w.kernel",),
                 "t_params": _LEAVES + ("params.pano_encoder.img_proj.kernel",)}
LEAF_RTOL = 1e-4
# a leaf whose JAX gradient is below this share of its partition's largest
# is zero in exact arithmetic (the softmax's shift invariance: attention key
# biases, the sprel and global-score biases) and only rounding remains
ZERO_SHARE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def golden_config(module, spec=GOLDEN, **train):
    """``spec`` as a MagicConfig of ``module`` (either package)."""
    model = module.ModelConfig(**spec["model"])
    return module.MagicConfig(
        model=model,
        teacher_model=dataclasses.replace(model, **spec["teacher_model"]),
        env=module.EnvConfig(**spec["env"]),
        train=module.TrainConfig(**{**spec["train"], **train}),
        distill=module.DistillConfig(**spec["distill"]))


def golden_items(world, spec=GOLDEN, make=make_synthetic_instructions):
    return make(world, rng=np.random.default_rng(spec["seed"]),
                **spec["items"])


def jax_golden_run():
    """A fresh JAX trainer on the golden spec and its ``compute_grads``."""
    world = jax_world(**GOLDEN["world"])
    tr = jax_trainer.Trainer(golden_config(jcfg), world)
    loss, (grads, t_grads) = tr.compute_grads(
        golden_items(world), jax.random.PRNGKey(GOLDEN["seed"]))
    return tr, float(loss), {"params": flatten_params(grads),
                             "t_params": flatten_params(t_grads)}


def golden_spec() -> dict:
    """The fixture's spec: the seed, the world's and the items' arguments,
    and the whole configuration (``config.config_to_dict``, which the port's
    ``config_from_dict`` reads back)."""
    return {"seed": GOLDEN["seed"], "world": GOLDEN["world"],
            "items": GOLDEN["items"],
            "config": jcfg.config_to_dict(golden_config(jcfg))}


def golden_arrays(tr, loss, grads) -> dict:
    """What the fixture holds: the spec, the three parameter trees, the
    objective, each partition's gradient norm and ``GOLDEN_LEAVES``."""
    out = {"spec": np.asarray(json.dumps(golden_spec())),
           "loss": np.float32(loss)}
    for part, tree in (("params", tr.params), ("t_params", tr.t_params),
                       ("critic_params", tr.critic_params)):
        for k, v in flatten_params(tree).items():
            out[f"{part}/{k}"] = np.asarray(v, np.float32)
    for part, g in grads.items():
        out[f"grad_norm/{part}"] = np.float32(np.sqrt(sum(
            float(np.sum(np.square(np.asarray(v, np.float64))))
            for v in g.values())))
        for k in GOLDEN_LEAVES[part]:
            out[f"grad/{part}/{k}"] = np.asarray(g[k], np.float32)
    return out


def trees(arrays, part):
    prefix = f"{part}/"
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_run():
    tr, loss, grads = jax_golden_run()
    return {"trainer": tr, "loss": loss, "grads": grads,
            "arrays": golden_arrays(tr, loss, grads)}


@pytest.fixture(scope="module")
def port_world():
    return make_synthetic_world(**GOLDEN["world"])


def port_trainer_like(jax_run, port_world, **train):
    """A port Trainer on the golden spec with the JAX trainer's weights."""
    tr = port_trainer.Trainer(golden_config(tcfg, **train), port_world,
                              device="cpu")
    a = jax_run["arrays"]
    load_trainer_params(tr, trees(a, "params"), trees(a, "t_params"),
                        trees(a, "critic_params"))
    return tr


def items_for(world):
    return golden_items(world, make=port_instructions)


def _check_grads(got, want, what):
    for part in want:
        top = max(float(np.max(np.abs(np.asarray(v))))
                  for v in want[part].values())
        assert sorted(got[part]) == sorted(want[part]), part
        for k, v in want[part].items():
            v = np.asarray(v)
            g = got[part][k].numpy()
            scale = float(np.max(np.abs(v)))
            if scale < ZERO_SHARE * top:
                assert np.max(np.abs(g)) < 10 * ZERO_SHARE * top, \
                    f"{what} {part} {k}: zero in JAX, not here"
            else:
                np.testing.assert_allclose(
                    g, v, rtol=0, atol=LEAF_RTOL * scale,
                    err_msg=f"{what} {part} {k}")


def test_golden_fixture_is_a_fresh_jax_run(jax_run):
    """tests/fixtures/golden_train_7.npz holds the spec, weights and
    gradients that chip_smoke.py's phase 9 holds the card to."""
    fixture = dict(np.load(FIXTURE))
    fresh = jax_run["arrays"]
    assert sorted(fixture) == sorted(fresh)
    spec = json.loads(str(fixture["spec"]))
    assert spec == json.loads(json.dumps(golden_spec()))
    assert tcfg.config_from_dict(spec["config"]) == golden_config(tcfg)
    for k, v in fresh.items():
        if k == "spec":
            continue
        if k.startswith(("params/", "t_params/", "critic_params/")):
            np.testing.assert_array_equal(fixture[k], v, err_msg=k)
        else:   # computed values: XLA's CPU code may round otherwise
            np.testing.assert_allclose(fixture[k], v, rtol=1e-6,
                                       atol=1e-6 * np.max(np.abs(v)),
                                       err_msg=k)


def test_compute_grads_matches_jax(jax_run, port_world):
    tr = port_trainer_like(jax_run, port_world)
    loss, grads = tr.compute_grads(items_for(port_world),
                                   seed=GOLDEN["seed"])
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-5)
    _check_grads(grads, jax_run["grads"], "compute_grads")
    for part in grads:
        norm = np.sqrt(sum(float((g.double() ** 2).sum())
                           for g in grads[part].values()))
        np.testing.assert_allclose(
            norm, float(jax_run["arrays"][f"grad_norm/{part}"]), rtol=1e-5)


@pytest.mark.parametrize("optim", ["sgd", "adamw", "adam"])
def test_one_train_step_matches_optax(jax_run, port_world, optim):
    """One ``train_step`` against optax's chain (clip_by_global_norm, then
    the optimizer) applied to JAX's gradients of the same step: the
    student at ``lr``, the teacher at ``t_lr``.  sgd: every parameter to
    1e-6.  adamw (weight decay 0.01) and adam: the first update is about
    lr * sign(g), so an element whose gradient is rounding noise moves by up
    to lr either way; elements whose gradient exceeds 1e-4 of the leaf's
    largest to 1e-6, the rest, and the leaves whose gradient is zero in
    exact arithmetic (``ZERO_SHARE``), to 2 * lr."""
    lr = 1e-3 if optim == "sgd" else 4e-5
    train = {"optim": optim, "lr": lr, "weight_decay": 0.01}
    tr = port_trainer_like(jax_run, port_world, **train)
    metrics = tr.train_step(items_for(port_world))
    jt = jax_run["trainer"]
    cfg = golden_config(jcfg, **train)
    want, noise = {}, {}
    for part, params, opt in (
            ("params", jt.params, jax_trainer.make_optimizer(cfg)),
            ("t_params", jt.t_params,
             jax_trainer.make_optimizer(cfg, lr=cfg.distill.t_lr))):
        grads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [jax_run["grads"][part][k] for k in flatten_params(params)])
        step = jax.jit(lambda g, p: optax.apply_updates(
            p, opt.update(g, opt.init(p), p)[0]))
        want[part] = flatten_params(step(grads, params))
        g_all = {k: np.abs(np.asarray(g))
                 for k, g in jax_run["grads"][part].items()}
        top = max(float(g.max()) for g in g_all.values())
        noise[part] = {k: (g <= 1e-4 * g.max()) | (g.max() < ZERO_SHARE * top)
                       for k, g in g_all.items()}
    from vln_magic_tpu_torch.utils.weights import _flax_names

    for part, model, step_lr in (("params", tr.model, lr),
                                 ("t_params", tr.teacher_model,
                                  cfg.distill.t_lr)):
        for k, (p, transpose) in _flax_names(model).items():
            got = p.detach().numpy()
            got = got.T if transpose else got
            w = np.asarray(want[part][k])
            if optim == "sgd":
                np.testing.assert_allclose(got, w, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                tol = np.where(noise[part][k], 2 * step_lr, 1e-6)
                assert np.all(np.abs(got - w) <= tol), (part, k)
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert sorted(metrics) == ["dagger/gmap_overflow", "dagger/kdl_loss",
                               "dagger/ml_loss", "dagger/t_loss",
                               "grad_norm", "il/gmap_overflow",
                               "il/kdl_loss", "il/ml_loss", "il/t_loss",
                               "loss"]
    want_norm = float(jax_run["arrays"]["grad_norm/params"])
    np.testing.assert_allclose(metrics["grad_norm"], want_norm, rtol=1e-5)


SCHEDULES = {
    "constant": {},
    "cosine_warm": {"use_lr_sch": True, "lr_sch": "cosine",
                    "warmup_iters": 10, "iters": 100},
    "cosine": {"use_lr_sch": True, "lr_sch": "cosine", "iters": 100},
    "linear_warm": {"use_lr_sch": True, "lr_sch": "linear",
                    "warmup_iters": 10, "iters": 100},
    "polynomial": {"use_lr_sch": True, "lr_sch": "polynomial",
                   "iters": 100},
    "noam": {"use_lr_sch": True, "lr_sch": "noam", "warmup_iters": 10},
    "warmup_linear": {"use_lr_sch": True, "lr_sch": "warmup_linear",
                      "warmup_iters": 10, "iters": 100},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_optax(name):
    kw = dict(SCHEDULES[name], lr=1e-4)
    want = jax_trainer.make_lr_schedule(
        jcfg.MagicConfig(train=jcfg.TrainConfig(**kw)))
    got = port_trainer.make_lr_schedule(
        tcfg.MagicConfig(train=tcfg.TrainConfig(**kw)))
    warm, total = kw.get("warmup_iters", 0), kw.get("iters", 100_000)
    for step in sorted({0, 1, warm, total, total + 5}):
        np.testing.assert_allclose(got(step), float(want(np.int32(step))),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} step {step}")


def test_remat_gradients_equal_the_plain_ones(jax_run, port_world):
    items = items_for(port_world)
    plain = port_trainer_like(jax_run, port_world).compute_grads(items, 1)
    remat = port_trainer_like(jax_run, port_world,
                              remat=True).compute_grads(items, 1)
    torch.testing.assert_close(remat[0], plain[0])
    for part in plain[1]:
        for k, g in plain[1][part].items():
            torch.testing.assert_close(remat[1][part][k], g, rtol=1e-5,
                                       atol=1e-7, msg=k)


def test_bf16_step_keeps_f32_masters(jax_run, port_world):
    """bf16 compute under autocast: finite metrics, f32 parameters that
    moved, the imitation branch's metric names."""
    tr = port_trainer_like(jax_run, port_world, compute_dtype="bfloat16",
                           train_alg="imitation")
    before = tr.model.cls_fuse.weight.detach().clone()
    m = tr.train_step(items_for(port_world))
    assert sorted(m) == ["grad_norm", "il/gmap_overflow", "il/kdl_loss",
                         "il/ml_loss", "il/t_loss", "loss"]
    assert all(np.isfinite(v) for v in m.values()) and m["grad_norm"] > 0
    assert tr.model.cls_fuse.weight.dtype == torch.float32
    assert not torch.equal(before, tr.model.cls_fuse.weight)


def test_fit_runs_and_the_teacher_freezes_without_icod(jax_run, port_world):
    spec = json.loads(json.dumps(GOLDEN))
    spec["distill"]["train_teacher"] = False
    tr = port_trainer.Trainer(golden_config(tcfg, spec), port_world,
                              device="cpu")
    t_before = [p.detach().clone() for p in tr.teacher_model.parameters()]
    s_before = tr.model.cls_fuse.weight.detach().clone()
    hist = tr.fit(items_for(port_world), 2)
    assert len(hist) == 2 and all(np.isfinite(m["loss"]) for m in hist)
    assert "il/t_loss" not in hist[0] and tr.iteration == 2
    for a, b in zip(t_before, tr.teacher_model.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(s_before, tr.model.cls_fuse.weight)


def test_fit_history_entries_carry_aug(jax_run, port_world):
    """As JAX's ``fit``, each history entry says whether its batch was an
    aug batch: with ``aug_times`` 1 they alternate, a train batch first."""
    tr = port_trainer_like(jax_run, port_world)
    hist = tr.fit(items_for(port_world), 2, aug_items=items_for(port_world))
    assert [m["aug"] for m in hist] == [0.0, 1.0]


def test_load_trainer_params_carries_all_three_trees(jax_run, port_world):
    """Every name of a JAX trainer's three trees has its parameter (the
    load raises on a missing or unmatched one), scalars and the critic
    included; a tree left out raises."""
    a = jax_run["arrays"]
    tr = port_trainer_like(jax_run, port_world)
    for part, model in (("params", tr.model), ("t_params", tr.teacher_model),
                        ("critic_params", tr.critic)):
        assert len(trees(a, part)) == len(list(model.parameters())), part
    np.testing.assert_array_equal(
        tr.teacher_model.kdl_local_weight.detach().numpy(),
        a["t_params/params.kdl_local_weight"])
    np.testing.assert_array_equal(tr.critic.Dense_1.weight.detach().numpy(),
                                  a["critic_params/params.Dense_1.kernel"].T)
    missing = trees(a, "critic_params")
    missing.pop(sorted(missing)[0])
    with pytest.raises(KeyError, match="missing"):
        load_trainer_params(tr, trees(a, "params"), trees(a, "t_params"),
                            missing)
    with pytest.raises(ValueError, match="critic_params"):
        load_trainer_params(tr, trees(a, "params"), trees(a, "t_params"))


def test_unported_trainer_entry_points_raise(jax_run, port_world):
    tr = port_trainer_like(jax_run, port_world)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.use_mesh(None)


def test_default_device_needs_a_gpu(port_world):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_trainer.Trainer(golden_config(tcfg), port_world)


if __name__ == "__main__":
    tr, loss, grads = jax_golden_run()
    np.savez_compressed(FIXTURE, **golden_arrays(tr, loss, grads))
    print(f"wrote {FIXTURE}")
