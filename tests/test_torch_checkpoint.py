"""Checkpoints across the packages and in the port's trainer: a
pretraining trunk through the reference ``.pt`` container in both
directions (the navigator then decodes as the other package's does), the
non-strict trunk load, ``Trainer.save``/``load`` with the ``teacher_`` file
and ``drop_kd_heads``, ``save_state``/``load_state`` resuming identically,
``accum_steps=2`` in ``Trainer`` against ``optax.MultiSteps``, and the
port's ``CheckpointManager``.

The JAX side is one ``Navigator`` (module fixture) and JAX's checkpoint
functions; the rest runs the port alone at a tiny size.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import optax

from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.agent.navigator import Navigator as JaxNavigator
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.utils import checkpoint as jax_ckpt
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.trainer import Trainer
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer
from vln_magic_tpu_torch.utils import checkpoint
from vln_magic_tpu_torch.utils.weights import (export_flax_params,
                                               init_params, load_flax_params)

WORLD = {"num_scans": 1, "nodes_per_scan": 14, "feat_dim": 16, "seed": 21}
MODEL = {"vocab_size": 300, "hidden_size": 32, "num_attention_heads": 2,
         "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
         "mlp_ratio": 2, "image_feat_size": 16,
         "max_position_embeddings": 80}
ENV = {"max_action_len": 4, "max_gmap_len": 16, "max_instr_len": 32}
# the distillation trainer of the Trainer tests: ICoD, and argmax DAgger
# with dropout 0 where a step must be deterministic
KD_MODEL = dict(MODEL, kd_heads=True, kd_target_size=64)
KD_TEACHER = dict(MODEL, hidden_size=64, kd_heads=True, kd_target_size=32)
PRETRAIN_BUILDER = {"max_steps": 4, "max_gmap": 16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nav_config(module, **model):
    return module.MagicConfig(model=module.ModelConfig(**{**MODEL, **model}),
                              env=module.EnvConfig(**ENV),
                              train=module.TrainConfig(batch_size=4, lr=1e-3))


def kd_config(module, deterministic=True, **train):
    drop = {"hidden_dropout": 0.0, "attention_dropout": 0.0} \
        if deterministic else {}
    return module.MagicConfig(
        model=module.ModelConfig(**KD_MODEL, **drop),
        teacher_model=module.ModelConfig(**KD_TEACHER, **drop),
        env=module.EnvConfig(**ENV),
        train=module.TrainConfig(**{
            "batch_size": 4, "train_alg": "dagger", "ml_weight": 0.2,
            "dagger_sample": "argmax" if deterministic else "sample",
            "lr": 1e-4, **train}),
        distill=module.DistillConfig(train_kdl=True, train_teacher=True,
                                     t_lr=1e-4))


@pytest.fixture(scope="module")
def port_world():
    return make_synthetic_world(**WORLD)


@pytest.fixture(scope="module")
def items(port_world):
    return make_synthetic_instructions(port_world, 8,
                                       np.random.default_rng(9),
                                       vocab_size=300, min_path=2, max_path=4)


@pytest.fixture(scope="module")
def jax_nav():
    return JaxNavigator(nav_config(jcfg), jax_world(**WORLD),
                        rng=jax.random.PRNGKey(5))


def pretrained(world, items, seed=0):
    """A port pretraining student after one sap step."""
    pt = PretrainTrainer(nav_config(tcfg), world, image_prob_size=20,
                         builder_kwargs=PRETRAIN_BUILDER, device="cpu")
    init_params(pt.model, seed)
    pt.train_step("sap", pt._fill("sap", pt.builder.sap_batch(items[:4])))
    return pt


def decode_jax(nav, path, items):
    loaded, _, missing, unexpected = jax_ckpt.load_torch_checkpoint(
        path, template=nav.params, key_map=jax_ckpt.pretrain_to_nav_key_map)
    assert not missing and not unexpected, (missing, unexpected)
    nav.params = loaded
    (avg, _), preds = nav.evaluate(items, batch_size=4)
    return jax_ckpt.flatten_params(loaded), avg, preds


def decode_port(world, path, items):
    tr = Trainer(nav_config(tcfg), world, device="cpu")
    missing, unexpected = tr.load_pretrained(path)
    assert missing == [] and unexpected == []
    flat = export_flax_params(tr.model)
    nav = Navigator(nav_config(tcfg), world, params=flat, device="cpu")
    (avg, _), preds = nav.evaluate(items, batch_size=4)
    return flat, avg, preds


def assert_same_decode(got, want):
    (g_flat, g_avg, g_preds), (w_flat, w_avg, w_preds) = got, want
    assert sorted(g_flat) == sorted(w_flat)
    for k, v in w_flat.items():
        np.testing.assert_array_equal(g_flat[k], np.asarray(v), err_msg=k)
    assert [p["trajectory_idx"] for p in g_preds] == \
        [p["trajectory_idx"] for p in w_preds]
    shared = sorted(set(g_avg) & set(w_avg))
    assert shared
    for k in shared:
        assert g_avg[k] == pytest.approx(w_avg[k], abs=1e-9), k


def test_port_pretrain_trunk_decodes_in_jax_as_in_the_port(
        jax_nav, port_world, items, tmp_path):
    """Port export (``save_reference_checkpoint``) -> JAX
    ``load_torch_checkpoint(key_map=pretrain_to_nav_key_map)``: the whole
    navigator trunk transfers, and JAX's decode equals the port's from the
    same file (``Trainer.load_pretrained``)."""
    pt = pretrained(port_world, items)
    path = str(tmp_path / "model_step_1.pt")
    checkpoint.save_reference_checkpoint(pt.model, path, epoch=1)
    want = decode_jax(jax_nav, path, items[:4])
    got = decode_port(port_world, path, items[:4])
    assert_same_decode(got, want)
    _, epoch, _, _ = jax_ckpt.load_torch_checkpoint(path)
    assert epoch == 1
    np.testing.assert_array_equal(
        got[0]["params.lang_encoder.word_embeddings.embedding"],
        export_flax_params(pt.model)[
            "params.bert.lang_encoder.word_embeddings.embedding"])


def test_jax_pretrain_checkpoint_loads_into_the_port_trainer(
        jax_nav, port_world, items, tmp_path):
    """JAX ``save_torch_checkpoint`` of a pretraining tree ->
    ``Trainer.load_pretrained``: the port's decode equals JAX's from the
    same file."""
    pt = pretrained(port_world, items, seed=3)
    tree, _, _ = jax_ckpt.unflatten_params(export_flax_params(pt.model))
    path = str(tmp_path / "jax_model_step_2.pt")
    jax_ckpt.save_torch_checkpoint(tree, path, epoch=2)
    flat, epoch = checkpoint.load_reference_checkpoint(path)
    assert epoch == 2 and any(k.startswith("params.mlm_head.") for k in flat)
    assert_same_decode(decode_port(port_world, path, items[:4]),
                       decode_jax(jax_nav, path, items[:4]))


def test_load_pretrained_into_the_teacher(port_world, items, tmp_path):
    """A pretraining teacher's trunk (the MAGIC teacher width) loads into
    the fine-tuning teacher: every name it has, its KD heads included."""
    cfg = kd_config(tcfg)
    pt = PretrainTrainer(dataclasses.replace(
        cfg, distill=tcfg.DistillConfig(train_kdl=True)), port_world,
        image_prob_size=20, builder_kwargs=PRETRAIN_BUILDER, device="cpu")
    init_params(pt.teacher, 4)
    path = str(tmp_path / "teacher_step.pt")
    checkpoint.save_reference_checkpoint(pt.teacher, path)
    tr = Trainer(cfg, port_world, device="cpu")
    assert tr.load_pretrained(path, role="teacher") == ([], [])
    want = export_flax_params(pt.teacher)
    for k, v in export_flax_params(tr.teacher_model).items():
        np.testing.assert_array_equal(v, want["params.bert." + k[7:]],
                                      err_msg=k)
    with pytest.raises(ValueError, match="role"):
        tr.load_pretrained(path, role="critic")
    with pytest.raises(ValueError, match="shape"):
        tr.load_pretrained(path, role="student")   # the teacher's width


def test_partial_trunk_load_keeps_init_and_reports(port_world, items,
                                                   tmp_path):
    """Names absent from the file keep their values and come back as
    ``missing``, as JAX's template load leaves them; names the model lacks
    come back as ``unexpected``; a strict load raises on either."""
    pt = pretrained(port_world, items)
    flat = {checkpoint.pretrain_to_nav_key_map(k): v
            for k, v in export_flax_params(pt.model).items()}
    flat.pop(None)
    drop = sorted(k for k in flat if ".pano_encoder." in k)
    for k in drop:
        del flat[k]
    flat["params.no_such_head.kernel"] = np.zeros((2, 2), np.float32)
    tr = Trainer(nav_config(tcfg), port_world, device="cpu")
    before = export_flax_params(tr.model)
    missing, unexpected = load_flax_params(tr.model, flat, strict=False)
    assert missing == drop and unexpected == ["params.no_such_head.kernel"]
    after = export_flax_params(tr.model)
    for k in drop:
        np.testing.assert_array_equal(after[k], before[k])
    np.testing.assert_array_equal(after["params.cls_fuse.kernel"],
                                  flat["params.cls_fuse.kernel"])
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(tr.model, flat)
    flat["params.cls_fuse.kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(tr.model, flat, strict=False)


def test_key_map_and_kd_heads_match_jax(port_world, items):
    pt = PretrainTrainer(dataclasses.replace(kd_config(tcfg), distill=tcfg
                                             .DistillConfig(train_kdl=True)),
                         port_world, image_prob_size=20,
                         builder_kwargs=PRETRAIN_BUILDER, device="cpu")
    names = sorted(export_flax_params(pt.model))
    assert [checkpoint.pretrain_to_nav_key_map(n) for n in names] == \
        [jax_ckpt.pretrain_to_nav_key_map(n) for n in names]
    assert checkpoint.KD_HEAD_NAMES == jax_ckpt.KD_HEAD_NAMES


def test_trainer_save_and_load(port_world, items, tmp_path):
    """``save`` writes the student, ``teacher_<file>`` (ICoD) and the
    optimizer state; JAX reads the student's file; ``load`` restores all
    three into a fresh trainer and takes the epoch as ``iteration``."""
    tr = Trainer(kd_config(tcfg), port_world, device="cpu")
    tr.train_step(items[:4])
    path = str(tmp_path / "best_val_unseen.pt")
    tr.save(path, save_optimizer=True)
    assert (tmp_path / "teacher_best_val_unseen.pt").exists()
    assert (tmp_path / "best_val_unseen.pt.opt" / "opt_state").exists()
    flat, epoch = checkpoint.load_reference_checkpoint(path)
    _, j_epoch, _, _ = jax_ckpt.load_torch_checkpoint(path)
    assert epoch == j_epoch == 1
    want = export_flax_params(tr.model)
    for k, v in jax_ckpt.flatten_params(jax_ckpt.load_torch_checkpoint(
            path)[0]).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    fresh = Trainer(kd_config(tcfg), port_world, device="cpu")
    got = fresh.load(path, resume_optimizer=True,
                     teacher_path=str(tmp_path / "teacher_best_val_unseen.pt"))
    assert got == (1, [], []) and fresh.iteration == 1
    for a, b in ((tr.model, fresh.model),
                 (tr.teacher_model, fresh.teacher_model)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    assert fresh.opt.count == tr.opt.count == 1
    for x, y in zip(tr.opt.mu + tr.opt.nu, fresh.opt.mu + fresh.opt.nu):
        assert torch.equal(x, y)


def test_teacher_load_drops_kd_heads_unless_it_co_trains(port_world,
                                                         tmp_path):
    """A frozen teacher (no ICoD) loads without its KD heads, which keep
    their init values (agent_base.py:326-332); a co-trained one loads
    them."""
    src = Trainer(kd_config(tcfg), port_world, device="cpu")
    init_params(src.teacher_model, 42)
    path = str(tmp_path / "teacher.pt")
    checkpoint.save_reference_checkpoint(src.teacher_model, path)
    student = str(tmp_path / "student.pt")
    checkpoint.save_reference_checkpoint(src.model, student)
    want = export_flax_params(src.teacher_model)
    for icod in (False, True):
        cfg = kd_config(tcfg)
        cfg = dataclasses.replace(cfg, distill=dataclasses.replace(
            cfg.distill, train_teacher=icod))
        tr = Trainer(cfg, port_world, device="cpu")
        init = export_flax_params(tr.teacher_model)
        tr.load(student, teacher_path=path)
        for k, v in export_flax_params(tr.teacher_model).items():
            kd = any(h in k for h in checkpoint.KD_HEAD_NAMES)
            np.testing.assert_array_equal(
                v, init[k] if kd and not icod else want[k], err_msg=k)


def test_save_state_resumes_identically(port_world, items, tmp_path):
    """``save_state`` after a step, then one more step, equals
    ``load_state`` into a fresh trainer and the same step: parameters and
    metrics bit for bit (sampled feedback and dropout on, so the rollout
    seeds' generator is part of the state); the data order restarts from
    ``seed + iteration`` in every resumed trainer."""
    cfg = kd_config(tcfg, deterministic=False)
    a = Trainer(cfg, port_world, device="cpu")
    a.train_step(items[:4])
    a.save_state(str(tmp_path), "state")
    m_a = a.train_step(items[4:])
    b = Trainer(cfg, port_world, device="cpu")
    assert not b.load_state(str(tmp_path), "absent")
    assert b.load_state(str(tmp_path), "state") and b.iteration == 1
    assert b._data_rng.bit_generator.state == \
        np.random.default_rng(cfg.train.seed + 1).bit_generator.state
    assert b.train_step(items[4:]) == m_a
    for model in ("model", "teacher_model", "critic"):
        for (k, v), w in zip(getattr(a, model).state_dict().items(),
                             getattr(b, model).state_dict().values()):
            assert torch.equal(v, w), (model, k)
    c = Trainer(cfg, port_world, device="cpu")
    c.load_state(str(tmp_path), "state")
    b.load_state(str(tmp_path), "state")
    assert b.fit(items, 2) == c.fit(items, 2)
    frozen = dataclasses.replace(cfg, distill=dataclasses.replace(
        cfg.distill, train_teacher=False))
    with pytest.raises(ValueError, match="t_opt_state"):
        Trainer(frozen, port_world, device="cpu").load_state(str(tmp_path),
                                                             "state")


def test_trainer_accum_steps_match_optax_multisteps(port_world, items):
    """``accum_steps=2`` in ``Trainer``: the first step moves nothing; the
    second applies each optimizer (student at ``lr``, ICoD teacher at
    ``t_lr``) to the clipped mean of both steps' gradients, as
    ``optax.MultiSteps`` of JAX's chain does.  The gradients are the port's
    ``compute_grads`` (held to JAX's in tests/test_torch_trainer.py).
    Elements whose gradient is rounding noise within 2 * lr (adamw's first
    update is about lr * sign(g)), every other within 1e-6."""
    train = {"optim": "adamw", "weight_decay": 0.01, "accum_steps": 2}
    ref = Trainer(kd_config(tcfg, **train), port_world, device="cpu")
    grads = [ref.compute_grads(items[:4])[1], ref.compute_grads(items[4:])[1]]
    tr = Trainer(kd_config(tcfg, **train), port_world, device="cpu")
    before = {"params": export_flax_params(tr.model),
              "t_params": export_flax_params(tr.teacher_model)}
    tr.train_step(items[:4])
    assert export_flax_params(tr.model).keys() == before["params"].keys()
    for k, v in export_flax_params(tr.model).items():
        np.testing.assert_array_equal(v, before["params"][k], err_msg=k)
    assert tr.opt.count == 0 and tr.t_opt.count == 0
    tr.train_step(items[4:])
    assert tr.opt.count == 1 and tr.t_opt.count == 1
    cfg = kd_config(jcfg, **train)
    for part, model, lr in (("params", tr.model, cfg.train.lr),
                            ("t_params", tr.teacher_model, cfg.distill.t_lr)):
        opt = optax.MultiSteps(
            jax_trainer.make_optimizer(cfg, lr=None if part == "params"
                                       else lr), every_k_schedule=2)
        # every leaf in one vector: the chain is elementwise but for the
        # global norm, which is the same over the concatenation
        names = sorted(before[part])
        cat = lambda d: np.concatenate([np.ravel(d[k]) for k in names])

        @jax.jit
        def steps(params, grads_list, opt=opt):
            state = opt.init(params)
            for g in grads_list:
                updates, state = opt.update(g, state, params)
                params = optax.apply_updates(params, updates)
            return params

        flat = np.asarray(steps(cat(before[part]), [
            cat({k: v.numpy() for k, v in g[part].items()}) for g in grads]))
        params, i = {}, 0
        for k in names:
            n = before[part][k].size
            params[k] = flat[i : i + n].reshape(before[part][k].shape)
            i += n
        mean = {k: np.abs(grads[0][part][k].numpy()
                          + grads[1][part][k].numpy()) / 2
                for k in params}
        top = max(float(m.max()) for m in mean.values())
        for k, v in export_flax_params(model).items():
            noise = (mean[k] <= 1e-4 * mean[k].max()) | (
                mean[k].max() < 1e-6 * top)
            tol = np.where(noise, 2 * lr, 1e-6)
            assert np.all(np.abs(v - np.asarray(params[k])) <= tol), (part,
                                                                       k)


def test_checkpoint_manager(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpts"))
    assert not mgr.has("latest")
    tree = {"params": {"w": torch.arange(3.0)}, "iteration": 7,
            "seeds": np.random.default_rng(1).bit_generator.state}
    mgr.save_latest(tree)
    mgr.save_best("val_unseen", tree)
    for name in ("latest", "best_val_unseen"):
        got = mgr.restore(name)
        assert torch.equal(got["params"]["w"], tree["params"]["w"])
        assert got["iteration"] == 7 and got["seeds"] == tree["seeds"]
    assert sorted(p.name for p in (tmp_path / "ckpts").iterdir()) == [
        "best_val_unseen", "latest"]
