"""The port's pretraining (vln_magic_tpu_torch.pretrain) held against
vln_magic_tpu's on the same weights and batches: the data builder, the
masking, the task loader and the item sampler bit for bit; every task's
student and teacher forward, its loss, KD penalty, metrics and gradients;
one sgd and one adamw step per task; ``accum_steps=2`` against
``optax.MultiSteps``; and the golden fixture that ``chip_smoke.py`` phase 12
holds the card to.

One JAX ``PretrainTrainer`` serves the file (module fixture), with one
jitted objective per task (JAX's own ``_task_loss`` and ``_kd_penalty``
under ``jax.value_and_grad``); no JAX ``fit`` and no eager ``validate``.
Dropout is 0 on both sides, so a training-mode step is deterministic.

Regenerate the fixture with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_pretrain.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.data import HashObjectStore
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import (
    make_synthetic_instructions as jax_instructions,
    make_synthetic_reverie_items)
from vln_magic_tpu.pretrain import loader as jax_loader
from vln_magic_tpu.pretrain import tasks as jax_tasks
from vln_magic_tpu.pretrain.trainer import PretrainTrainer as JaxPretrainer
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.pretrain import loader, tasks
from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer
from vln_magic_tpu_torch.utils.weights import (export_flax_params,
                                               flax_named_grads,
                                               load_flax_params)

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
TASKS = ("mlm", "mrc", "sap", "cfp", "og")
# the golden pretraining step: configuration, world, items and builder, as
# JSON so that chip_smoke.py can rebuild it with no JAX.  Both models take
# the packed kernel where deterministic (on the card: the teacher in every
# step); JAX on the CPU runs its einsum path.
SPEC = {
    "seed": 11,
    "world": {"num_scans": 1, "nodes_per_scan": 14, "feat_dim": 16,
              "seed": 21},
    "items": {"num_items": 12, "vocab_size": 300, "min_path": 2,
              "max_path": 4},
    "image_prob_size": 50,
    "builder": {"max_steps": 6, "max_gmap": 16},
    "tasks": list(TASKS),
    "model": {"vocab_size": 300, "hidden_size": 32, "num_attention_heads": 2,
              "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
              "mlp_ratio": 2, "image_feat_size": 16,
              "max_position_embeddings": 80, "kd_heads": True,
              "kd_target_size": 48, "hidden_dropout": 0.0,
              "attention_dropout": 0.0, "use_pallas_attention": True},
    # 3 heads of 16: the packed kernel's head dims are 16, 32, 64 and 128
    "teacher_model": {"hidden_size": 48, "num_attention_heads": 3,
                      "kd_heads": False},
    "env": {"max_instr_len": 32},
    # sgd at lr 10: each kept leaf's update lies far above its f32 rounding
    "train": {"batch_size": 4, "optim": "sgd", "lr": 10.0, "seed": 11},
    "distill": {"train_kdl": True, "alpha": 0.5, "temperature": 2.0},
}
FIXTURE = os.path.join(HERE, "fixtures", f"golden_pretrain_{SPEC['seed']}.npz")
_LANG = "params.bert.lang_encoder.layer_0.attention.query.kernel"
# leaves whose post-step values the fixture keeps, per task (each on that
# task's path)
GOLDEN_LEAVES = {
    "mlm": (_LANG, "params.mlm_head.transform.kernel", "params.mlm_head.bias"),
    # mrc reads the panorama alone: no gradient reaches the language layers
    "mrc": ("params.bert.pano_encoder.layer_0.attention.query.kernel",
            "params.mrc_head.kernel",
            "params.bert.pano_encoder.img_proj.kernel"),
    "sap": (_LANG, "params.bert.global_sap_head.dense.kernel",
            "params.bert.global_encoder.layer_0.ffn.output.bias"),
    "cfp": (_LANG, "params.cfp_fused_pool.kernel",
            "params.bert.txt_emb_w.kernel"),
    "og": (_LANG, "params.og_obj_proj.kernel", "params.og_state_proj.bias"),
}
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
# a leaf whose JAX gradient is below this share of the largest is zero in
# exact arithmetic (softmax shift invariance: attention key biases) and
# only rounding remains
ZERO_SHARE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spec_config(module, spec=SPEC, **train):
    """``spec`` as a MagicConfig of ``module`` (either package)."""
    model = module.ModelConfig(**spec["model"])
    return module.MagicConfig(
        model=model,
        teacher_model=module.ModelConfig(**{**spec["model"],
                                            **spec["teacher_model"]}),
        env=module.EnvConfig(**spec["env"]),
        train=module.TrainConfig(**{**spec["train"], **train}),
        distill=module.DistillConfig(**spec["distill"]))


def golden_spec() -> dict:
    """The fixture's spec: the seed, the world's, items' and builder's
    arguments, the tasks and the whole configuration
    (``config.config_to_dict``)."""
    return {k: SPEC[k] for k in ("seed", "world", "items", "image_prob_size",
                                 "builder", "tasks")} | {
        "config": jcfg.config_to_dict(spec_config(jcfg))}


def jax_trainer_run():
    """A fresh JAX trainer on the spec, its items and one batch a task (in
    TASKS order, from the builder as the trainer left it)."""
    world = jax_world(**SPEC["world"])
    jt = JaxPretrainer(spec_config(jcfg), world,
                       image_prob_size=SPEC["image_prob_size"],
                       builder_kwargs=SPEC["builder"])
    items = jax_instructions(world, rng=np.random.default_rng(SPEC["seed"]),
                             **SPEC["items"])
    batches = {t: jt._fill(t, getattr(jt.builder, f"{t}_batch")(items[:4]))
               for t in TASKS}
    return {"trainer": jt, "items": items, "batches": batches,
            "objective": {}, "result": {}}


@pytest.fixture(scope="module")
def jax_run():
    return jax_trainer_run()


@pytest.fixture(scope="module")
def port_world():
    return make_synthetic_world(**SPEC["world"])


def jax_result(run, task, batch=None):
    """JAX's step objective on ``batch`` (default: the task's batch) at the
    trainer's weights: its loss, metrics, task loss, student and teacher
    outputs and the gradients (flat), from one jitted
    ``value_and_grad`` per task (kept in ``run["objective"]``)."""
    jt = run["trainer"]
    if task not in run["objective"]:
        alpha = jt.cfg.distill.alpha

        def objective(params, t_params, batch, rng):
            loss, s_out, metrics = jt._task_loss(task, params, batch,
                                                 {"dropout": rng})
            _, t_out, _ = jt._task_loss(task, t_params, batch, None,
                                        model=jt.teacher)
            kd = jt._kd_penalty(task, s_out, t_out, params)
            metrics["kd"] = kd
            metrics["loss"] = (1 - alpha) * loss + alpha * kd
            return metrics["loss"], (metrics, loss, s_out, t_out)

        run["objective"][task] = jax.jit(
            jax.value_and_grad(objective, has_aux=True))
    key = (task, batch is None)
    if batch is None and key in run["result"]:
        return run["result"][key]
    b = run["batches"][task] if batch is None else batch
    (_, (metrics, task_loss, s_out, t_out)), grads = run["objective"][task](
        jt.params, jt.t_params, {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(SPEC["seed"]))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "task_loss": float(task_loss),
           "s_out": jax.tree_util.tree_map(np.asarray, s_out),
           "t_out": jax.tree_util.tree_map(np.asarray, t_out),
           "grads": flatten_params(grads), "grad_tree": grads}
    if batch is None:
        run["result"][key] = out
    return out


def jax_step(run, grads_list, **train):
    """JAX's optimizer (``make_optimizer``, wrapped in ``MultiSteps`` when
    ``accum_steps`` > 1, as JAX's PretrainTrainer does) applied to each
    gradient tree of ``grads_list`` in turn from the trainer's weights;
    returns the flat parameters after each."""
    key = ("steps", len(grads_list), tuple(sorted(train.items())))
    if key not in run["objective"]:
        cfg = spec_config(jcfg, **train)
        opt = jax_trainer.make_optimizer(cfg)
        if cfg.train.accum_steps > 1:
            opt = optax.MultiSteps(opt,
                                   every_k_schedule=cfg.train.accum_steps)

        def steps(params, grads_list):
            state = opt.init(params)
            out = []
            for grads in grads_list:
                updates, state = opt.update(grads, state, params)
                params = optax.apply_updates(params, updates)
                out.append(params)
            return out

        run["objective"][key] = jax.jit(steps)
    return [flatten_params(p) for p in run["objective"][key](
        run["trainer"].params, list(grads_list))]


def port_trainer(run, world, **train):
    """A port trainer on the spec with the JAX trainer's weights."""
    tr = PretrainTrainer(spec_config(tcfg, **train), world,
                         image_prob_size=SPEC["image_prob_size"],
                         builder_kwargs=SPEC["builder"], device="cpu")
    jt = run["trainer"]
    load_flax_params(tr.model, flatten_params(jt.params))
    load_flax_params(tr.teacher, flatten_params(jt.t_params))
    return tr


def port_objective(tr, task, batch):
    """The port's objective on ``batch``: (loss tensor, metrics as floats,
    gradients by flax name)."""
    tr.opt.zero_grad()
    loss, metrics = tr._objective(task, tr._on_device(batch),
                                  torch.Generator().manual_seed(0))
    loss.backward()
    grads = flax_named_grads(tr.model)
    tr.opt.zero_grad()
    return loss, {k: v.item() for k, v in metrics.items()}, grads


def assert_close(got, want, what):
    """Within ``RTOL`` of each element, or ``ATOL`` per unit of the
    tensor's largest magnitude (at least 1): a logit near zero is a sum of
    terms of the tensor's scale, rounded in another order here."""
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def check_grads(got, want, what):
    """Each leaf to ``GRAD_RTOL`` of its largest JAX magnitude (as the
    trainer's tests hold them); a leaf that
    is zero in exact arithmetic (``ZERO_SHARE``) stays near zero."""
    assert sorted(got) == sorted(want)
    top = max(float(np.max(np.abs(v))) for v in want.values())
    for k, w in want.items():
        g = got[k].numpy()
        scale = float(np.max(np.abs(w)))
        if scale < ZERO_SHARE * top:
            assert np.max(np.abs(g)) < 10 * ZERO_SHARE * top, \
                f"{what} {k}: zero in JAX, not here"
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                       err_msg=f"{what} {k}")


# ----- data: bit for bit -----

def test_mlm_mask_matches_jax():
    toks = np.random.default_rng(0).integers(0, 300, (6, 20))
    toks[:, 0], toks[:, -1] = 0, 2
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_tasks.mlm_mask(toks, r1, mask_token=3, vocab_size=300)
        got = tasks.mlm_mask(toks, r2, mask_token=3, vocab_size=300)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert r1.bit_generator.state == r2.bit_generator.state


def assert_batches_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("task", TASKS)
def test_task_batches_match_jax(jax_run, port_world, task):
    """A fresh port trainer's builder, fed the JAX trainer's items in the
    same order, gives JAX's batch of every task bit for bit (the port's
    init leaves its generator where JAX's init left JAX's)."""
    tr = port_trainer(jax_run, port_world)
    got = {t: tr._fill(t, getattr(tr.builder, f"{t}_batch")(
        jax_run["items"][:4])) for t in TASKS}
    assert_batches_equal(got[task], jax_run["batches"][task], task)


def _reverie(world, store):
    return make_synthetic_reverie_items(world, 8, np.random.default_rng(8),
                                        store, vocab_size=300, min_path=2,
                                        max_path=4)


BUILDER_CASES = {
    # R2R endpoint draws at fixed end steps and types, explicit
    "end_steps": lambda b, items, store: b.collate(
        items[:4], end_steps=[0, 1, 5, 2],
        end_vp_types=["pos", "neg_in_gt_path", "neg_others", "pos"]),
    "aug_features": lambda b, items, store: b.sap_batch(items[:4]),
    "reverie_sap": lambda b, items, store: b.sap_batch(items[:6]),
    "reverie_og": lambda b, items, store: b.og_batch(items[:6]),
    "soon_og": lambda b, items, store: b.soon_mode().og_batch(items[:6]),
}


@pytest.mark.parametrize("case", sorted(BUILDER_CASES))
def test_builder_options_match_jax(port_world, case):
    """Endpoint types, the EnvEdit coin flip, REVERIE endpoints and
    objects, and SOON mode give JAX's batches bit for bit."""
    jw = jax_world(**SPEC["world"])
    store = HashObjectStore(obj_feat_size=16, max_objects=6, seed=5)
    reverie = case.startswith(("reverie", "soon"))
    items = (_reverie(jw, store) if reverie else
             jax_instructions(jw, rng=np.random.default_rng(4),
                              **SPEC["items"]))
    if case == "soon_og":
        for j, it in enumerate(items):
            it["obj_pseudo_label"] = {"idx": j}
    kw = dict(max_steps=6, max_gmap=24, max_txt=32, vocab_size=300, seed=2)
    if case == "aug_features":
        kw["aug_features"] = np.asarray(jw.tables.features) + 100.0
    if reverie:
        kw["obj_db"] = store
    want = BUILDER_CASES[case](jax_tasks.PathDataBuilder(jw, **kw), items,
                               store)
    got = BUILDER_CASES[case](tasks.PathDataBuilder(port_world, **kw), items,
                              store)
    assert_batches_equal(got, want, case)


@pytest.mark.parametrize("accum", [1, 2])
def test_meta_loader_and_item_sampler_match_jax(accum):
    """The task sequence (held for ``accum`` batches) and the item order
    are JAX's."""
    draws = []
    make = lambda name: (lambda: draws.append(name) or name)
    ratios = {"mlm": 1, "sap": 2, "cfp": 1}
    want = jax_loader.MetaLoader({n: make(n) for n in ratios}, ratios, 5,
                                 accum)
    got = loader.MetaLoader({n: make(n) for n in ratios}, ratios, 5, accum)
    seq = lambda ml: [next(ml)[0] for _ in range(24)]
    w = seq(want)
    assert seq(got) == w and len(set(w[::accum])) > 1
    if accum == 2:
        assert all(a == b for a, b in zip(w[::2], w[1::2]))
    assert got.sample_sequence(10) == want.sample_sequence(10)
    items = list(range(10))
    js, ps = (jax_loader.ItemSampler(items, 4, 3),
              loader.ItemSampler(items, 4, 3))
    for _ in range(7):
        assert ps.next_batch() == js.next_batch()


def test_prefetch_loader_yields_the_batches_as_tensors():
    batches = [("mlm", {"x": np.arange(6, dtype=np.int32).reshape(2, 3)}),
               ("sap", {"x": np.ones((2, 3), bool)})]
    got = list(loader.PrefetchLoader(iter(batches), "cpu", depth=2))
    assert [t for t, _ in got] == ["mlm", "sap"]
    for (_, want), (_, b) in zip(batches, got):
        assert isinstance(b["x"], torch.Tensor)
        np.testing.assert_array_equal(b["x"].numpy(), want["x"])


# ----- forwards, losses, KD and gradients -----

@pytest.mark.parametrize("task", TASKS)
def test_task_forwards_match_jax(jax_run, port_world, task):
    """The student's and the teacher's head outputs (deterministic; the
    port's packed calls take the plain version here)."""
    want = jax_result(jax_run, task)
    tr = port_trainer(jax_run, port_world)
    batch = tr._on_device(jax_run["batches"][task])
    with torch.no_grad():
        for who, model in (("s_out", tr.model), ("t_out", tr.teacher)):
            out = getattr(model, task)(batch)
            ref = want[who]
            if task == "sap":   # JAX's step keeps the fused logits
                out = out["fused_logits"]
            if isinstance(ref, dict):
                assert sorted(out) == sorted(ref)
                for k in ref:
                    assert_close(out[k], ref[k], f"{task} {who} {k}")
            else:
                assert_close(out, ref, f"{task} {who}")


@pytest.mark.parametrize("task", TASKS)
def test_losses_kd_and_gradients_match_jax(jax_run, port_world, task):
    """The task loss, the KD penalty, the objective, every accuracy, and
    every gradient leaf (to 1e-5 of the leaf's largest) with their global
    norm."""
    want = jax_result(jax_run, task)
    tr = port_trainer(jax_run, port_world)
    batch = tr._on_device(jax_run["batches"][task])
    with torch.no_grad():
        task_loss, _, _ = tr._task_loss(task, batch)
    assert_close(task_loss.item(), want["task_loss"], f"{task} task loss")
    loss, metrics, grads = port_objective(tr, task, jax_run["batches"][task])
    assert sorted(metrics) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        assert_close(metrics[k], v, f"{task} {k}")
    assert want["metrics"]["kd"] > 0
    check_grads(grads, want["grads"], task)
    norm = lambda g: np.sqrt(sum(float(np.sum(np.square(np.asarray(
        x, np.float64)))) for x in g.values()))
    np.testing.assert_allclose(norm(grads), norm(want["grads"]), rtol=1e-5)


# ----- optimizer steps -----

def _noise(grads, g_max_share=1e-4):
    """Per leaf, the elements whose JAX gradient is rounding noise: at most
    ``g_max_share`` of the leaf's largest, or the whole leaf when it is
    zero in exact arithmetic (``ZERO_SHARE``)."""
    top = max(float(np.max(np.abs(g))) for g in grads.values())
    return {k: (np.abs(g) <= g_max_share * np.max(np.abs(g)))
            | (np.max(np.abs(g)) < ZERO_SHARE * top)
            for k, g in grads.items()}


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
@pytest.mark.parametrize("task", TASKS)
def test_train_step_matches_jax(jax_run, port_world, task, optim):
    """One ``train_step`` with KD against JAX's optimizer chain
    (clip_by_global_norm, then sgd or adamw with weight decay 0.01) on
    JAX's gradients of the same step.  The metrics to 1e-5; sgd: every
    parameter to 1e-6.  adamw's first update is about lr * sign(g), so an
    element whose gradient is rounding noise may move by up to lr either
    way: those elements within 2 * lr, every other within 1e-6."""
    lr = 0.1 if optim == "sgd" else 1e-4
    train = {"optim": optim, "lr": lr, "weight_decay": 0.01}
    want = jax_result(jax_run, task)
    after = jax_step(jax_run, [want["grad_tree"]], **train)[0]
    tr = port_trainer(jax_run, port_world, **train)
    metrics = tr.train_step(task, jax_run["batches"][task])
    for k, v in want["metrics"].items():
        assert_close(metrics[k], v, f"{task} {k}")
    noise = _noise(want["grads"])
    got = export_flax_params(tr.model)
    assert sorted(got) == sorted(after)
    for k, w in after.items():
        tol = 1e-6 if optim == "sgd" else np.where(noise[k], 2 * lr, 1e-6)
        assert np.all(np.abs(got[k] - np.asarray(w)) <= tol), (task, k)
    assert tr.iteration == 1 and tr.opt.count == 1


def test_accum_steps_match_optax_multisteps(jax_run, port_world):
    """``accum_steps=2``: the first step changes nothing; the second
    applies the clipped mean of both gradients, as ``optax.MultiSteps``;
    the count (and so the schedule) advances once."""
    train = {"optim": "adamw", "lr": 1e-4, "weight_decay": 0.01,
             "accum_steps": 2}
    jt = jax_run["trainer"]
    second = jt._fill("sap", jax_tasks.PathDataBuilder(
        jt.world, max_txt=SPEC["env"]["max_instr_len"],
        image_prob_size=SPEC["image_prob_size"], vocab_size=300, seed=9,
        **SPEC["builder"]).sap_batch(jax_run["items"][4:8]))
    g1 = jax_result(jax_run, "sap")
    g2 = jax_result(jax_run, "sap", second)
    want = jax_step(jax_run, [g1["grad_tree"], g2["grad_tree"]], **train)
    tr = port_trainer(jax_run, port_world, **train)
    before = export_flax_params(tr.model)
    tr.train_step("sap", jax_run["batches"]["sap"])
    for k, v in export_flax_params(tr.model).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
        np.testing.assert_array_equal(v, want[0][k], err_msg=k)
    assert tr.opt.count == 0 and tr.opt.mini_step == 1
    tr.train_step("sap", second)
    assert tr.opt.count == 1 and tr.opt.mini_step == 0
    mean = {k: (g1["grads"][k] + g2["grads"][k]) / 2 for k in g1["grads"]}
    noise = _noise(mean)
    for k, v in export_flax_params(tr.model).items():
        tol = np.where(noise[k], 2 * train["lr"], 1e-6)
        assert np.all(np.abs(v - np.asarray(want[1][k])) <= tol), k


# ----- the golden fixture -----

def golden_arrays(run) -> dict:
    """What the fixture holds: the spec, both parameter trees, one batch a
    task, and per task JAX's metrics (loss, kd, accuracies), the student's
    gradient norm and ``GOLDEN_LEAVES`` after one step of the spec's
    optimizer (sgd)."""
    jt = run["trainer"]
    out = {"spec": np.asarray(json.dumps(golden_spec()))}
    for part, tree in (("params", jt.params), ("t_params", jt.t_params)):
        for k, v in flatten_params(tree).items():
            out[f"{part}/{k}"] = np.asarray(v, np.float32)
    for task in TASKS:
        r = jax_result(run, task)
        for k, v in run["batches"][task].items():
            out[f"batch/{task}/{k}"] = v
        for k, v in r["metrics"].items():
            out[f"metrics/{task}/{k}"] = np.float32(v)
        out[f"grad_norm/{task}"] = np.float32(np.sqrt(sum(
            float(np.sum(np.square(np.asarray(v, np.float64))))
            for v in r["grads"].values())))
        after = jax_step(run, [r["grad_tree"]])[0]
        for k in GOLDEN_LEAVES[task]:
            out[f"after/{task}/{k}"] = np.asarray(after[k], np.float32)
    return out


def test_golden_fixture_is_a_fresh_jax_run(jax_run):
    """tests/fixtures/golden_pretrain_11.npz holds the spec, weights,
    batches and JAX values that chip_smoke.py's phase 12 holds the card
    to."""
    fixture = dict(np.load(FIXTURE))
    fresh = golden_arrays(jax_run)
    assert sorted(fixture) == sorted(fresh)
    spec = json.loads(str(fixture["spec"]))
    assert spec == json.loads(json.dumps(golden_spec()))
    assert tcfg.config_from_dict(spec["config"]) == spec_config(tcfg)
    for k, v in fresh.items():
        if k == "spec":
            continue
        if k.startswith(("params/", "t_params/", "batch/")):
            np.testing.assert_array_equal(fixture[k], v, err_msg=k)
        else:   # computed values: XLA's CPU code may round otherwise
            np.testing.assert_allclose(fixture[k], v, rtol=1e-6,
                                       atol=1e-6 * np.max(np.abs(v)),
                                       err_msg=k)
    assert os.path.getsize(FIXTURE) < 2 * 2 ** 20


@pytest.fixture
def chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_golden_pretrain_step_on_the_cpu(chip_smoke):
    """``chip_smoke.golden_pretrain_step``, which phase 12 runs on the card,
    passes here on the CPU: every metric to 1e-5, the gradient norms and
    the post-step leaves to 1e-4 (it raises past them)."""
    errs = chip_smoke.golden_pretrain_step("cpu")
    assert errs and max(v for k, v in errs.items()
                        if not k.startswith("launches")) <= 1e-4


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **golden_arrays(jax_trainer_run()))
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
