"""The port's pretraining loop held against vln_magic_tpu's: ``validate``
equal to JAX's (its own ``validate``, with each task's ``_task_loss``
jitted), ``fit``'s task sequence and batches equal to JAX's ``fit``
(persistent sampler and loader, the default task set, explicit ratios,
``og`` with an object store, ``accum_steps`` windows), and a train-mode
step's dropout drawn from the trainer's own generator.

One JAX ``PretrainTrainer`` serves the file; its ``train_step`` is
replaced by a recorder when its ``fit`` runs, so JAX builds and batches
exactly as it does in training without compiling a step.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from vln_magic_tpu import config as jcfg
from vln_magic_tpu.data import HashObjectStore
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import (
    make_synthetic_instructions as jax_instructions,
    make_synthetic_reverie_items)
from vln_magic_tpu.pretrain import tasks as jax_tasks
from vln_magic_tpu.pretrain.trainer import PretrainTrainer as JaxPretrainer
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.pretrain import tasks
from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer
from vln_magic_tpu_torch.utils.weights import (export_flax_params,
                                               load_flax_params)

WORLD = {"num_scans": 1, "nodes_per_scan": 14, "feat_dim": 16, "seed": 21}
MODEL = {"vocab_size": 300, "hidden_size": 32, "num_attention_heads": 2,
         "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
         "mlp_ratio": 2, "image_feat_size": 16,
         "max_position_embeddings": 80, "kd_heads": True,
         "kd_target_size": 48, "use_pallas_attention": True}
TEACHER = {"hidden_size": 48, "num_attention_heads": 3, "kd_heads": False}
BUILDER = {"max_steps": 6, "max_gmap": 16}
PROB = 50


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(module, dropout=0.0, **train):
    drop = {"hidden_dropout": dropout, "attention_dropout": dropout}
    return module.MagicConfig(
        model=module.ModelConfig(**MODEL, **drop),
        teacher_model=module.ModelConfig(**{**MODEL, **TEACHER, **drop}),
        env=module.EnvConfig(max_instr_len=32),
        train=module.TrainConfig(**{"batch_size": 4, "lr": 1e-4, **train}),
        distill=module.DistillConfig(train_kdl=True, alpha=0.5))


@pytest.fixture(scope="module")
def jax_run():
    world = jax_world(**WORLD)
    jt = JaxPretrainer(config(jcfg), world, image_prob_size=PROB,
                       builder_kwargs=BUILDER)
    jitted = {}

    def task_loss(task, params, batch, rngs, model=None):
        """JAX's ``_task_loss`` for validation, jitted per task."""
        assert rngs is None and model is None
        if task not in jitted:
            jitted[task] = jax.jit(lambda p, b, task=task: JaxPretrainer
                                   ._task_loss(jt, task, p, b, None))
        return jitted[task](params, batch)

    jt._task_loss = task_loss
    items = jax_instructions(world, 16, np.random.default_rng(4),
                             vocab_size=300, min_path=2, max_path=4)
    return {"trainer": jt, "items": items,
            "rng_state": copy.deepcopy(jt.builder.rng.bit_generator.state)}


@pytest.fixture(scope="module")
def port_world():
    return make_synthetic_world(**WORLD)


def fresh_jax(run, accum_steps=1, obj_db=None):
    """The module's JAX trainer with its builder generator, sampler and
    loader as its init left them."""
    jt = run["trainer"]
    if obj_db is not None:
        jt.builder = jax_tasks.PathDataBuilder(
            jt.world, max_txt=32, image_prob_size=PROB, vocab_size=300,
            obj_db=obj_db, **BUILDER)
    jt.builder.rng.bit_generator.state = copy.deepcopy(run["rng_state"])
    jt._sampler = jt._loader = None
    jt.accum_steps = accum_steps
    return jt


def port_trainer(run, world, obj_db=None, **kw):
    tr = PretrainTrainer(config(tcfg, **kw), world, image_prob_size=PROB,
                         builder_kwargs=BUILDER, device="cpu")
    if obj_db is not None:
        tr.builder = tasks.PathDataBuilder(
            world, max_txt=32, image_prob_size=PROB, vocab_size=300,
            obj_db=obj_db, **BUILDER)
        tr.builder.rng.bit_generator.state = copy.deepcopy(run["rng_state"])
    jt = run["trainer"]
    load_flax_params(tr.model, flatten_params(jt.params))
    load_flax_params(tr.teacher, flatten_params(jt.t_params))
    return tr


def test_validate_matches_jax(jax_run, port_world):
    """Every task's accuracies, averaged over two batches, as JAX's
    ``validate`` gives them (the port's student on its packed path, the
    plain version here)."""
    want = fresh_jax(jax_run).validate(jax_run["items"], num_batches=2)
    got = port_trainer(jax_run, port_world).validate(jax_run["items"],
                                                     num_batches=2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k


def _record(batches):
    def train_step(task, batch):
        batches.append((task, {k: np.asarray(v) for k, v in batch.items()}))
        return {"loss": 0.0}

    return train_step


FIT_CASES = {
    "default": dict(ratios=None, accum=1, og=False),
    "explicit": dict(ratios={"mlm": 1, "sap": 2, "cfp": 1, "mrc": 1},
                     accum=1, og=False),
    "accum2": dict(ratios={"mlm": 1, "sap": 1, "cfp": 1}, accum=2, og=False),
    "og": dict(ratios=None, accum=1, og=True),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_draws_jax_tasks_and_batches(jax_run, port_world, case):
    """Two ``fit`` calls (the sampler and loader persist across them) run
    JAX's task sequence on JAX's batches, bit for bit; each history entry
    carries its task and finite metrics."""
    c = FIT_CASES[case]
    store = HashObjectStore(obj_feat_size=16, max_objects=6, seed=5) \
        if c["og"] else None
    jt = fresh_jax(jax_run, c["accum"], store)
    items = (make_synthetic_reverie_items(jt.world, 12,
                                          np.random.default_rng(8), store,
                                          vocab_size=300, min_path=2,
                                          max_path=4)
             if c["og"] else jax_run["items"])
    want = []
    jt.train_step = _record(want)
    try:
        for _ in range(2):
            jt.fit(items, 4, task_ratios=c["ratios"])
    finally:
        del jt.train_step
    tr = port_trainer(jax_run, port_world, store, accum_steps=c["accum"])
    got, real = [], tr.train_step
    tr.train_step = lambda task, batch: (
        _record(got)(task, batch), real(task, batch))[1]
    hist = tr.fit(items, 4, task_ratios=c["ratios"]) + tr.fit(
        items, 4, task_ratios=c["ratios"])
    assert [t for t, _ in got] == [t for t, _ in want] \
        == [h["task"] for h in hist]
    for (task, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w), task
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{task} {k}")
    assert all(np.isfinite(h["loss"]) for h in hist)
    if c["og"]:
        assert "og" in {t for t, _ in got}
    if c["accum"] == 2:
        tasks_ = [t for t, _ in got]
        assert tasks_[0::2] == tasks_[1::2]
        assert tr.opt.count == 4


def test_unknown_task_raises(jax_run, port_world):
    tr = port_trainer(jax_run, port_world)
    with pytest.raises(ValueError, match="unknown pretrain tasks"):
        tr.fit(jax_run["items"], 1, task_ratios={"mlm": 1, "itm": 1})


def test_dropout_draws_from_the_trainers_generator(jax_run, port_world):
    """With dropout on, a step draws its masks from the trainer's own
    generator (seeded by ``cfg.train.seed``), not from PyTorch's global
    one: the same seed gives the same step, another seed another."""
    batch = jax_run["trainer"]._fill("sap", tasks.PathDataBuilder(
        port_world, max_txt=32, image_prob_size=PROB, vocab_size=300,
        **BUILDER).sap_batch(jax_run["items"][:4]))
    runs = []
    for seed in (0, 0, 1):
        tr = port_trainer(jax_run, port_world, dropout=0.1, seed=seed)
        global_state = torch.get_rng_state()
        m = tr.train_step("sap", batch)
        assert torch.equal(torch.get_rng_state(), global_state)
        runs.append((m, export_flax_params(tr.model)))
    (m0, p0), (m1, p1), (m2, p2) = runs
    assert m0 == m1 and m0 != m2
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)
    assert not all(np.array_equal(p0[k], p2[k]) for k in p0)


def test_mesh_and_default_device(jax_run, port_world):
    tr = port_trainer(jax_run, port_world)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.use_mesh(None)
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PretrainTrainer(config(tcfg), port_world)
