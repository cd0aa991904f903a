"""The training options of ROADMAP Queue 1 item 2 in the port
(vln_magic_tpu_torch.agent.trainer / rollout), held against
vln_magic_tpu's: the fused DAgger step (``fuse_rollouts``) with
``fusion='local'``, an aug batch from a trainer built with
``aug_features`` and the ``grad`` ability weights, through one JAX
``compute_grads`` (the objective to 1e-5 relative, partition norms and
leaves to 1e-4); and, with no JAX compile, the fused rollout equal to its
two sequential rollouts, an aug table equal to the base one giving the base
gradients, ``fit``'s batch order equal to JAX's, the ``local`` draws,
selective remat (``dots``, ``dots_all``) and the gradient accumulation
dtype under autocast (``grads_dtype``).

The A2C step is in ``test_torch_train_options_rl.py``, the ability
gradients in ``test_torch_train_options_ability.py`` and the optimizers and
CLI flags in ``test_torch_train_options_optim.py``.  Weights are drawn from
the spec's seed in both packages (``chip_smoke.seeded_flax_params``), so
the fixture ``tests/fixtures/golden_train_options_13.npz``, which
``chip_smoke.py`` phase 9 checks on the card, holds JAX's results only.
Rewrite it with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_options.py``.
"""

import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from chip_smoke import (GOLDEN_OPTIONS_SPEC as SPEC, OPTIONS_FIXTURE,
                        options_config, options_world_items,
                        seeded_flax_params, seeded_trainer_weights)
from test_torch_train_rollout import CHI2_CRIT_DF4, _chi2
from test_torch_trainer import _check_grads
from vln_magic_tpu import config as jcfg
from vln_magic_tpu import env as jenv
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.utils.checkpoint import flatten_params, unflatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch import env as tenv
from vln_magic_tpu_torch.agent import rollout as port_rollout
from vln_magic_tpu_torch.agent import trainer as port_trainer
from vln_magic_tpu_torch.models.vlnbert import _branch_linear

# the gradient leaves the fixture keeps, per run and partition
LEAVES = {
    "fused": {"params": ("params.cls_fuse.kernel",
                         "params.local_encoder.layer_0.ffn.output.kernel",
                         "params.local_sap_head.dense.kernel",
                         "params.pano_encoder.img_proj.kernel",
                         "params.kdl_img_w.kernel"),
              "t_params": ("params.lang_encoder.layer_0.attention.query."
                           "kernel",
                           "params.local_encoder.layer_0.ffn.output.kernel")},
    "a2c": {"params": ("params.cls_fuse.kernel",
                       "params.global_encoder.layer_0.ffn.output.kernel",
                       "params.global_sap_head.dense.kernel"),
            "critic_params": ("params.Dense_0.kernel", "params.Dense_1.bias")},
}
LEAVES["a2c_bf16"] = LEAVES["a2c"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def shape_only_init():
    """JAX's ``Trainer`` makes its parameters with a jitted flax ``init``,
    whose compile costs more than a tiny run; the weights are drawn from the
    seed afterwards, so the template is made from the shapes alone."""
    orig = FlaxModel.init

    def init(self, rng, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(orig, self), rng, *args,
                                **kwargs)
        return jax.tree_util.tree_map(
            lambda s: jnp.full(s.shape, jnp.nan, s.dtype), shapes)

    FlaxModel.init = init
    try:
        yield
    finally:
        FlaxModel.init = orig


def jax_options_trainer(run):
    """A JAX trainer of the spec's ``run`` with the seeded weights, and the
    spec's items."""
    world, items, aug = options_world_items(jenv)
    with shape_only_init():
        tr = jax_trainer.Trainer(options_config(jcfg, run), world,
                                 aug_features=aug if run == "fused" else None)

    def seeded(tree, seed):
        flat = flatten_params(tree)
        return unflatten_params(seeded_flax_params(
            {k: v.shape for k, v in flat.items()}, seed), template=tree)[0]

    s = SPEC["seed"]
    tr.params = seeded(tr.params, s)
    tr.t_params = seeded(tr.t_params, s + 1)
    tr.critic_params = seeded(tr.critic_params, s + 7)
    return tr, items


def run_arrays(run, loss, grads) -> dict:
    """A run's fixture entries: the objective, each partition's gradient
    norm and ``LEAVES``."""
    out = {f"{run}/loss": np.float32(loss)}
    for part, g in grads.items():
        out[f"{run}/grad_norm/{part}"] = np.float32(np.sqrt(sum(
            float(np.sum(np.square(np.asarray(v, np.float64))))
            for v in g.values())))
        for k in LEAVES[run][part]:
            out[f"{run}/grad/{part}/{k}"] = np.asarray(g[k], np.float32)
    return out


def jax_fused_run():
    """JAX's ``compute_grads`` of the fused run on an aug batch, with the
    spec's ability-gradient norms: (objective, grads by partition)."""
    tr, items = jax_options_trainer("fused")
    tr.ability_grads = np.asarray(SPEC["ability_grads"], np.float32)
    loss, (grads, t_grads) = tr.compute_grads(
        items, jax.random.PRNGKey(SPEC["seed"]), aug=True)
    return float(loss), {"params": flatten_params(grads),
                         "t_params": flatten_params(t_grads)}


def check_fixture(fresh: dict, rtol=1e-6):
    """The fixture's spec is ``SPEC`` and its entries of ``fresh`` equal
    the fresh JAX values (XLA's CPU code may round otherwise)."""
    fixture = dict(np.load(OPTIONS_FIXTURE))
    assert json.loads(str(fixture["spec"])) == json.loads(json.dumps(SPEC))
    for k, v in fresh.items():
        np.testing.assert_allclose(fixture[k], v, rtol=rtol,
                                   atol=rtol * np.max(np.abs(v)), err_msg=k)


def port_options_trainer(run, model=None, **train):
    """A port trainer of the spec's ``run`` (``model`` and ``train``
    overriding its ``ModelConfig`` and ``TrainConfig``), with the seeded
    weights; and the items."""
    world, items, aug = options_world_items(tenv)
    cfg = options_config(tcfg, run)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **(model or {})),
        teacher_model=dataclasses.replace(cfg.teacher_model,
                                          **(model or {})),
        train=dataclasses.replace(cfg.train, **train))
    tr = port_trainer.Trainer(cfg, world, device="cpu",
                              aug_features=aug if run == "fused" else None)
    seeded_trainer_weights(tr, SPEC["seed"])
    return tr, items


def check_against(got_loss, got, want_loss, want):
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-5)
    _check_grads(got, want, "compute_grads")
    for part in want:
        norm = lambda g: np.sqrt(sum(float(np.sum(np.square(
            np.asarray(v, np.float64)))) for v in g.values()))
        np.testing.assert_allclose(norm(got[part]), norm(want[part]),
                                   rtol=1e-4, err_msg=part)


@pytest.fixture(scope="module")
def jax_fused():
    loss, grads = jax_fused_run()
    return {"loss": loss, "grads": grads,
            "arrays": run_arrays("fused", loss, grads)}


# ---- against JAX ----------------------------------------------------------

def test_fused_fixture_is_a_fresh_jax_run(jax_fused):
    check_fixture(jax_fused["arrays"])


def test_fused_local_aug_compute_grads_matches_jax(jax_fused):
    """The fused dual rollout, ``fusion='local'`` supervision and actions,
    an aug batch and the ``grad`` ability weights, with distillation,
    MKTD and ICoD: the objective and both partitions' gradients."""
    tr, items = port_options_trainer("fused")
    tr.ability_grads = np.asarray(SPEC["ability_grads"], np.float32)
    loss, grads = tr.compute_grads(items, seed=SPEC["seed"], aug=True)
    assert sorted(grads) == ["params", "t_params"]
    check_against(loss, grads, jax_fused["loss"], jax_fused["grads"])


def test_golden_options_on_the_cpu():
    """``chip_smoke.golden_train_options``, which phase 9 runs on the card,
    passes against the fixture here."""
    errs = chip_smoke.golden_train_options("cpu")
    assert {"fused/loss", "a2c/loss", "ability_grads"} <= set(errs)


# ---- the port alone -------------------------------------------------------

def _metrics_and_params(tr, items):
    m = tr.train_step(items)
    return m, {k: p.detach().clone() for k, p in tr.model.named_parameters()}


@pytest.mark.parametrize("fusion", ["dynamic", "local"])
def test_fused_rollout_equals_two_rollouts(fusion):
    """One fused step (teacher+argmax at double width, no dropout) gives
    the metrics and the updated student (sgd, so that gradients that are
    rounding noise stay noise) of the teacher-forced rollout followed by
    the argmax one."""
    got, want = [], []
    for fused, out in ((True, got), (False, want)):
        tr, items = port_options_trainer("fused", {"fusion": fusion},
                                         fuse_rollouts=fused, optim="sgd",
                                         lr=1e-2)
        tr.ability_grads = np.asarray(SPEC["ability_grads"], np.float32)
        out.extend(_metrics_and_params(tr, items))
    assert sorted(got[0]) == sorted(want[0])
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-5, err_msg=k)
    for k, v in want[1].items():
        torch.testing.assert_close(got[1][k], v, rtol=1e-5, atol=1e-7,
                                   msg=k)


def test_aug_batch_on_the_base_table_gives_the_base_gradients():
    """An aug batch whose aug table is the base table computes what a
    plain batch does; the spec's rolled table changes the gradients."""
    tr, items = port_options_trainer("fused")
    base = tr.compute_grads(items, seed=1)
    tr.tables.aug_features = tr.tables.features.clone()
    same = tr.compute_grads(items, seed=1, aug=True)
    assert torch.equal(same[0], base[0])
    for part, g in base[1].items():
        for k, v in g.items():
            assert torch.equal(same[1][part][k], v), k
    rolled, _ = port_options_trainer("fused")
    assert rolled.compute_grads(items, seed=1, aug=True)[0] != base[0]


@pytest.mark.parametrize("aug_times", [0, 1, 2])
def test_fit_batch_order_matches_jax(aug_times, monkeypatch):
    """``fit``'s train and aug batches, and their order, over two calls
    (the data-order rng persists), equal JAX's, both ``train_step``
    replaced by a recorder."""
    world, items, _ = options_world_items(tenv)
    aug_items = [dict(it, instr_id=f"aug_{i}") for i, it in enumerate(
        items + items[:3])]
    record = {"jax": [], "port": []}

    def recorder(key):
        def step(self, batch, zdicts=None, aug=False):
            record[key].append(([b["instr_id"] for b in batch], bool(aug)))
            return {}
        return step

    monkeypatch.setattr(jax_trainer.Trainer, "train_step", recorder("jax"))
    monkeypatch.setattr(port_trainer.Trainer, "train_step",
                        recorder("port"))
    jt, _ = jax_options_trainer("a2c")
    pt, _ = port_options_trainer("a2c")
    for tr in (jt, pt):
        for iters in (5, 4):
            hist = tr.fit(items, iters, aug_items=aug_items,
                          aug_times=aug_times)
            assert [h["aug"] for h in hist] == [
                float(b) for _, b in record[
                    "jax" if tr is jt else "port"][-iters:]]
    assert record["port"] == record["jax"]
    assert any(a for _, a in record["port"]) == (aug_times > 0)


def _local_rollout():
    world, _, _ = options_world_items(tenv)
    tr = port_trainer.Trainer(options_config(tcfg, "fused"), world,
                              device="cpu")
    return tr.rollout


@pytest.mark.parametrize("feedback", ["sample", "expl_sample"])
def test_local_draws_follow_their_mixture(feedback):
    """``fusion='local'``: ``sample`` draws from softmax of the viewpoint
    logits (non-navigable slots masked), ``expl_sample`` takes the best
    logit with probability ``expl_max_ratio`` and otherwise a uniform draw
    over the navigable slots (``vp_nav_masks``, the explore mask)."""
    ro = _local_rollout()
    nav = torch.tensor([[True, False, True, True, False, True, False]])
    logits = torch.tensor([[0.4, -1e9, 1.2, -0.3, -1e9, 0.1, -1e9]])
    if feedback == "sample":
        probs = torch.softmax(logits, -1)[0].numpy()
    else:
        sel = nav[0].numpy()
        ratio = ro.env.expl_max_ratio
        probs = (1 - ratio) * sel / sel.sum()
        probs[int(logits.argmax())] += ratio
    gen = torch.Generator().manual_seed(21)
    n = 4000
    draws = torch.stack([ro.select_action(logits, feedback, gen, None, None,
                                          explore_mask=nav)
                         for _ in range(n)])[:, 0]
    counts = np.bincount(draws.numpy(), minlength=logits.shape[1])
    assert _chi2(counts, probs) < CHI2_CRIT_DF4


# ---- selective remat ------------------------------------------------------

@pytest.mark.parametrize("policy", ["dots", "dots_all"])
def test_selective_remat_gradients_equal_the_plain_ones(policy):
    tr, items = port_options_trainer("fused")
    plain = tr.compute_grads(items, seed=3)
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, remat=True, remat_policy=policy))
    remat = tr.compute_grads(items, seed=3)
    torch.testing.assert_close(remat[0], plain[0])
    for part in plain[1]:
        for k, g in plain[1][part].items():
            torch.testing.assert_close(remat[1][part][k], g, rtol=1e-5,
                                       atol=1e-7, msg=k)


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["dots", "dots_all"])
def test_selective_remat_saves_the_products(policy, monkeypatch):
    """In one fused step's forward the policy saves every output of its
    ops (``rollout.REMAT_SAVED``), as many as the plain forward computes
    inside the step loop: ``dots`` the weight products (``mm``/``addmm``),
    ``dots_all`` the batched ones (``bmm``) too; and the step reaches no
    product op that ``dots_all`` leaves out."""
    tr, items = port_options_trainer("fused")
    state0, ids, masks = tr._batch(items, aug=True)
    run = lambda: tr._loss_for_fused_rollouts(state0, ids, masks, 5)
    # the plain steps' ops, counted inside the step function only
    plain = _OpCounter()
    step = port_rollout.Rollout._train_step

    def counted(self, *args):
        with plain:
            return step(self, *args)

    monkeypatch.setattr(port_rollout.Rollout, "_train_step", counted)
    run()
    monkeypatch.setattr(port_rollout.Rollout, "_train_step", step)
    tr.rollout.remat_ops.clear()
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, remat=True, remat_policy=policy))
    total, t_total, _ = run()
    (total + t_total).backward()
    seen = tr.rollout.remat_ops
    saved = {op: n for op, n in seen.items()
             if op in port_rollout.REMAT_SAVED[policy]}
    aten = torch.ops.aten
    want = {op: plain.counts[op] for op in port_rollout.REMAT_SAVED[policy]
            if plain.counts.get(op)}
    assert saved == want
    products = {op for op in plain.counts
                if any(k in str(op) for k in ("mm", "matmul", "linear",
                                              "einsum", "conv", "dot"))}
    assert products <= set(port_rollout.REMAT_SAVED["dots_all"])
    assert aten.mm.default in saved or aten.addmm.default in saved
    assert (aten.bmm.default in saved) == (policy == "dots_all")


def test_bf16_remat_equals_no_remat():
    """Under bf16 compute (autocast, each use cast anew) a full-remat step
    gives the gradients of the plain one, at the f32 tolerance."""
    tr, items = port_options_trainer("fused", compute_dtype="bfloat16")
    plain = tr.compute_grads(items, seed=4)
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, remat=True))
    remat = tr.compute_grads(items, seed=4)
    torch.testing.assert_close(remat[0], plain[0])
    for part in plain[1]:
        for k, g in plain[1][part].items():
            torch.testing.assert_close(remat[1][part][k], g, rtol=1e-5,
                                       atol=1e-7, msg=k)


# ---- the gradient accumulation dtype under autocast -----------------------

T_USES = 15


@pytest.mark.parametrize("grads_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["student", "teacher", "fused_trunk"])
def test_weight_gradients_sum_in_grads_dtype(where, grads_dtype):
    """One weight used ``T_USES`` times under ``Trainer.autocast`` (bf16
    compute), as a rollout uses it once a step: a student and an ICoD
    teacher ``nn.Linear``, and a branch-fused trunk weight (stacked on
    every call, so not a leaf where it is used).  Under ``float32`` its
    gradient is the f32 sum of the per-use gradients (to 1e-6); under
    ``bfloat16`` (``Trainer._bf16_weights``) it is their bf16 running sum,
    the latest use first, as autograd accumulates.  The two sums differ by
    far more than 1e-6 here, so the first check fails if the uses were
    summed in bf16 (autocast's weight cache on)."""
    tr, _ = port_options_trainer(
        "fused", {"fuse_branches": where == "fused_trunk"},
        compute_dtype="bfloat16", grads_dtype=grads_dtype)
    model = tr.teacher_model if where == "teacher" else tr.model
    if where == "fused_trunk":
        master = model.global_encoder.layers[0].ffn.intermediate.weight

        def use(x):
            w = model._branch_weights()["layer_0"]
            return _branch_linear(x.expand(2, *x.shape),
                                  w["ffn.intermediate.weight"],
                                  w["ffn.intermediate.bias"])
    else:
        master = model.cls_fuse.weight
        use = model.cls_fuse
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal(
        (T_USES, 4, master.shape[1])).astype(np.float32))
    scale = rng.standard_normal(T_USES)
    models = [tr.model, tr.teacher_model]

    def grad(uses):
        for m in models:
            m.zero_grad(set_to_none=True)
        weights = (tr._bf16_weights() if grads_dtype == "bfloat16"
                   else contextlib.nullcontext())
        with weights:
            with tr.autocast():
                loss = sum(float(scale[t]) * use(xs[t]).float().sum()
                           for t in uses)
            loss.backward()
        return master.grad.clone()

    got = grad(range(T_USES))
    assert got.dtype == torch.float32
    per_use = [grad([t]) for t in range(T_USES)]
    f32_sum = torch.stack(per_use).sum(0)
    bf16_sum = per_use[-1].bfloat16()
    for g in per_use[-2::-1]:
        bf16_sum = bf16_sum + g.bfloat16()
    bf16_sum = bf16_sum.float()
    gap = float((bf16_sum - f32_sum).abs().max() / f32_sum.abs().max())
    assert gap > 1e-4
    if grads_dtype == "float32":
        torch.testing.assert_close(got, f32_sum, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, bf16_sum)


if __name__ == "__main__":
    from test_torch_train_options_ability import ability_arrays
    from test_torch_train_options_optim import optim_arrays
    from test_torch_train_options_rl import jax_a2c_run

    arrays = {"spec": np.asarray(json.dumps(SPEC))}
    arrays.update(run_arrays("fused", *jax_fused_run()))
    arrays.update(run_arrays("a2c", *jax_a2c_run()))
    arrays.update(run_arrays("a2c_bf16", *jax_a2c_run("a2c_bf16")))
    arrays.update(ability_arrays())
    arrays.update(optim_arrays())
    np.savez_compressed(OPTIONS_FIXTURE, **arrays)
    print(f"wrote {OPTIONS_FIXTURE}")
