"""The port's training rollout (vln_magic_tpu_torch.agent.rollout) held
against vln_magic_tpu's: the supervision targets on the same episode
states, ``Rollout.run`` with a teacher and distillation (the summed CE of
both models and each of the ten MAKD losses in both roles, to 1e-5
relative; also deterministic with a packed student), the sampled feedback
modes against their distributions, and the training switches of the model
layers (dropout, the packed path).

Weights are JAX-shaped random numpy arrays carried into both packages;
dropout is 0 and the DAgger feedback argmax, so both sides are
deterministic.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import rollout as jax_rollout
from vln_magic_tpu.agent.navigator import episodes_from_items as jax_episodes
from vln_magic_tpu.agent.navigator import pad_instructions
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.models.vlnbert import dummy_step_batch
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import rollout as port_rollout
from vln_magic_tpu_torch.agent.navigator import episodes_from_items
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.models import layers as port_layers
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.utils.weights import load_flax_params

RTOL = 1e-5
T_STEPS, BATCH = 5, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def model_cfg(module, hidden, kd_target, **kw):
    return module.ModelConfig(
        vocab_size=300, hidden_size=hidden, num_attention_heads=2,
        num_l_layers=1, num_pano_layers=1, num_x_layers=1, image_feat_size=16,
        max_position_embeddings=64, kd_heads=True, kd_target_size=kd_target,
        hidden_dropout=0.0, attention_dropout=0.0, **kw)


def env_cfg(module):
    return module.EnvConfig(max_action_len=T_STEPS, max_gmap_len=16,
                            max_instr_len=32)


def distill_cfg(module, **kw):
    return module.DistillConfig(train_kdl=True, train_teacher=True,
                                teacher_sample_hard_mining=True, **kw)


def random_flax_params(cfg, seed):
    """Random params of the flax model's own tree (shapes from
    ``jax.eval_shape`` of ``init``, values from numpy), LayerNorm scales
    near 1."""
    shapes = jax.eval_shape(FlaxModel(cfg).init, jax.random.PRNGKey(0),
                            dummy_step_batch(cfg, batch_size=1))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        x = 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(x + 1.0 if path[-1].key == "scale" else x)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup():
    """Both packages' world, tables, models (same weights) and items."""
    jw = jax_world(num_scans=1, nodes_per_scan=14, feat_dim=16, seed=9)
    tw = make_synthetic_world(num_scans=1, nodes_per_scan=14, feat_dim=16,
                              seed=9)
    items = make_synthetic_instructions(jw, BATCH, np.random.default_rng(2),
                                        vocab_size=300, min_path=2,
                                        max_path=4)
    cfgs = {m: (model_cfg(m, 32, 64), model_cfg(m, 64, 32))
            for m in (jcfg, tcfg)}
    params = (random_flax_params(cfgs[jcfg][0], 1),
              random_flax_params(cfgs[jcfg][1], 2))
    models = []
    for c, p in zip(cfgs[tcfg], params):
        m = DualScaleVLNBert(c, device="cpu")
        load_flax_params(m, flatten_params(p))
        models.append(m)
    jt = jax_rollout.Tables.from_world(jw.tables)
    tt = port_rollout.Tables.from_world(tw.tables, "cpu")
    return {"jw": jw, "tw": tw, "items": items, "cfgs": cfgs,
            "params": params, "models": models, "jt": jt, "tt": tt}


def _jax_run(s, feedback, distill, use_teacher_policy=False,
             deterministic=False):
    rj = jax_rollout.Rollout(s["jt"], env_cfg(jcfg),
                             FlaxModel(s["cfgs"][jcfg][0]),
                             FlaxModel(s["cfgs"][jcfg][1]))
    state = jax_episodes(s["jt"], s["jw"], s["items"], rj.model_dims)
    ids, masks = pad_instructions(s["items"], 32)
    run = jax.jit(lambda p, tp, st: rj.run(
        p, st, jnp.asarray(ids), jnp.asarray(masks), feedback,
        jax.random.PRNGKey(0), train_ml=0.2, deterministic=deterministic,
        teacher_params=tp, distill=distill,
        use_teacher_policy=use_teacher_policy)[1])
    return run(*s["params"], state)


def _port_run(s, feedback, distill, models=None, deterministic=False, **kw):
    ro = port_rollout.Rollout(s["tt"], env_cfg(tcfg), *(models or s["models"]))
    state = episodes_from_items(s["tt"], s["items"], 32, teacher_size=64)
    ids, masks = pad_instructions(s["items"], 32)
    return ro.run(state, torch.from_numpy(ids.astype(np.int64)),
                  torch.from_numpy(masks), feedback, seed=0, train_ml=0.2,
                  deterministic=deterministic, distill=distill, **kw)


@pytest.mark.parametrize("feedback,weights,teacher_policy", [
    ("teacher", "learned_weight", False), ("argmax", None, False),
    ("argmax", None, True)],
    ids=["teacher_forced_learned_weights", "argmax_plain_weights",
         "argmax_teacher_policy"])
def test_distillation_rollout_losses_match_jax(setup, feedback, weights,
                                               teacher_policy):
    """Both models' summed CE and the ten t2s and ten s2t MAKD losses;
    with ``use_teacher_policy`` the episodes follow the teacher's logits."""
    kw = ({"adaptive_ability_weight": True,
           "adaptive_ability_weight_type": weights} if weights else {})
    want = _jax_run(setup, feedback, distill_cfg(jcfg, **kw), teacher_policy)
    got = _port_run(setup, feedback, distill_cfg(tcfg, **kw),
                    use_teacher_policy=teacher_policy)
    np.testing.assert_array_equal(got["actions"].numpy(),
                                  np.asarray(want["actions"]))
    for key in ("ml_loss", "t_ml_loss"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=RTOL, err_msg=key)
    for group in ("kd_losses", "t_kd_losses"):
        assert sorted(got[group]) == sorted(want[group])
        for k, v in want[group].items():
            assert float(v) != 0.0, (group, k)
            np.testing.assert_allclose(got[group][k].item(), float(v),
                                       rtol=RTOL, err_msg=f"{group} {k}")
    assert int(got["gmap_overflow"]) == int(want["gmap_overflow"])


def test_deterministic_distillation_with_a_packed_student_matches_jax(setup):
    """A student with ``use_pallas_attention`` in a deterministic
    distillation rollout: the training forwards keep attention off the
    packed kernel (its zeros in place of the maps made the four attention
    losses 117-152x JAX's), so every loss, the attention ones included,
    equals JAX's CPU value to RTOL."""
    s = setup
    want = _jax_run(s, "teacher", distill_cfg(jcfg), deterministic=True)
    student = DualScaleVLNBert(model_cfg(tcfg, 32, 64,
                                         use_pallas_attention=True),
                               device="cpu")
    load_flax_params(student, flatten_params(s["params"][0]))
    got = _port_run(s, "teacher", distill_cfg(tcfg),
                    models=(student, s["models"][1]), deterministic=True)
    np.testing.assert_array_equal(got["actions"].numpy(),
                                  np.asarray(want["actions"]))
    np.testing.assert_allclose(got["ml_loss"].item(), float(want["ml_loss"]),
                               rtol=RTOL)
    for group in ("kd_losses", "t_kd_losses"):
        for k in ("txt_attn_loss", "img_attn_loss", "local_attn_loss",
                  "global_attn_loss"):
            assert float(want[group][k]) != 0.0, (group, k)
        for k, v in want[group].items():
            np.testing.assert_allclose(got[group][k].item(), float(v),
                                       rtol=RTOL, err_msg=f"{group} {k}")


def test_remat_rollout_equals_the_plain_rollout(setup):
    """``remat=True`` recomputes each step in the backward pass: the same
    losses and the same gradients as keeping the activations."""
    d = distill_cfg(tcfg)
    grads = []
    for remat in (False, True):
        for m in setup["models"]:
            m.zero_grad(set_to_none=True)
        aux = _port_run(setup, "argmax", d, remat=remat)
        loss = (aux["ml_loss"] + sum(aux["kd_losses"].values())
                + sum(aux["t_kd_losses"].values()) + aux["t_ml_loss"])
        loss.backward()
        grads.append([p.grad.clone() for m in setup["models"]
                      for p in m.parameters() if p.grad is not None])
    assert len(grads[0]) == len(grads[1]) > 0
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("parity", [False, True], ids=["full_graph",
                                                       "observed_graph"])
def test_training_rollout_leaves_its_state_as_it_was(setup, parity):
    """A training rollout copies what a step writes (autograd and remat
    read the inputs again): the state it was given is unchanged, and a
    second run on it gives the same losses.  Also with observed-graph
    parity, whose distances and trajectory a step updates too."""
    env = dataclasses.replace(env_cfg(tcfg), observed_graph_parity=parity)
    ro = port_rollout.Rollout(setup["tt"], env, *setup["models"])
    state = episodes_from_items(setup["tt"], setup["items"], 32,
                                observed_parity=parity, teacher_size=64)
    before = {f.name: getattr(state, f.name).clone()
              for f in dataclasses.fields(state)}
    ids, masks = pad_instructions(setup["items"], 32)
    ids, masks = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(masks)
    runs = [ro.run(state, ids, masks, "argmax", train_ml=0.2,
                   deterministic=False, distill=distill_cfg(tcfg))
            for _ in range(2)]
    for name, value in before.items():
        assert torch.equal(getattr(state, name), value), name
    assert torch.equal(runs[0]["actions"], runs[1]["actions"])
    assert runs[0]["ml_loss"].item() == runs[1]["ml_loss"].item()
    assert (runs[0]["actions"] >= 0).any()


def test_teacher_action_matches_jax(setup):
    """Imitation targets and the spl expert on the same episode states,
    over steps that visit nodes off the ground-truth path."""
    s = setup
    env = env_cfg(jcfg)
    rj = jax_rollout.Rollout(s["jt"], env, FlaxModel(s["cfgs"][jcfg][0]))
    rt = port_rollout.Rollout(s["tt"], env_cfg(tcfg), s["models"][0])
    sj = jax_episodes(s["jt"], s["jw"], s["items"], {"student": 8})
    st = episodes_from_items(s["tt"], s["items"], 8)
    ep_j = {"dist_f": s["jt"].dist[sj.scan], "pos": s["jt"].positions[sj.scan],
            "nh_f": s["jt"].next_hop[sj.scan].astype(jnp.float32)}
    ep_t = rt.episode_tables(st)
    j_base = jax.jit(rj.assemble_gmap_base)
    j_pano = jax.jit(rj.assemble_pano)
    j_target = jax.jit(rj.teacher_action, static_argnums=(2, 3))
    j_transition = jax.jit(rj.transition, static_argnums=(4, 5))
    rng = np.random.default_rng(3)
    for t_step in range(T_STEPS - 1):
        gj, gt = j_base(sj, ep_j), rt.assemble_gmap_base(st, ep_t)
        for imitation in (True, False):
            want = np.asarray(j_target(sj, gj, t_step, imitation, ep_j))
            got = rt.teacher_action(st, gt, t_step, imitation, ep_t).numpy()
            np.testing.assert_array_equal(got, want, err_msg=(t_step,
                                                              imitation))
        # move on with a random selectable token (stop kept unlikely)
        sel = np.asarray(gt["gmap_masks"] & ~gt["gmap_visited_masks"])
        logits = np.where(sel, rng.standard_normal(sel.shape), -1e9)
        logits[:, 0] = -5.0
        action = logits.argmax(1)
        stop = rng.random(BATCH).astype(np.float32)
        sj, _, _ = j_transition(sj, gj,
                                jnp.asarray(action, jnp.int32),
                                jnp.asarray(stop), t_step, "argmax",
                                pano=j_pano(sj), ep=ep_j)
        rt.transition(st, gt, torch.from_numpy(action), torch.from_numpy(stop),
                      t_step, rt.assemble_pano(st), ep_t)


# ---- sampled feedback against its distribution ----------------------------

# chi-square critical value at p = 0.001 for 4 degrees of freedom
CHI2_CRIT_DF4 = 18.467


def _chi2(counts, probs):
    n = counts.sum()
    expected = probs * n
    keep = expected > 0
    assert not counts[~keep].any(), "drew an action of probability 0"
    return float(((counts[keep] - expected[keep]) ** 2 / expected[keep]).sum())


def _sampling_rollout(setup):
    return port_rollout.Rollout(setup["tt"], env_cfg(tcfg),
                                setup["models"][0])


def test_sample_draws_follow_softmax(setup):
    ro = _sampling_rollout(setup)
    logits = torch.tensor([[1.5, -0.5, -1e9, 0.3, 0.0, -1e9, -1.0]])
    probs = torch.softmax(logits, -1)[0].numpy()
    gen = torch.Generator().manual_seed(11)
    n = 4000
    draws = torch.stack([ro.select_action(logits, "sample", gen, None, None)
                         for _ in range(n)])[:, 0]
    counts = np.bincount(draws.numpy(), minlength=logits.shape[1])
    assert _chi2(counts, probs) < CHI2_CRIT_DF4


def test_expl_sample_draws_follow_their_mixture(setup):
    """Argmax with probability ``expl_max_ratio``, else uniform over the
    selectable tokens (masked, not visited)."""
    ro = _sampling_rollout(setup)
    logits = torch.tensor([[0.1, 2.0, 0.5, -1e9, 0.4, 0.3, -1e9]])
    masks = torch.tensor([[True, True, True, False, True, True, True]])
    visited = torch.tensor([[False, False, False, False, False, False, True]])
    gmap = {"gmap_masks": masks, "gmap_visited_masks": visited}
    sel = (masks & ~visited)[0].numpy()
    ratio = ro.env.expl_max_ratio
    probs = (1 - ratio) * sel / sel.sum()
    probs[int(logits.argmax())] += ratio
    gen = torch.Generator().manual_seed(12)
    n = 4000
    draws = torch.stack([ro.select_action(logits, "expl_sample", gen, None,
                                          gmap) for _ in range(n)])[:, 0]
    counts = np.bincount(draws.numpy(), minlength=logits.shape[1])
    assert _chi2(counts, probs) < CHI2_CRIT_DF4


def test_sampled_decodes_depend_only_on_the_seed(setup):
    """An evaluation run with sampled feedback: the same seed gives the same
    actions, another seed other actions."""
    ro = _sampling_rollout(setup)
    ids, masks = pad_instructions(setup["items"], 32)
    ids, masks = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(masks)

    def actions(seed, feedback):
        state = episodes_from_items(setup["tt"], setup["items"], 32)
        return ro.run(state, ids, masks, feedback, seed=seed)["actions"]

    for feedback in ("sample", "expl_sample"):
        a = actions(0, feedback)
        assert torch.equal(a, actions(0, feedback))
        assert any(not torch.equal(a, actions(s, feedback))
                   for s in range(1, 6))


# ---- the layers' training switches ------------------------------------------

def test_training_attention_never_takes_the_packed_path(monkeypatch, setup):
    """A training call (deterministic=False) and a deterministic call that
    needs the maps (``need_maps``, the training rollout's) run the einsum
    path even with ``use_pallas_attention``; an evaluation call takes the
    packed path."""
    calls = []
    real = port_layers.packed_attention
    monkeypatch.setattr(port_layers, "packed_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = model_cfg(tcfg, 32, 64, use_pallas_attention=True)
    model = DualScaleVLNBert(cfg, device="cpu")
    ids = torch.randint(2, 300, (2, 8))
    masks = torch.ones((2, 8), dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    model.language(ids, masks, deterministic=False, generator=gen)
    _, maps = model.language(ids, masks, need_maps=True)
    assert calls == [] and maps.abs().sum() > 0
    model.language(ids, masks)
    assert len(calls) == cfg.num_l_layers


def test_dropout_keeps_one_minus_rate_scaled():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = port_layers.dropout(x, 0.1, False, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    again = port_layers.dropout(x, 0.1, False,
                                torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert port_layers.dropout(x, 0.1, True, gen) is x
