"""The port's greedy rollout and evaluation (vln_magic_tpu_torch.agent) held
against vln_magic_tpu's: step-input assembly and transitions on the same
episode state, the pinned golden decodes, and the metrics.

Integers and bools must be equal; floats within 1e-6.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vln_magic_tpu.agent import rollout as jax_rollout
from vln_magic_tpu.agent.evaluator import Evaluator as JaxEvaluator
from vln_magic_tpu.agent.navigator import Navigator as JaxNavigator
from vln_magic_tpu.agent.navigator import episodes_from_items as jax_episodes
from vln_magic_tpu import config as jcfg
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import rollout as port_rollout
from vln_magic_tpu_torch.agent.evaluator import Evaluator
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.navigator import (episodes_from_items,
                                                pad_instructions)
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.models import layers as port_layers
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert

HERE = os.path.dirname(__file__)
FIXTURE = os.path.join(HERE, "fixtures", "golden_params_777.npz")
FTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def golden_cfg(module, **model_kw):
    """The tests/test_golden.py configuration, from either package."""
    return module.MagicConfig(
        model=module.ModelConfig(vocab_size=400, hidden_size=64,
                                 num_attention_heads=2, num_l_layers=2,
                                 num_pano_layers=1, num_x_layers=2,
                                 image_feat_size=24,
                                 max_position_embeddings=64, **model_kw),
        env=module.EnvConfig(max_action_len=8, max_gmap_len=24,
                             max_instr_len=48),
        train=module.TrainConfig(batch_size=8))


def golden_items(world):
    return make_synthetic_instructions(world, 8, np.random.default_rng(777),
                                       vocab_size=400, min_path=3, max_path=6)


@pytest.fixture(scope="module")
def golden_params():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def world():
    return make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                seed=777)


def test_golden_fixture_is_a_fresh_flax_init(golden_params):
    """tests/fixtures/golden_params_777.npz holds the flat f32 flax params
    that tests/test_golden.py decodes with (``PRNGKey(777)``); regenerate it
    with ``np.savez(FIXTURE, **flatten_params(nav.params))`` from this
    JAX Navigator if the model's parameters ever change."""
    world = jax_world(num_scans=2, nodes_per_scan=20, feat_dim=24, seed=777)
    nav = JaxNavigator(golden_cfg(jcfg),
                       world, rng=jax.random.PRNGKey(777))
    fresh = flatten_params(nav.params)
    assert sorted(fresh) == sorted(golden_params)
    for k, v in fresh.items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      golden_params[k], err_msg=k)


def _decode(world, params, **model_kw):
    nav = Navigator(golden_cfg(tcfg, **model_kw), world, params=params,
                    device="cpu")
    items = golden_items(world)
    (avg, per), preds = nav.evaluate(items, batch_size=8)
    return items, avg, preds


@pytest.mark.parametrize("golden,model_kw", [
    ("golden_decode.json", {}),
    ("golden_decode.json", {"use_pallas_attention": True}),
    ("golden_decode_local.json", {"fusion": "local"}),
], ids=["dynamic", "dynamic_packed", "local"])
def test_greedy_decode_matches_golden(world, golden_params, golden, model_kw):
    _, _, preds = _decode(world, golden_params, **model_kw)
    with open(os.path.join(HERE, golden)) as f:
        want = json.load(f)
    assert [p["trajectory_idx"] for p in preds] == want


def test_metrics_equal_the_jax_evaluator(world, golden_params):
    items, avg, preds = _decode(world, golden_params)
    want, want_per = JaxEvaluator(
        jax_world(num_scans=2, nodes_per_scan=20, feat_dim=24, seed=777),
        items).eval_metrics(preds)
    got, got_per = Evaluator(world, items).eval_metrics(preds)
    assert got == want and got_per == want_per
    for k, v in want.items():
        assert avg[k] == v, k


# ---- assembly and transition on one episode state -------------------------

STATE_FIELDS = ("scan", "cur", "heading", "elevation", "start", "goal",
                "gt_path", "gt_len", "visited", "obs_order", "obs_count",
                "step_ids", "stop_scores", "ended")


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=0, atol=FTOL, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def _states_equal(sj, st, what):
    for f in STATE_FIELDS:
        _eq(getattr(sj, f), getattr(st, f), f"{what}: {f}")
    _eq(sj.embed_sum["student"], st.embed_sum, f"{what}: embed_sum")
    _eq(sj.embed_cnt["student"], st.embed_cnt, f"{what}: embed_cnt")
    _eq(sj.mem["student"], st.mem, f"{what}: mem")


def _stamp_jax(state, t_step, trash):
    bi = jnp.arange(state.batch_size)
    live = ~state.ended
    return state.replace(step_ids=state.step_ids.at[
        bi, jnp.where(live, state.cur, trash)].set(
        jnp.where(live, t_step + 1, state.step_ids[bi, trash])))


def _stamp_port(state, t_step, trash):
    bi = torch.arange(state.batch_size)
    live = ~state.ended
    state.step_ids[bi, torch.where(live, state.cur, trash)] = torch.where(
        live, t_step + 1, state.step_ids[:, trash])


@pytest.mark.parametrize("max_gmap_len", [12, 48], ids=["truncating",
                                                        "padded"])
def test_assembly_and_transition_match_jax(world, max_gmap_len):
    d = 16
    env = jcfg.EnvConfig(max_action_len=8, max_gmap_len=max_gmap_len)
    jw = jax_world(num_scans=2, nodes_per_scan=20, feat_dim=24, seed=777)
    items = golden_items(jw)
    tj = jax_rollout.Tables.from_world(jw.tables)
    rj = jax_rollout.Rollout(tj, env, FlaxModel(golden_cfg(jcfg).model))
    sj = jax_episodes(tj, jw, items, {"student": d})

    tt = port_rollout.Tables.from_world(world.tables, "cpu")
    model = DualScaleVLNBert(golden_cfg(tcfg).model, device="cpu")
    rt = port_rollout.Rollout(
        tt, tcfg.EnvConfig(max_action_len=8, max_gmap_len=max_gmap_len),
        model)
    st = episodes_from_items(tt, items, d)
    _states_equal(sj, st, "init")

    ep_j = {"dist_f": tj.dist[sj.scan], "pos": tj.positions[sj.scan],
            "nh_f": tj.next_hop[sj.scan].astype(jnp.float32)}
    ep_t = {"dist_f": tt.dist[st.scan], "pos": tt.positions[st.scan],
            "nh": tt.next_hop[st.scan]}
    trash = tt.num_nodes
    # each JAX function jitted alone, as its rollout runs it compiled (and
    # faster to compile whole than op by op); the role, the step index and
    # the feedback mode are static arguments
    j_pano = jax.jit(rj.assemble_pano)
    j_gmap_base = jax.jit(rj.assemble_gmap_base)
    j_vp_base = jax.jit(rj.assemble_vp_base)
    j_update = jax.jit(rj.update_node_embeds, static_argnums=1)
    j_gmap = jax.jit(rj.assemble_gmap, static_argnums=1)
    j_vp = jax.jit(rj.assemble_vp, static_argnums=1)
    j_transition = jax.jit(rj.transition, static_argnums=(4, 5))
    rng = np.random.default_rng(0)
    for t_step in range(3):
        sj = _stamp_jax(sj, t_step, trash)
        _stamp_port(st, t_step, trash)
        pj, pt = j_pano(sj), rt.assemble_pano(st)
        for k in pt:
            _eq(pj[k], pt[k], f"step {t_step} pano {k}")
        gj = j_gmap_base(sj, ep_j)
        gt = rt.assemble_gmap_base(st, ep_t)
        for k in gt:
            _eq(gj[k], gt[k], f"step {t_step} gmap {k}")
        vj = j_vp_base(sj, pj, gj, ep_j)
        vt = rt.assemble_vp_base(st, pt, gt, ep_t)
        for k in vt:
            _eq(vj[k], vt[k], f"step {t_step} vp {k}")

        b, p = pt["pano_masks"].shape
        emb = rng.standard_normal((b, p, d)).astype(np.float32)
        fused = rng.standard_normal((b, d)).astype(np.float32)
        sj = j_update(sj, "student", jnp.asarray(emb),
                                   jnp.asarray(fused), pj["cand_ids"],
                                   pj["cand_mask"])
        rt.update_node_embeds(st, torch.from_numpy(emb),
                              torch.from_numpy(fused), pt["cand_ids"],
                              pt["cand_mask"])
        gj2 = j_gmap(sj, "student", gj)
        gt2 = rt.assemble_gmap(st, gt)
        _eq(gj2["gmap_img_embeds"], gt2["gmap_img_embeds"], "gmap embeds")
        _eq(j_vp(sj, "student", pj, jnp.asarray(emb), gj2,
                 vj)["vp_img_embeds"],
            rt.assemble_vp(st, torch.from_numpy(emb), vt)["vp_img_embeds"],
            "vp embeds")
        mem = rng.standard_normal((b, d)).astype(np.float32)
        sj = sj.replace(mem={"student": jnp.asarray(mem)})
        st.mem = torch.from_numpy(mem)

        # a greedy action over selectable tokens (stop kept unlikely)
        g = np.asarray(gt["gmap_masks"]).shape[1]
        sel = np.asarray(gt["gmap_masks"] & ~gt["gmap_visited_masks"])
        logits = np.where(sel, rng.standard_normal((b, g)), -1e9)
        logits[:, 0] = -5.0
        action = logits.argmax(1)
        stop_prob = rng.random(b).astype(np.float32)
        sj, cj, _ = j_transition(sj, gj2, jnp.asarray(action, jnp.int32),
                                 jnp.asarray(stop_prob), t_step, "argmax",
                                 pano=pj, ep=ep_j)
        ct = rt.transition(st, gt2, torch.from_numpy(action),
                           torch.from_numpy(stop_prob), t_step, pt, ep_t)
        _eq(cj, ct, f"step {t_step} chosen")
        _states_equal(sj, st, f"after step {t_step}")
    _eq(rj.final_stop_node(sj), rt.final_stop_node(st), "stop node")


def test_one_wave_calls_packed_attention_216_times_at_full_depth(monkeypatch):
    """6 language self-attentions, then per step 2 panorama self-attentions
    and 3 cross + 3 self attentions in each of the 2 branches."""
    calls = []
    real = port_layers.packed_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(port_layers, "packed_attention", counting)
    w = make_synthetic_world(num_scans=1, nodes_per_scan=12, feat_dim=8,
                             seed=1)
    cfg = tcfg.MagicConfig(
        model=tcfg.ModelConfig(vocab_size=50, hidden_size=32,
                               num_attention_heads=2, num_l_layers=6,
                               num_pano_layers=2, num_x_layers=3,
                               image_feat_size=8, max_position_embeddings=64,
                               use_pallas_attention=True),
        env=tcfg.EnvConfig(max_action_len=15, max_gmap_len=16,
                           max_instr_len=32),
        train=tcfg.TrainConfig(batch_size=2))
    nav = Navigator(cfg, w, seed=0, device="cpu")
    items = make_synthetic_instructions(w, 2, np.random.default_rng(0),
                                        vocab_size=50, min_path=2,
                                        max_path=4)
    (avg, _), preds = nav.evaluate(items)
    assert len(calls) == 6 + 15 * (2 + 2 * (3 + 3)) == 216
    assert len(preds) == 2 and np.isfinite(avg["nDTW"])


def test_unported_paths_raise(world, golden_params):
    """Parity mode, streaming, sampled feedback, MC ensembles and the fused
    teacher+<mode> rollout are ported and run (tests/test_torch_parity.py,
    tests/test_torch_streaming.py, tests/test_torch_train_rollout.py,
    tests/test_torch_ensemble.py and tests/test_torch_train_options.py pin
    them); teacher+<mode> without ``fused_split`` raises, as in JAX."""
    cfg = golden_cfg(tcfg)
    parity = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, observed_graph_parity=True))
    items = golden_items(world)
    (avg, _), preds = Navigator(parity, world, params=golden_params,
                                device="cpu").evaluate(items)
    assert len(preds) == len(items) and np.isfinite(avg["nDTW"])
    nav = Navigator(cfg, world, params=golden_params, device="cpu")
    (avg, _), preds = nav.evaluate(items, batch_size=4, stream=True)
    assert len(preds) == len(items) and np.isfinite(avg["nDTW"])
    (avg, _), preds = nav.evaluate(items, feedback="sample")
    assert len(preds) == len(items) and np.isfinite(avg["nDTW"])
    with pytest.raises(ValueError, match="fused_split"):
        nav.evaluate(items, feedback="teacher+sample")
    ids, masks = pad_instructions(items[:2] * 2, cfg.env.max_instr_len)
    state2 = episodes_from_items(nav.tables, items[:2] * 2,
                                 cfg.model.hidden_size)
    aux = nav.rollout.run(state2, torch.from_numpy(ids),
                          torch.from_numpy(masks), "teacher+sample",
                          train_ml=1.0, fused_split=2)
    assert aux["ml_loss_vec"].shape == (2,)
    assert torch.isfinite(aux["ml_loss"]) and aux["actions"].shape[1] == 4
    (avg, _), preds = nav.evaluate(items, ensemble_n=2)
    assert len(preds) == len(items) and np.isfinite(avg["nDTW"])


def test_default_device_needs_a_gpu(world):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Navigator(golden_cfg(tcfg), world)


def test_geometry_matches_jax():
    from vln_magic_tpu.agent import geometry_jax as gj
    from vln_magic_tpu_torch.agent import geometry as gt

    rng = np.random.default_rng(5)
    f = lambda *s: rng.uniform(-10, 10, s).astype(np.float32)
    a, b, base_h, base_e = f(64, 3), f(64, 5, 3), f(64), f(64) / 10
    dist, steps = np.abs(f(64, 5)), np.abs(f(64, 5)).round()
    J, T = jnp.asarray, torch.from_numpy
    _eq(gj.angle_feature(J(base_h), J(base_e), 8),
        gt.angle_feature(T(base_h), T(base_e), 8), "angle_feature")
    for x, y, what in zip(gj.rel_pos(J(a)[:, None], J(b), J(base_h)[:, None]),
                          gt.rel_pos(T(a)[:, None], T(b), T(base_h)[:, None]),
                          ("heading", "elevation", "dist")):
        _eq(x, y, what)
    _eq(gj.pos_features_7(J(a)[:, None], J(b), J(dist), J(steps), J(base_h),
                          J(base_e)),
        gt.pos_features_7(T(a)[:, None], T(b), T(dist), T(steps), T(base_h),
                          T(base_e)), "pos_features_7")
    _eq(gj.view_angles_relative(J(base_h), J(base_e)),
        gt.view_angles_relative(T(base_h), T(base_e)), "view angles")
