"""Observed-graph parity decoding (EnvConfig.observed_graph_parity) in the
port, held against vln_magic_tpu's: the pinned parity golden decode, the
observed-subgraph state (obs_dist, obs_steps, traj_nodes, traj_len) after
init, after each step and after a full decode, and the metrics.

The observed-graph state is compared exactly (its distances are sums of the
same f32 edge lengths in the same order); other floats within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import rollout as jax_rollout
from vln_magic_tpu.agent.evaluator import Evaluator as JaxEvaluator
from vln_magic_tpu.agent.navigator import Navigator as JaxNavigator
from vln_magic_tpu.agent.navigator import episodes_from_items as jax_episodes
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import rollout as port_rollout
from vln_magic_tpu_torch.agent.evaluator import Evaluator
from vln_magic_tpu_torch.agent.navigator import Navigator, episodes_from_items
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert

HERE = os.path.dirname(__file__)
FIXTURE = os.path.join(HERE, "fixtures", "golden_params_777.npz")
FTOL = 1e-6
PARITY_FIELDS = ("obs_dist", "obs_steps", "traj_nodes", "traj_len")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def parity_cfg(module):
    """tests/test_golden.py's parity configuration, from either package."""
    return module.MagicConfig(
        model=module.ModelConfig(vocab_size=400, hidden_size=64,
                                 num_attention_heads=2, num_l_layers=2,
                                 num_pano_layers=1, num_x_layers=2,
                                 image_feat_size=24,
                                 max_position_embeddings=64),
        env=module.EnvConfig(max_action_len=8, max_gmap_len=24,
                             max_instr_len=48, observed_graph_parity=True),
        train=module.TrainConfig(batch_size=8))


def golden_items(world):
    return make_synthetic_instructions(world, 8, np.random.default_rng(777),
                                       vocab_size=400, min_path=3, max_path=6)


@pytest.fixture(scope="module")
def world():
    return make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                seed=777)


@pytest.fixture(scope="module")
def jworld():
    return jax_world(num_scans=2, nodes_per_scan=20, feat_dim=24, seed=777)


@pytest.fixture(scope="module")
def port_nav(world):
    return Navigator(parity_cfg(tcfg), world, params=dict(np.load(FIXTURE)),
                     device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _exact(a, b, what):
    a, b = np.asarray(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=what)


def _close(a, b, what):
    a, b = np.asarray(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=0, atol=FTOL, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def test_parity_decode_matches_golden(world, port_nav):
    (_, _), preds = port_nav.evaluate(golden_items(world), batch_size=8)
    with open(os.path.join(HERE, "golden_decode_parity.json")) as f:
        assert [p["trajectory_idx"] for p in preds] == json.load(f)


def test_parity_metrics_equal_the_jax_evaluator(world, jworld, port_nav):
    items = golden_items(world)
    (avg, _), preds = port_nav.evaluate(items, batch_size=8)
    want, want_per = JaxEvaluator(jworld, items).eval_metrics(preds)
    got, got_per = Evaluator(world, items).eval_metrics(preds)
    assert got == want and got_per == want_per
    for k, v in want.items():
        assert avg[k] == v, k


def test_observed_state_equals_jax_after_init_and_a_full_decode(
        world, jworld, port_nav):
    items = golden_items(world)
    jnav = JaxNavigator(parity_cfg(jcfg), jworld,
                        rng=jax.random.PRNGKey(777))
    d = parity_cfg(tcfg).model.hidden_size
    s0j = jax_episodes(jnav.tables, jworld, items, {"student": d},
                       observed_parity=True)
    s0t = episodes_from_items(port_nav.tables, items, d, observed_parity=True)
    for f in PARITY_FIELDS + ("obs_order", "obs_count", "visited"):
        _exact(getattr(s0j, f), getattr(s0t, f), f"init: {f}")
    assert float(s0t.obs_dist.max()) == port_rollout.INF_DIST

    sj, auxj = jnav.run_items(items)
    st, auxt = port_nav.run_items(items)
    for f in PARITY_FIELDS + ("cur", "visited", "obs_order", "ended"):
        _exact(getattr(sj, f), getattr(st, f), f"decoded: {f}")
    for k in ("actions", "stop_node", "final_cur", "traj_nodes", "traj_len",
              "semantic_steps", "gmap_overflow"):
        _exact(auxj[k], auxt[k], f"aux {k}")
    # the backtrack went into aux only: the state keeps its own trajectory
    assert (auxt["traj_len"] >= st.traj_len).all()


def test_parity_assembly_and_transition_match_jax(world, jworld):
    """Step by step on one state: the parity branches of the gmap and vp
    assembly (observed-graph distances into pos_fts and the sprel pair
    distances) and of the transition (observed walk, relax)."""
    d = 16
    items = golden_items(jworld)
    jc, tc = parity_cfg(jcfg), parity_cfg(tcfg)
    tj = jax_rollout.Tables.from_world(jworld.tables)
    rj = jax_rollout.Rollout(tj, jc.env, FlaxModel(jc.model))
    sj = jax_episodes(tj, jworld, items, {"student": d}, observed_parity=True)
    tt = port_rollout.Tables.from_world(world.tables, "cpu")
    rt = port_rollout.Rollout(tt, tc.env,
                              DualScaleVLNBert(tc.model, device="cpu"))
    st = episodes_from_items(tt, items, d, observed_parity=True)
    ep_j = {"dist_f": tj.dist[sj.scan], "pos": tj.positions[sj.scan]}
    ep_t = rt.episode_tables(st)
    assert "nh" not in ep_t
    j_pano = jax.jit(rj.assemble_pano)
    j_gmap_base = jax.jit(rj.assemble_gmap_base)
    j_vp_base = jax.jit(rj.assemble_vp_base)
    j_transition = jax.jit(rj.transition, static_argnums=(4, 5))
    trash = tt.num_nodes
    rng = np.random.default_rng(3)
    for t_step in range(4):
        bi = jnp.arange(sj.batch_size)
        live = ~sj.ended
        sj = sj.replace(step_ids=sj.step_ids.at[
            bi, jnp.where(live, sj.cur, trash)].set(
            jnp.where(live, t_step + 1, sj.step_ids[bi, trash])))
        bt = torch.arange(st.batch_size)
        lt = ~st.ended
        st.step_ids[bt, torch.where(lt, st.cur, trash)] = torch.where(
            lt, t_step + 1, st.step_ids[:, trash])
        pj, pt = j_pano(sj), rt.assemble_pano(st)
        gj = j_gmap_base(sj, ep_j)
        gt = rt.assemble_gmap_base(st, ep_t)
        for k in gt:
            _close(gj[k], gt[k], f"step {t_step} gmap {k}")
        vj = j_vp_base(sj, pj, gj, ep_j)
        vt = rt.assemble_vp_base(st, pt, gt, ep_t)
        for k in vt:
            _close(vj[k], vt[k], f"step {t_step} vp {k}")
        b, g = np.asarray(gt["gmap_masks"]).shape
        sel = np.asarray(gt["gmap_masks"] & ~gt["gmap_visited_masks"])
        logits = np.where(sel, rng.standard_normal((b, g)), -1e9)
        logits[:, 0] = -5.0
        action = logits.argmax(1)
        stop_prob = rng.random(b).astype(np.float32)
        sj, cj, _ = j_transition(sj, gj, jnp.asarray(action, jnp.int32),
                                 jnp.asarray(stop_prob), t_step, "argmax",
                                 pano=pj, ep=ep_j)
        ct = rt.transition(st, gt, torch.from_numpy(action),
                           torch.from_numpy(stop_prob), t_step, pt, ep_t)
        _exact(cj, ct, f"step {t_step} chosen")
        for f in PARITY_FIELDS + ("cur", "heading", "elevation", "visited",
                                  "obs_order", "obs_count", "stop_scores",
                                  "ended"):
            _close(getattr(sj, f), getattr(st, f), f"step {t_step}: {f}")
    stop = rt.final_stop_node(st)
    tnj, tlj = rj._record_backtrack(sj, jnp.asarray(stop.numpy()))
    tnt, tlt = rt.record_backtrack(st, stop)
    _exact(tnj, tnt, "backtrack traj_nodes")
    _exact(tlj, tlt, "backtrack traj_len")

