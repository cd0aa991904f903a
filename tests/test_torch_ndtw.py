"""The port's nDTW DAgger expert (``expert_policy="ndtw"``) held against
vln_magic_tpu's: along a non-parity rollout of random moves, the expanded
trajectory each transition records (``traj_nodes``/``traj_len``, exact),
``_ndtw_scores`` at every step (1e-6) at the default and at short ``lp``/``k_ext`` (truncated trajectories,
unfinished extensions), and the expert's actions (exact); then
``Trainer.compute_grads`` of a DAgger step under the nDTW expert against
JAX's (the objective to 1e-5, every gradient leaf to 1e-4 of its largest
magnitude, as ``tests/test_torch_trainer.py``), which needs the
trajectory recorded in the training rollout's copy-on-step state too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_rollout import random_flax_params
from test_torch_trainer import _check_grads
from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import rollout as jax_rollout
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.agent.navigator import episodes_from_items as jax_episodes
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import rollout as port_rollout
from vln_magic_tpu_torch.agent import trainer as port_trainer
from vln_magic_tpu_torch.agent.navigator import episodes_from_items
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.utils.weights import load_trainer_params

STEPS, BATCH = 12, 6
WORLD = {"num_scans": 2, "nodes_per_scan": 30, "feat_dim": 16, "seed": 4}
# (k_ext, lp): the default, and one that truncates trajectories and leaves
# extensions unfinished
SHAPES = [(16, 48), (3, 5)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def model_cfg(module):
    return module.ModelConfig(
        vocab_size=300, hidden_size=32, num_attention_heads=2,
        num_l_layers=1, num_pano_layers=1, num_x_layers=1, image_feat_size=16,
        max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0)


def env_cfg(module, steps=STEPS):
    return module.EnvConfig(max_action_len=steps, max_gmap_len=32,
                            max_instr_len=32, expert_policy="ndtw")


@pytest.fixture(scope="module")
def walk():
    """Both packages' rollouts stepped through the same random moves; per
    step, each side's (nDTW scores per shape, expert actions, traj_nodes,
    traj_len)."""
    jw, tw = jax_world(**WORLD), make_synthetic_world(**WORLD)
    items = make_synthetic_instructions(jw, BATCH, np.random.default_rng(2),
                                        vocab_size=300, min_path=2,
                                        max_path=6)
    jt = jax_rollout.Tables.from_world(jw.tables)
    tt = port_rollout.Tables.from_world(tw.tables, "cpu")
    rj = jax_rollout.Rollout(jt, env_cfg(jcfg), FlaxModel(model_cfg(jcfg)))
    rt = port_rollout.Rollout(tt, env_cfg(tcfg),
                              DualScaleVLNBert(model_cfg(tcfg), device="cpu"))
    sj = jax_episodes(jt, jw, items, {"student": 8})
    st = episodes_from_items(tt, items, 8)
    ep_j = {"dist_f": jt.dist[sj.scan], "pos": jt.positions[sj.scan],
            "nh_f": jt.next_hop[sj.scan].astype(jnp.float32)}
    ep_t = rt.episode_tables(st)

    j_base = jax.jit(rj.assemble_gmap_base)
    j_pano = jax.jit(rj.assemble_pano)
    j_nd = {(k, lp): jax.jit(lambda s, g, k=k, lp=lp: rj._ndtw_scores(
        s, g, k, lp, ep_j)) for k, lp in SHAPES}
    # the step is traced, as in JAX's rollout scan: one compile each
    j_target = jax.jit(rj.teacher_action, static_argnums=(3,))
    j_transition = jax.jit(rj.transition, static_argnums=(5,))
    rng = np.random.default_rng(3)
    steps = []
    for t_step in range(STEPS - 1):
        gj, gt = j_base(sj, ep_j), rt.assemble_gmap_base(st, ep_t)
        rec = {"jax": {}, "port": {}}
        for k_ext, lp in SHAPES:
            rec["jax"][k_ext, lp] = np.asarray(j_nd[k_ext, lp](sj, gj))
            rec["port"][k_ext, lp] = rt._ndtw_scores(st, gt, ep_t, k_ext,
                                                     lp).numpy()
        rec["jax"]["action"] = np.asarray(j_target(sj, gj, jnp.int32(t_step),
                                                   False, ep_j))
        rec["port"]["action"] = rt.teacher_action(st, gt, t_step, False,
                                                  ep_t).numpy()
        # move on with a random selectable token (stop kept unlikely)
        sel = np.asarray(gt["gmap_masks"] & ~gt["gmap_visited_masks"])
        logits = np.where(sel, rng.standard_normal(sel.shape), -1e9)
        logits[:, 0] = -5.0
        action = logits.argmax(1)
        stop = rng.random(BATCH).astype(np.float32)
        sj, _, _ = j_transition(sj, gj, jnp.asarray(action, jnp.int32),
                                jnp.asarray(stop), jnp.int32(t_step),
                                "argmax",
                                pano=j_pano(sj), ep=ep_j)
        rt.transition(st, gt, torch.from_numpy(action),
                      torch.from_numpy(stop), t_step, rt.assemble_pano(st),
                      ep_t)
        rec["jax"]["traj"] = (np.asarray(sj.traj_nodes),
                              np.asarray(sj.traj_len))
        rec["port"]["traj"] = (st.traj_nodes.clone().numpy(),
                               st.traj_len.clone().numpy())
        steps.append(rec)
    return steps


def test_trajectory_recorded_as_jax(walk):
    for t, rec in enumerate(walk):
        for got, want in zip(rec["port"]["traj"], rec["jax"]["traj"]):
            np.testing.assert_array_equal(got, want, err_msg=str(t))
    lengths = walk[-1]["port"]["traj"][1]
    assert lengths.max() > SHAPES[1][1]     # the short lp truncates


@pytest.mark.parametrize("shape", SHAPES)
def test_ndtw_scores_match_jax(walk, shape):
    for t, rec in enumerate(walk):
        got, want = rec["port"][shape], rec["jax"][shape]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=str(t))
        assert 0 < got.min() and got.max() <= 1


def test_expert_actions_match_jax(walk):
    for t, rec in enumerate(walk):
        np.testing.assert_array_equal(rec["port"]["action"],
                                      rec["jax"]["action"], err_msg=str(t))
    actions = np.concatenate([rec["port"]["action"] for rec in walk])
    assert (actions >= 2).sum() > len(walk)     # mostly moves, not stops


def test_compute_grads_with_the_ndtw_expert_matches_jax(monkeypatch):
    """A DAgger step's on-policy rollout (argmax, supervised by the nDTW
    expert; ml_weight 0 leaves out the teacher-forced one, which takes no
    expert) through both trainers, from random weights made from the
    shapes (JAX's jitted flax ``init`` would cost a compile)."""
    monkeypatch.setattr(jax_trainer.Trainer, "_init",
                        lambda self, model, mcfg, rng:
                        random_flax_params(mcfg, 5))
    world_spec = {"num_scans": 1, "nodes_per_scan": 16, "feat_dim": 16,
                  "seed": 9}
    jw, tw = jax_world(**world_spec), make_synthetic_world(**world_spec)
    items = make_synthetic_instructions(jw, 4, np.random.default_rng(7),
                                        vocab_size=300, min_path=2,
                                        max_path=5)

    def cfg(module):
        return module.MagicConfig(
            model=model_cfg(module), env=env_cfg(module, steps=6),
            train=module.TrainConfig(batch_size=4, train_alg="dagger",
                                     ml_weight=0.0, dagger_sample="argmax"))

    jtr = jax_trainer.Trainer(cfg(jcfg), jw)
    loss, grads = jtr.compute_grads(items, jax.random.PRNGKey(7))
    want = {"params": flatten_params(grads)}
    ttr = port_trainer.Trainer(cfg(tcfg), tw, device="cpu")
    load_trainer_params(ttr, flatten_params(jtr.params), None,
                        flatten_params(jtr.critic_params))
    got_loss, got = ttr.compute_grads(items, seed=7)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    _check_grads(got, want, "compute_grads ndtw")
