"""Streaming (continuous-batching) evaluation in the port
(vln_magic_tpu_torch.agent.streaming), with the cases of
tests/test_streaming.py: the streamed decode equals the wave decode per
episode, across fusion modes, queues that do not divide the lanes and queues
smaller than the lanes; plus one case against the JAX StreamEval on the same
weights.  Integers and trajectories must be equal.
"""

import numpy as np
import pytest
import torch

import jax

from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent.navigator import Navigator as JaxNavigator
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.streaming import StreamEval
from vln_magic_tpu_torch.env import make_synthetic_world

LANES = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(module, fusion="dynamic", parity=False):
    return module.MagicConfig(
        model=module.ModelConfig(vocab_size=300, hidden_size=32,
                                 num_attention_heads=2, num_l_layers=1,
                                 num_pano_layers=1, num_x_layers=1,
                                 image_feat_size=24,
                                 max_position_embeddings=64, fusion=fusion),
        env=module.EnvConfig(max_action_len=6, max_gmap_len=20,
                             max_instr_len=32, observed_graph_parity=parity),
        train=module.TrainConfig(batch_size=LANES))


def _setup(fusion="dynamic", seed=7):
    world = make_synthetic_world(num_scans=2, nodes_per_scan=18, feat_dim=24,
                                 seed=seed)
    cfg = _cfg(tcfg, fusion)
    return world, cfg, Navigator(cfg, world, seed=seed, device="cpu")


def _items(world, n, seed=5, instr_len=32):
    rng = np.random.default_rng(seed)
    items = make_synthetic_instructions(world, n, rng, vocab_size=300,
                                        min_path=3, max_path=5)
    # one instruction length: the wave path buckets L per wave while the
    # stream bank uses one L for the queue; equal lengths make the
    # comparison exact by construction (padding is masked out either way)
    for it in items:
        it["instr_encoding"] = rng.integers(4, 300, instr_len).astype(np.int32)
    return items


@pytest.mark.parametrize("fusion", ["dynamic", "local"])
def test_stream_matches_wave_decode(fusion):
    world, cfg, nav = _setup(fusion=fusion)
    items = _items(world, 10)
    (avg_w, _), preds_w = nav.evaluate(items, batch_size=LANES, stream=False)
    (avg_s, _), preds_s = nav.evaluate(items, batch_size=LANES, stream=True)
    for pw, ps in zip(preds_w, preds_s):
        assert pw["trajectory_idx"] == ps["trajectory_idx"]
        assert pw["instr_id"] == ps["instr_id"]
    # the step counts differ: semantic_steps counts the padding episodes
    # (the waves repeat the last item, the queue the first ones), and
    # scan_steps is what streaming saves
    for k, v in avg_w.items():
        if k not in ("semantic_steps", "scan_steps"):
            assert avg_s[k] == pytest.approx(v), k


def test_stream_outputs_per_episode():
    """Raw streamed outputs equal the wave rollout's per-episode columns."""
    world, cfg, nav = _setup()
    items = _items(world, 9)   # 9 episodes over 4 lanes: uneven refill
    out = nav.stream_eval(LANES).run(items, cfg.env.max_instr_len)
    assert out["actions"].shape == (9, cfg.env.max_action_len)
    assert out["chunks"] >= 2
    for i in range(0, 8, LANES):
        _, aux = nav.run_items(items[i : i + LANES])
        np.testing.assert_array_equal(out["actions"][i : i + LANES],
                                      aux["actions"].numpy().T)
        np.testing.assert_array_equal(out["stop_node"][i : i + LANES],
                                      aux["stop_node"].numpy())
        np.testing.assert_array_equal(out["final_cur"][i : i + LANES],
                                      aux["final_cur"].numpy())


def test_stream_queue_smaller_than_lanes():
    world, cfg, nav = _setup()
    items = _items(world, 2)   # fewer episodes than lanes: the queue pads
    (_, _), preds_w = nav.evaluate(items, batch_size=LANES, stream=False)
    (_, _), preds_s = nav.evaluate(items, batch_size=LANES, stream=True)
    assert len(preds_s) == 2
    for pw, ps in zip(preds_w, preds_s):
        assert pw["trajectory_idx"] == ps["trajectory_idx"]


def test_stream_auto_gating(monkeypatch):
    """stream=None streams only when eligible and there are more items than
    lanes; stream=True on an ineligible call raises."""
    world, cfg, nav = _setup()
    items = _items(world, 6)
    streamed = []
    real = nav._evaluate_stream
    monkeypatch.setattr(nav, "_evaluate_stream",
                        lambda *a: streamed.append(1) or real(*a))
    nav.evaluate(items[:LANES], batch_size=LANES)
    assert not streamed
    nav.evaluate(items, batch_size=LANES)
    assert streamed == [1]
    with pytest.raises(ValueError):
        nav.evaluate(items, batch_size=LANES, stream=True, feedback="sample")
    with pytest.raises(ValueError):
        nav.evaluate(items, batch_size=LANES, stream=True, ensemble_n=2)
    # parity mode keeps the waves, and refuses streaming outright
    nav2 = Navigator(_cfg(tcfg, parity=True), world, seed=7, device="cpu")
    with pytest.raises(ValueError):
        nav2.evaluate(items, batch_size=LANES, stream=True)
    with pytest.raises(ValueError):
        StreamEval(nav2.rollout, nav2.cfg.env, LANES)
    (_, _), preds = nav2.evaluate(items, batch_size=LANES)
    assert len(preds) == len(items) and streamed == [1]


def test_stream_prepared_bank_reuse():
    """prepare() once and run(prepared=) twice equal run(items)."""
    world, cfg, nav = _setup()
    items = _items(world, 6)
    se = nav.stream_eval(LANES)
    ref = se.run(items, cfg.env.max_instr_len)
    prep = se.prepare(items, cfg.env.max_instr_len)
    for _ in range(2):
        out = se.run(prepared=prep)
        np.testing.assert_array_equal(out["actions"], ref["actions"])
        np.testing.assert_array_equal(out["stop_node"], ref["stop_node"])
        assert out["semantic_steps"] == ref["semantic_steps"]
    with pytest.raises(ValueError):
        se.run()   # neither items nor prepared


def test_stream_semantic_accounting():
    """Semantic steps equal the wave path's live-step count, and the stream
    runs no more steps than the waves plus drain rounding."""
    world, cfg, nav = _setup()
    items = _items(world, 12)
    out = nav.stream_eval(LANES).run(items, cfg.env.max_instr_len)
    sem_waves = sum(int(nav.run_items(items[i : i + LANES])[1]
                        ["semantic_steps"]) for i in range(0, 12, LANES))
    assert out["semantic_steps"] == sem_waves
    assert out["scan_steps"] <= (3 + 2) * cfg.env.max_action_len


def test_stream_equals_the_jax_stream_eval():
    """The port's StreamEval and the JAX one on the same weights and queue:
    actions, stop nodes, final nodes, overflow, chunks and semantic steps."""
    jw = jax_world(num_scans=2, nodes_per_scan=18, feat_dim=24, seed=7)
    jnav = JaxNavigator(_cfg(jcfg), jw, rng=jax.random.PRNGKey(7))
    world = make_synthetic_world(num_scans=2, nodes_per_scan=18, feat_dim=24,
                                 seed=7)
    nav = Navigator(_cfg(tcfg), world, params=flatten_params(jnav.params),
                    device="cpu")
    items = _items(world, 9)
    want = jnav.stream_eval(LANES).run(jnav.params, jnav.tables, items, 32)
    got = nav.stream_eval(LANES).run(items, 32)
    for k in ("actions", "stop_node", "final_cur", "overflow"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("chunks", "scan_steps", "semantic_steps"):
        assert got[k] == want[k], k
