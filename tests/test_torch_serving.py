"""The port's online serving (vln_magic_tpu_torch.agent.serving) held
against vln_magic_tpu's NavServer on the CPU.

The fixture is tests/test_serving.py's (18 nodes, hidden 64, 4 heads, 2/1/2
layers, features 32, T 8, gmap 24, 32-token instructions), with the JAX
navigator's weights carried into the port.  Instructions are fixed at
``max_instr_len``: a session pads to it, an offline wave buckets to
multiples of 16.  Decisions, stops and final trajectories are compared
exactly (the same argmax on the same f32 logits, whose computation agrees
to about 1e-6 between the packages); nodes are interned in observation
order, so names map back to world indices through ``graph.index``.

One JAX server, module-scoped, compiles its programs once; the JAX
sessions' results are computed once and shared.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from vln_magic_tpu.agent import Navigator as JaxNavigator
from vln_magic_tpu.agent.serving import NavServer as JaxServer
from vln_magic_tpu.config import (EnvConfig, MagicConfig, ModelConfig,
                                  TrainConfig)
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import serving
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.serving import (NavServer, NavSession,
                                               observation_from_world)
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.utils.weights import export_flax_params

INSTR_LEN = 32
# int8 bundle: params.npz under this share of the f32 bundle's
INT8_SIZE_SHARE = 0.45


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def serving_cfg(module, **model):
    return module.MagicConfig(
        model=module.ModelConfig(vocab_size=300, hidden_size=64,
                                 num_attention_heads=4, num_l_layers=2,
                                 num_pano_layers=1, num_x_layers=2,
                                 image_feat_size=32,
                                 max_position_embeddings=64, **model),
        env=module.EnvConfig(max_action_len=8, max_gmap_len=24,
                             max_instr_len=INSTR_LEN,
                             observed_graph_parity=True),
        train=module.TrainConfig(batch_size=1))


def serve_episode(world, sess, item, steps=8):
    """Drive ``sess`` through ``item`` from its start: (world-index actions,
    -1 for a stop; the session)."""
    g = world.graphs[item["scan_idx"]]
    cur = int(item["path_idx"][0])
    actions = []
    for _ in range(steps):
        dec = sess.step(observation_from_world(world, item["scan_idx"], cur,
                                               float(item["heading"])))
        if dec.target is not None:
            cur = g.index[dec.target]
        actions.append(-1 if dec.target is None else cur)
        if dec.stop:
            break
    return actions, sess


@pytest.fixture(scope="module")
def setup():
    jw = jax_world(num_scans=1, nodes_per_scan=18, feat_dim=32, seed=3)
    cfg = serving_cfg(tcfg)
    jnav = JaxNavigator(MagicConfig(
        model=ModelConfig(vocab_size=300, hidden_size=64,
                          num_attention_heads=4, num_l_layers=2,
                          num_pano_layers=1, num_x_layers=2,
                          image_feat_size=32, max_position_embeddings=64),
        env=EnvConfig(max_action_len=8, max_gmap_len=24,
                      max_instr_len=INSTR_LEN, observed_graph_parity=True),
        train=TrainConfig(batch_size=1)), jw, rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    items = make_synthetic_instructions(jw, 3, rng, vocab_size=300,
                                        min_path=3, max_path=6)
    for it in items:
        it["instr_encoding"] = rng.integers(4, 300, INSTR_LEN).astype(np.int32)
    n, c = jw.graphs[0].num_nodes, jw.tables.cand_ids.shape[2]
    jserver = JaxServer(jnav.cfg, jnav.params, max_nodes=n, max_cands=c,
                        model=jnav.model)
    want = []
    for it in items:
        actions, sess = serve_episode(jw, jserver.new_session(
            it["instr_encoding"]), it)
        want.append((actions, sess.finish()))
    world = make_synthetic_world(num_scans=1, nodes_per_scan=18, feat_dim=32,
                                 seed=3)
    return {"world": world, "cfg": cfg, "items": items, "n": n, "c": c,
            "params": flatten_params(jnav.params), "jserver": jserver,
            "jax": want}


def port_server(s, **kw):
    kw.setdefault("max_nodes", s["n"])
    return NavServer(s["cfg"], s["params"], max_cands=s["c"], device="cpu",
                     **kw)


@pytest.fixture(scope="module")
def server(setup):
    return port_server(setup)


def multi_step_item(s):
    """An item whose episode moves at step 0 and runs >= 2 decisions."""
    for it, (actions, _) in zip(s["items"], s["jax"]):
        if len(actions) >= 2 and actions[0] >= 0:
            return it, actions
    pytest.fail("no multi-step episode in the fixture items")


@pytest.mark.parametrize("packed", [False, True], ids=["einsum", "packed"])
def test_sessions_match_jax_and_the_offline_parity_rollout(setup, packed):
    """Per-step decisions, stop and the final trajectory (backtrack
    included) equal the JAX NavSession's and the port's offline parity
    rollout's; ``use_pallas_attention`` on sends the port's attention to
    ``packed_attention``, whose plain version serves CPU tensors."""
    s = setup
    cfg = serving_cfg(tcfg, use_pallas_attention=packed)
    server = NavServer(cfg, s["params"], max_nodes=s["n"], max_cands=s["c"],
                       device="cpu")
    nav = Navigator(cfg, s["world"], params=s["params"], device="cpu")
    g = s["world"].graphs[0]
    for it, (want_actions, want_final) in zip(s["items"], s["jax"]):
        actions, sess = serve_episode(s["world"], server.new_session(
            it["instr_encoding"]), it)
        final = sess.finish()
        assert actions == want_actions
        assert final == want_final
        _, aux = nav.run_items([it])
        offline = aux["actions"][:, 0].tolist()
        assert actions + [-1] * (len(offline) - len(actions)) == offline
        assert final["stop_node"] == g.node_ids[int(aux["stop_node"][0])]
        assert final["trajectory"] == [
            g.node_ids[k] for k in
            aux["traj_nodes"][0, :int(aux["traj_len"][0])].tolist()]


def test_a_rejected_observation_leaves_the_session_as_it_was(setup, server):
    """A wrong node, too many candidates and a node budget overrun raise
    before the mirrors, the names or the queued row change: the episode
    then goes on as the uninterrupted JAX one."""
    s = setup
    it, want = multi_step_item(s)
    world, g = s["world"], s["world"].graphs[0]
    start = observation_from_world(world, 0, int(it["path_idx"][0]),
                                   float(it["heading"]))
    sess = server.new_session(it["instr_encoding"])
    target = g.index[sess.step(start).target]
    nxt = observation_from_world(world, 0, target, 0.0)
    wrong = observation_from_world(world, 0, (target + 1) % g.num_nodes, 0.0)
    many = dataclasses.replace(nxt, candidates=nxt.candidates * (s["c"] + 1))
    before = {k: v.copy() for k, v in sess._mirrors().items()}
    names = list(sess._names)
    for bad, match in ((wrong, "current node"), (many, "max_cands")):
        with pytest.raises(ValueError, match=match):
            sess.step(bad)
        for k, v in sess._mirrors().items():
            np.testing.assert_array_equal(v, before[k], err_msg=k)
        assert sess._names == names and sess.fleet._pending_rows == {}
    rest, sess = serve_episode(world, sess, dict(it, path_idx=[target]), 7)
    assert [target] + rest == want

    tight = port_server(s, max_nodes=len(names)).new_session(
        it["instr_encoding"])
    tight.step(start)
    before = {k: v.copy() for k, v in tight._mirrors().items()}
    unseen = dataclasses.replace(nxt, candidates=nxt.candidates[:s["c"] - 1]
                                 + [serving.Candidate("unseen", (9.0, 9.0, 0.0),
                                                      1.0)])
    with pytest.raises(ValueError, match="max_nodes"):
        tight.step(unseen)
    for k, v in tight._mirrors().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert tight._names == names and tight.fleet._pending_rows == {}


def test_a_decision_writes_its_row_in_place_with_one_upload(setup, server,
                                                             monkeypatch):
    """The arrival feature row is written into the session's bank in place
    (the bank is not copied), and a decision makes one upload, as the
    module docstring says."""
    s = setup
    it = s["items"][0]
    uploads = []
    real = NavServer._upload
    monkeypatch.setattr(NavServer, "_upload",
                        lambda self, host: uploads.append(host.shape)
                        or real(self, host))
    sess = server.new_session(it["instr_encoding"])
    assert len(uploads) == 1                # the instruction
    bank = sess.fleet._features
    ptr = bank.data_ptr()
    start = int(it["path_idx"][0])
    obs = observation_from_world(s["world"], 0, start, float(it["heading"]))
    dec = sess.step(obs)
    assert len(uploads) == 2
    assert sess.fleet._features is bank and bank.data_ptr() == ptr
    np.testing.assert_array_equal(bank[0, sess._ids[obs.node]].numpy(),
                                  obs.pano_feats)
    if not dec.stop:
        g = s["world"].graphs[0]
        sess.step(observation_from_world(s["world"], 0, g.index[dec.target],
                                         0.0))
        assert len(uploads) == 3 and bank.data_ptr() == ptr


def test_save_restore_mid_episode(setup, server, tmp_path):
    """A session saved after its first decision and restored on a fresh
    server continues with the decisions and final trajectory of the
    uninterrupted run."""
    s = setup
    it, want = multi_step_item(s)
    world, g = s["world"], s["world"].graphs[0]
    sess = server.new_session(it["instr_encoding"])
    dec = sess.step(observation_from_world(world, 0, int(it["path_idx"][0]),
                                           float(it["heading"])))
    path = str(tmp_path / "session.blob")
    sess.save(path)
    resumed = NavSession.restore(port_server(s), path)
    item = dict(it, path_idx=[g.index[dec.target]])
    rest, resumed = serve_episode(world, resumed, item, 8 - 1)
    assert [g.index[dec.target]] + rest == want
    assert resumed.finish() == s["jax"][s["items"].index(it)][1]
    with np.load(path, allow_pickle=False) as blob:
        assert int(blob["state.scan"][0]) == 0
        assert blob["features"].shape == (1, s["n"], 36, 32)


def test_node_budget_and_its_default_from_the_config(setup):
    s = setup
    it = s["items"][0]
    small = port_server(s, max_nodes=2)
    with pytest.raises(ValueError, match="max_nodes"):
        small.new_session(it["instr_encoding"]).step(observation_from_world(
            s["world"], 0, int(it["path_idx"][0]), float(it["heading"])))
    srv = NavServer(s["cfg"], s["params"], device="cpu")
    assert srv.n == s["cfg"].env.max_gmap_len - 2
    assert srv.cfg.env.observed_graph_parity


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_bundle_round_trip(setup, server, tmp_path, quantize):
    """``export_bundle`` then ``from_bundle``: f32 gives the same bits and
    decisions; int8 stores params.npz under 0.45 of the f32 file, holds
    JAX's int8 values, and its session runs to ``finish``."""
    s = setup
    full = str(tmp_path / "f32")
    server.export_bundle(full)
    with open(os.path.join(full, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == serving.BUNDLE_FORMAT and not meta["quantized"]
    assert meta["max_nodes"] == s["n"] and meta["torch_version"]
    if not quantize:
        loaded = NavServer.from_bundle(full, device="cpu")
        got = export_flax_params(loaded.model)
        for k, v in export_flax_params(server.model).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        for it, (want, final) in zip(s["items"], s["jax"]):
            actions, sess = serve_episode(s["world"], loaded.new_session(
                it["instr_encoding"]), it)
            assert actions == want and sess.finish() == final
        return
    from vln_magic_tpu.utils.quantize import quantize_params

    small = str(tmp_path / "int8")
    server.export_bundle(small, quantize=True)
    size = lambda p: os.path.getsize(os.path.join(p, "params.npz"))
    assert size(small) < INT8_SIZE_SHARE * size(full)
    want_q = flatten_params(quantize_params(s["params"]))
    with np.load(os.path.join(small, "params.npz")) as got_q:
        for k, v in want_q.items():
            if k.endswith((".__int8__", ".scale")):
                np.testing.assert_array_equal(got_q[k], v, err_msg=k)
    loaded = NavServer.from_bundle(small, device="cpu")
    actions, sess = serve_episode(s["world"], loaded.new_session(
        s["items"][0]["instr_encoding"]), s["items"][0])
    final = sess.finish()
    assert len(actions) >= 1 and final["trajectory"][0] == \
        s["world"].graphs[0].node_ids[int(s["items"][0]["path_idx"][0])]


def test_a_jax_bundle_is_refused_with_a_clear_error(setup, tmp_path):
    path = str(tmp_path / "jax_bundle")
    setup["jserver"].export_bundle(path)
    with pytest.raises(ValueError, match="JAX serving bundle .*StableHLO"):
        NavServer.from_bundle(path, device="cpu")
    with pytest.raises(ValueError, match="not a serving bundle"):
        NavServer.from_bundle(str(tmp_path), device="cpu")


def test_device_defaults_to_cuda(setup, tmp_path):
    """``NavServer``, ``NavFleet`` and ``from_bundle`` default to "cuda"
    and raise on a host without a GPU; a model elsewhere than the device
    raises."""
    s = setup
    model = DualScaleVLNBert(s["cfg"].model, device="cpu")
    with pytest.raises(ValueError, match="one of the two"):
        NavServer(s["cfg"], s["params"], model=model, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    path = str(tmp_path / "bundle")
    port_server(s).export_bundle(path)
    for make in (lambda: NavServer(s["cfg"], s["params"]),
                 lambda: serving.NavFleet(s["cfg"], s["params"], slots=2),
                 lambda: NavServer.from_bundle(path)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def random_observation(rng, names, c, d, node=None, twice=False):
    """An observation at ``node`` (default a random name) listing up to ``c``
    candidates drawn from ``names`` with replacement, so that a node may be
    listed twice and the observed node may list itself; every listing has
    its own position, a heading and elevation that are None a third of the
    time each, and a view that is None a third of the time.  ``twice``
    lists one node twice and the observed node once."""
    node = names[rng.integers(len(names))] if node is None else node
    picks = [names[i] for i in rng.integers(len(names),
                                            size=rng.integers(c + 1))]
    if twice:
        picks = (picks + [names[0], names[0], node])[-c:]
    pos = lambda: tuple(float(x) for x in rng.normal(0.0, 3.0, 3))
    maybe = lambda x: None if rng.random() < 1 / 3 else x
    cands = [serving.Candidate(
        node=name, position=pos(), dist=float(rng.uniform(0.5, 4.0)),
        heading=maybe(float(rng.uniform(-np.pi, np.pi))),
        elevation=maybe(float(rng.uniform(-0.5, 0.5))),
        view=maybe(int(rng.integers(36)))) for name in picks]
    return serving.Observation(node=node, position=pos(), heading=0.0,
                               pano_feats=np.zeros((36, d), np.float32),
                               candidates=cands)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_batched_fold_equals_jax_ingest_bit_for_bit(setup, seed,
                                                        monkeypatch):
    """A fleet tick folds all of its observations into the mirrors in one
    pass with one geometry call; after every tick, each slot's seven
    mirrors (float ones bit for bit) and its node ids equal what JAX's
    ``NavSession._ingest`` leaves after the same observation, one edge at a
    time.  Three slots over several episodes, a slot released and joined
    again between them; candidates with no heading, elevation or view,
    nodes listed twice, observed nodes that list themselves and rows with
    no free slot all occur."""
    s = setup
    rng = np.random.default_rng(seed)
    f = serving.NavFleet(s["cfg"], s["params"], slots=3, max_nodes=s["n"],
                         max_cands=s["c"], device="cpu")
    names = [f"p{i}" for i in range(s["n"])]
    instr = s["items"][0]["instr_encoding"]
    calls = []
    real = serving.geo.rel_pos_features
    monkeypatch.setattr(serving.geo, "rel_pos_features",
                        lambda *a: calls.append(1) or real(*a))
    seen = {"full": 0, "missing": 0, "twice": 0, "self": 0}
    for episode in range(4):
        jax_sess = {}
        for slot in range(3):
            if episode == 0 or slot == episode % 3:
                f.release(slot)
                assert f.join(instr).slot == slot
                jax_sess[slot] = s["jserver"].new_session(instr)
            else:
                jax_sess[slot] = jax_prev[slot]
        for tick in range(6):
            batch = {slot: random_observation(rng, names, s["c"], 32,
                                              twice=tick == 0)
                     for slot in range(3)}
            calls.clear()
            f._submissions(batch)
            assert len(calls) == 1
            for slot, obs in batch.items():
                jax_sess[slot]._ingest(obs)
                listed = [cand.node for cand in obs.candidates]
                seen["missing"] += any(cand.heading is None
                                       for cand in obs.candidates)
                seen["twice"] += len(set(listed)) < len(listed)
                seen["self"] += obs.node in listed
                port, want = f._sessions[slot], jax_sess[slot]
                assert port._names == want._names
                assert f._pending_rows[slot][0] == want._pending_row[0]
                got = port._mirrors()
                for name in serving.MIRRORS:
                    ref = getattr(want, {"pos": "h_pos", "dist": "h_dist",
                                         "cand_elev": "h_cand_elev"}.get(
                                             name, "h_" + name))
                    if name in serving.INT_MIRRORS:
                        np.testing.assert_array_equal(
                            got[name], ref.astype(np.float32), err_msg=name)
                    else:
                        np.testing.assert_array_equal(
                            got[name].view(np.int32), ref.view(np.int32),
                            err_msg=name)
                seen["full"] += int((got["cand_ids"] >= 0).all(1).any())
        jax_prev = jax_sess
    assert all(seen.values()), seen
