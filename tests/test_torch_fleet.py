"""The port's batched fleet serving (vln_magic_tpu_torch.agent.serving
``NavFleet``) held against K standalone port sessions on the CPU.

Port only: no JAX program is compiled.  The weights are the golden decode's
(tests/fixtures/golden_params_777.npz, a flax init carried in with
``load_flax_params``) on its world (2 scans x 20 nodes, features 24, T 8,
gmap 24, 48-token instructions).  Decisions, stops and final trajectories
are compared exactly; frozen lanes bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vln_magic_tpu_torch.agent import serving
from vln_magic_tpu_torch.agent.rollout import Rollout
from vln_magic_tpu_torch.agent.serving import (NavFleet, NavServer,
                                               NavSession,
                                               observation_from_world)
from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig, ModelConfig,
                                        TrainConfig)
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

HERE = os.path.dirname(__file__)
INSTR_LEN = 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build_setup(device):
    """The golden world, its weights, six items and each item's standalone
    session run on ``device``."""
    world = make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                 seed=777)
    cfg = MagicConfig(
        model=ModelConfig(vocab_size=400, hidden_size=64,
                          num_attention_heads=2, num_l_layers=2,
                          num_pano_layers=1, num_x_layers=2,
                          image_feat_size=24, max_position_embeddings=64),
        env=EnvConfig(max_action_len=8, max_gmap_len=24,
                      max_instr_len=INSTR_LEN, observed_graph_parity=True),
        train=TrainConfig(batch_size=1))
    params = dict(np.load(os.path.join(HERE, "fixtures",
                                       "golden_params_777.npz")))
    rng = np.random.default_rng(5)
    items = make_synthetic_instructions(world, 6, rng, vocab_size=400,
                                        min_path=3, max_path=6)
    for it in items:
        it["instr_encoding"] = rng.integers(4, 400, INSTR_LEN).astype(np.int32)
    s = {"world": world, "cfg": cfg, "params": params, "items": items,
         "n": world.tables.max_nodes, "c": world.tables.max_candidates,
         "device": device}
    server = NavServer(cfg, params, max_nodes=s["n"], max_cands=s["c"],
                       device=device)
    s["server"] = server
    s["ref"] = [serve(s, server.new_session(it["instr_encoding"]), it)
                for it in items]
    return s


@pytest.fixture(scope="module")
def setup():
    return build_setup("cpu")


def fleet(s, slots, **kw):
    return NavFleet(s["cfg"], s["params"], slots=slots, max_nodes=s["n"],
                    max_cands=s["c"], device=s["device"], **kw)


def obs_at(s, item, v):
    return observation_from_world(s["world"], item["scan_idx"], v,
                                  float(item["heading"]))


def serve(s, sess, item, cur=None, steps=8):
    """Drive ``sess`` from ``cur`` (default the item's start) to its stop:
    (world-index actions, -1 for a stop; ``finish()``'s record)."""
    g = s["world"].graphs[item["scan_idx"]]
    cur = int(item["path_idx"][0]) if cur is None else cur
    actions = []
    for _ in range(steps):
        dec = sess.step(obs_at(s, item, cur))
        if dec.target is not None:
            cur = g.index[dec.target]
        actions.append(-1 if dec.target is None else cur)
        if dec.stop:
            break
    return actions, sess.finish()


def multi_step(s):
    """(index, item) of an episode that moves at step 0 and runs >= 2
    decisions."""
    for i, (it, (actions, _)) in enumerate(zip(s["items"], s["ref"])):
        if len(actions) >= 2 and actions[0] >= 0:
            return i, it
    pytest.fail("no multi-step episode in the fixture items")


def test_fleet_equals_standalone_sessions(setup):
    """Six episodes over a fleet of 4 warmed up at its 4 lanes, joining at
    different ticks
    (per-lane episode start and step clocks), each slot released and
    claimed again when its episode ends: decisions, stops and final
    trajectories equal the standalone sessions'."""
    f = fleet(setup, 4)
    f.warmup()
    fleet_equals_standalone(setup, f)


def fleet_equals_standalone(s, f):
    """Serve the six items on the fleet ``f`` and hold each item's
    decisions, stops and final trajectory to its standalone session's;
    returns (ticks, finishes)."""
    queue = list(range(len(s["items"])))
    live, cur, actions, finals = {}, {}, {}, {}
    tick = 0
    while queue or live:
        if queue and len(live) < f.k and (tick % 2 == 0 or not live):
            i = queue.pop(0)
            sess = f.join(s["items"][i]["instr_encoding"])
            live[sess.slot] = i
            cur[i], actions[i] = int(s["items"][i]["path_idx"][0]), []
        decisions = f.step({slot: obs_at(s, s["items"][i], cur[i])
                            for slot, i in live.items()})
        for slot, dec in decisions.items():
            i = live[slot]
            g = s["world"].graphs[s["items"][i]["scan_idx"]]
            if dec.target is not None:
                cur[i] = g.index[dec.target]
            actions[i].append(-1 if dec.target is None else cur[i])
            if dec.stop:
                finals[i] = f.finish(slot)
                f.release(slot)
                del live[slot]
        tick += 1
    for i, (want, final) in enumerate(s["ref"]):
        assert actions[i] == want, i
        assert finals[i] == final, i
    return tick, len(finals)


def test_frozen_lanes_come_back_bit_for_bit(setup):
    """A tick in which only slot 1 submits leaves every state field and the
    feature bank of slots 0 and 2 as they were."""
    s = setup
    f = fleet(s, 3)
    i, moving = multi_step(s)
    others = [it for j, it in enumerate(s["items"]) if j != i]
    items = [others[0], moving, others[1]]
    for it in items:
        f.join(it["instr_encoding"])
    f.step({i: obs_at(s, it, int(it["path_idx"][0]))
            for i, it in enumerate(items)})
    before = {fl.name: getattr(f._state, fl.name).clone()
              for fl in dataclasses.fields(f._state)
              if getattr(f._state, fl.name) is not None}
    bank = f._features.clone()
    sess = f._sessions[1]
    g = s["world"].graphs[moving["scan_idx"]]
    f.step({1: obs_at(s, moving, g.index[sess._names[sess._cur]])})
    changed = 0
    for name, was in before.items():
        now = getattr(f._state, name)
        for lane in (0, 2):
            assert torch.equal(now[lane], was[lane]), (name, lane)
        changed += not torch.equal(now[1], was[1])
    assert changed > 0
    for lane in (0, 2):
        assert torch.equal(f._features[lane], bank[lane])


def test_slot_reuse(setup):
    """A one-slot fleet serves two episodes in turn, each equal to its
    standalone run: nothing of the first leaks into the second."""
    s = setup
    f = fleet(s, 1)
    for it, want in zip(s["items"][:2], s["ref"][:2]):
        sess = f.join(it["instr_encoding"])
        assert serve(s, sess, it) == want
        f.release(sess.slot)


def test_fleet_save_restore_into_another_slot(setup, tmp_path):
    """A slot saved after one decision, restored into slot 1 of a fresh
    fleet (slot 0 taken, so ``state.scan`` is re-pointed), continues as the
    uninterrupted run."""
    s = setup
    i, it = multi_step(s)
    g = s["world"].graphs[it["scan_idx"]]
    f = fleet(s, 2)
    sess = f.join(it["instr_encoding"])
    dec = sess.step(obs_at(s, it, int(it["path_idx"][0])))
    path = str(tmp_path / "slot.blob")
    sess.save(path)
    f2 = fleet(s, 2)
    f2.join(s["items"][0]["instr_encoding"])     # never submits
    resumed = f2.restore_session(path)
    assert resumed.slot == 1
    first = g.index[dec.target]
    actions, final = serve(s, resumed, it, cur=first, steps=7)
    assert ([first] + actions, final) == s["ref"][i]


def test_blobs_move_between_a_fleet_and_a_server(setup, tmp_path):
    """One blob format: a fleet slot's blob resumes on a standalone server
    and a standalone session's in a fleet slot, with the same decisions."""
    s = setup
    i, it = multi_step(s)
    g = s["world"].graphs[it["scan_idx"]]
    start = obs_at(s, it, int(it["path_idx"][0]))
    for src, dst in (("fleet", "server"), ("server", "fleet")):
        if src == "fleet":
            sess = fleet(s, 1).join(it["instr_encoding"])
        else:
            sess = s["server"].new_session(it["instr_encoding"])
        first = g.index[sess.step(start).target]
        path = str(tmp_path / f"{src}.blob")
        sess.save(path)
        resumed = (NavSession.restore(s["server"], path) if dst == "server"
                   else fleet(s, 1).restore_session(path))
        actions, final = serve(s, resumed, it, cur=first, steps=7)
        assert ([first] + actions, final) == s["ref"][i], (src, dst)


def test_the_feature_guard_refuses_a_large_bank(setup):
    with pytest.raises(ValueError, match="max_feature_gb"):
        fleet(setup, 4, max_feature_gb=1e-6)


def test_a_pending_row_survives_save_release_and_a_failed_tick(setup,
                                                               tmp_path,
                                                               monkeypatch):
    """A row queued but not yet written (a tick that raised) keeps its
    place: a save folds it in, the bank is untouched, and the retried tick
    decides as the standalone session.  ``release`` drops a queued row, so
    it never reaches a slot claimed again."""
    s = setup
    i, it = multi_step(s)
    f = fleet(s, 1)
    sess = f.join(it["instr_encoding"])
    start = obs_at(s, it, int(it["path_idx"][0]))

    def broken(*a, **k):
        raise RuntimeError("tick failed")

    monkeypatch.setattr(f, "_tick", broken)
    with pytest.raises(RuntimeError, match="tick failed"):
        f.step({0: start})
    v, row = f._pending_rows[0]
    np.testing.assert_array_equal(row, start.pano_feats)
    assert not f._features[0, v].any()
    path = str(tmp_path / "pending.blob")
    sess.save(path)
    with np.load(path, allow_pickle=False) as blob:
        np.testing.assert_array_equal(blob["features"][0, v], row)
        assert not any(k.startswith("state.") for k in blob.files)
    monkeypatch.undo()
    g = s["world"].graphs[it["scan_idx"]]
    first = g.index[f.step({0: start})[0].target]
    assert f._pending_rows == {}
    assert serve(s, sess, it, cur=first, steps=7)[0] == s["ref"][i][0][1:]

    f.release(0)
    sess = f.join(s["items"][1]["instr_encoding"])
    sess._put_feature_row(2, np.full((36, 24), 7.5, np.float32))
    f.release(sess.slot)
    assert f._pending_rows == {}
    other = s["items"][1]
    f.join(other["instr_encoding"]).step(obs_at(s, other,
                                                int(other["path_idx"][0])))
    assert not (f._features[0] == 7.5).any()


def test_a_tick_makes_one_upload(setup, monkeypatch):
    """Every submitting lane's control values, mirrors and feature row go
    in one upload per tick, as the fleet docstring says."""
    s = setup
    f = fleet(s, 3)
    items = s["items"][:3]
    for it in items:
        f.join(it["instr_encoding"])
    uploads = []
    real = NavServer._upload
    monkeypatch.setattr(NavServer, "_upload",
                        lambda self, host: uploads.append(host.shape)
                        or real(self, host))
    f.step({i: obs_at(s, it, int(it["path_idx"][0]))
            for i, it in enumerate(items)})
    assert uploads == [(3, len(serving.CTL) + int(f._off[-1]) + 36 * 24)]


def count_language(monkeypatch, f):
    """Record the batch of every ``model.language`` call the fleet makes."""
    batches = []
    real = f.model.language
    monkeypatch.setattr(f.model, "language",
                        lambda ids, *a, **k: batches.append(ids.shape[0])
                        or real(ids, *a, **k))
    return batches


def assert_slot_encodes(f, slot, instr):
    """The slot's text, mask and hoisted K/V rows equal the batch-1 encode
    of ``instr`` that a standalone session on the fleet's model makes."""
    emb, mask, kv = f.new_session(instr).fleet._txt
    txt_buf, mask_buf, kv_buf = f._txt
    torch.testing.assert_close(txt_buf[slot], emb[0], rtol=0, atol=0)
    assert torch.equal(mask_buf[slot], mask[0])
    rows = []
    serving._map_kv(kv_buf, lambda buf, x: rows.append((buf[slot], x[0])),
                    kv)
    assert rows
    for got, want in rows:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_joins_are_encoded_once_in_the_next_tick(setup, monkeypatch):
    """Three joins encode nothing; the tick after them makes one
    ``language`` call at batch 3, and each slot's text, mask and K/V rows
    equal a batch-1 encode of its instruction."""
    s = setup
    f = fleet(s, 4)
    batches = count_language(monkeypatch, f)
    items = s["items"][:3]
    for it in items:
        f.join(it["instr_encoding"])
    assert batches == [] and sorted(f._pending_instr) == [0, 1, 2]
    f.step({i: obs_at(s, it, int(it["path_idx"][0]))
            for i, it in enumerate(items)})
    assert batches == [3] and f._pending_instr == {}
    f.step({})
    assert batches == [3]
    for slot, it in enumerate(items):
        assert_slot_encodes(f, slot, it["instr_encoding"])


def test_a_released_join_is_not_encoded(setup, monkeypatch):
    """A join, a release and a join of the same slot before a tick encode
    only the last instruction, which then decides as its standalone
    session."""
    s = setup
    f = fleet(s, 1)
    batches = count_language(monkeypatch, f)
    f.join(s["items"][0]["instr_encoding"])
    f.release(0)
    assert f._pending_instr == {}
    it = s["items"][1]
    sess = f.join(it["instr_encoding"])
    assert serve(s, sess, it) == s["ref"][1]
    assert batches == [1]
    assert_slot_encodes(f, 0, it["instr_encoding"])


def test_a_rejected_tick_keeps_the_pending_encodings(setup, monkeypatch):
    """A tick that rejects a submission encodes nothing and keeps every
    pending instruction; the next good tick encodes them all in one batch
    and decides as the standalone sessions."""
    s = setup
    f = fleet(s, 2)
    batches = count_language(monkeypatch, f)
    items = s["items"][:2]
    for it in items:
        f.join(it["instr_encoding"])
    bad = dataclasses.replace(obs_at(s, items[1],
                                     int(items[1]["path_idx"][0])),
                              pano_feats=np.zeros((36, 5), np.float32))
    with pytest.raises(ValueError, match="pano_feats"):
        f.step({0: obs_at(s, items[0], int(items[0]["path_idx"][0])),
                1: bad})
    assert batches == [] and sorted(f._pending_instr) == [0, 1]
    decisions = f.step({i: obs_at(s, it, int(it["path_idx"][0]))
                        for i, it in enumerate(items)})
    assert batches == [2] and f._pending_instr == {}
    g = [s["world"].graphs[it["scan_idx"]] for it in items]
    for i in range(2):
        target = decisions[i].target
        assert (-1 if target is None else g[i].index[target]) \
            == s["ref"][i][0][0]


def count_step_batches(monkeypatch):
    """Record the batch of every ``Rollout.step`` call."""
    batches = []
    real = Rollout.step
    monkeypatch.setattr(Rollout, "step",
                        lambda self, state, *a, **k:
                        batches.append(state.batch_size)
                        or real(self, state, *a, **k))
    return batches


def test_warmup_ticks_at_the_fleet_batch_and_frees_its_slot(setup,
                                                           monkeypatch):
    """``NavFleet.warmup`` makes its two decisions through the fleet's own
    tick at its K lanes and leaves every slot free, with nothing queued."""
    f = fleet(setup, 3)
    batches = count_step_batches(monkeypatch)
    f.warmup()
    assert batches == [3, 3]
    assert f._sessions == {} and f._pending_rows == {}
    assert f._pending_instr == {}


def test_a_server_session_decides_through_the_fleet_tick(setup, monkeypatch):
    """A ``NavServer`` session's decisions go through ``NavFleet._tick``,
    the one decision path, at batch 1, and equal its unwrapped run."""
    s = setup
    ticks, batches = [], count_step_batches(monkeypatch)
    real = NavFleet._tick
    monkeypatch.setattr(NavFleet, "_tick",
                        lambda self, buf, *a: ticks.append(buf.shape[0])
                        or real(self, buf, *a))
    it = s["items"][0]
    assert serve(s, s["server"].new_session(it["instr_encoding"]), it) \
        == s["ref"][0]
    n = len(s["ref"][0][0])
    assert ticks == [1] * n and batches == [1] * n


def test_a_tick_that_fails_after_its_upload_changes_no_decision(setup,
                                                                monkeypatch):
    """Three episodes on a fleet of 3 whose second tick raises after its
    upload (the upload buffer may still be in a copy): the tick retried
    with the same observations, and every one after it, decide as the
    uninterrupted standalone sessions."""
    s = setup
    f = fleet(s, 3)
    items = s["items"][:3]
    cur = {slot: int(it["path_idx"][0]) for slot, it in enumerate(items)}
    actions, finals = {slot: [] for slot in cur}, {}
    for slot, it in enumerate(items):
        f.join(it["instr_encoding"])
    tick = 0
    while len(finals) < 3:
        sub = {slot: obs_at(s, items[slot], cur[slot]) for slot in cur
               if slot not in finals}
        if tick == 1:
            monkeypatch.setattr(f, "_tick", lambda *a: 1 / 0)
            with pytest.raises(ZeroDivisionError):
                f.step(sub)
            monkeypatch.undo()
        for slot, dec in f.step(sub).items():
            g = s["world"].graphs[items[slot]["scan_idx"]]
            if dec.target is not None:
                cur[slot] = g.index[dec.target]
            actions[slot].append(-1 if dec.target is None else cur[slot])
            if dec.stop:
                finals[slot] = f.finish(slot)
        tick += 1
    assert tick > 1
    for slot in cur:
        assert (actions[slot], finals[slot]) == s["ref"][slot], slot


def empty_row(f):
    """The upload row of a slot that holds nothing: zeros, candidate ids
    -1 and the trash row's index ``n`` as the feature row."""
    row = np.zeros(len(serving.CTL) + int(f._off[-1]) + 36 * f.d,
                   np.float32)
    at = len(serving.CTL) + f._off
    row[at[2]:at[3]] = -1
    row[serving.FEAT_V] = f.n
    return row


def test_a_released_slot_and_its_next_session_start_from_the_empty_row(setup):
    """A slot's upload row after a decision, a finish and a release, and
    after a new session joins it, is the empty row, bit for bit; a slot
    never claimed holds it too."""
    s = setup
    f = fleet(s, 2)
    it = s["items"][0]
    sess = f.join(it["instr_encoding"])
    sess.step(obs_at(s, it, int(it["path_idx"][0])))
    f.finish(0)
    assert (f._rows[0] != empty_row(f)).any()
    f.release(0)
    np.testing.assert_array_equal(f._rows[0].view(np.int32),
                                  empty_row(f).view(np.int32))
    assert f.join(s["items"][1]["instr_encoding"]).slot == 0
    for slot in (0, 1):
        np.testing.assert_array_equal(f._rows[slot].view(np.int32),
                                      empty_row(f).view(np.int32))


def test_a_blob_keeps_the_mirror_dtypes_and_shapes(setup, tmp_path):
    """A saved session's mirrors keep the blob format: f32 positions,
    distances and candidate distance, heading and elevation tables, int32
    candidate ids and views, at [n, 3], [n, n] and [n, c]; the ids equal
    the slot's row."""
    s = setup
    it = s["items"][0]
    sess = fleet(s, 2).join(it["instr_encoding"])
    sess.step(obs_at(s, it, int(it["path_idx"][0])))
    path = str(tmp_path / "dtypes.blob")
    sess.save(path)
    n, c = s["n"], s["c"]
    want = {"pos": (np.float32, (n, 3)), "dist": (np.float32, (n, n)),
            "cand_ids": (np.int32, (n, c)), "cand_dist": (np.float32, (n, c)),
            "cand_view": (np.int32, (n, c)),
            "cand_heading": (np.float32, (n, c)),
            "cand_elev": (np.float32, (n, c))}
    with np.load(path, allow_pickle=False) as blob:
        got = {k[len("mirrors."):]: blob[k] for k in blob.files
               if k.startswith("mirrors.")}
        assert {k: (v.dtype, v.shape) for k, v in got.items()} == want
        assert (got["cand_ids"] >= 0).any()
        np.testing.assert_array_equal(got["cand_ids"],
                                      sess._mirrors()["cand_ids"])
