"""The port's causal interventions (vln_magic_tpu_torch.agent.interventions,
``ZdictAttention`` and the five intervention heads of
``models.vlnbert.DualScaleVLNBert``) held against vln_magic_tpu's on the
same numpy inputs and weights: ``WordPicker`` and the TSV layouts byte for
byte, ``update_backdoor_dict`` (keys and p(z) exact, features to 1e-5),
``build_rollout_zdicts``, ``extract_cfp_features`` (1e-5), ``kmeans``
against scikit-learn's ``KMeans`` (labels equal) and the frontdoor picks,
each head and model mode after a strict load of JAX's weights (1e-5), a
decode with the student's dictionaries (actions equal), and one
``compute_grads`` with dictionaries in both roles (the objective to 1e-5,
gradient leaves to 1e-4 of their largest magnitude, as
tests/test_torch_trainer.py).  The port's streaming, serving and
``Trainer.zdicts`` default are held to its own waves and explicit calls.

The golden fixture ``tests/fixtures/golden_interventions_5.npz`` (JAX's
weights of a small MAGIC-S with all five heads, the dictionaries, one
navigation batch's fused logits and the decode's actions) is what
``chip_smoke.py`` holds the card to; rewrite it with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_interventions.py``.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from test_torch_trainer import (GOLDEN, _check_grads, golden_config,
                                golden_items)
from test_torch_train_rollout import random_flax_params
from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent import interventions as J
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.agent.navigator import Navigator as JaxNavigator
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.env.synthetic import make_synthetic_instructions
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.models.vlnbert import ZdictAttention as FlaxZdict
from vln_magic_tpu.pretrain.tasks import PathDataBuilder as JaxBuilder
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import interventions as P
from vln_magic_tpu_torch.agent import trainer as port_trainer
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.serving import NavServer
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import (
    make_synthetic_instructions as port_instructions)
from vln_magic_tpu_torch.models.vlnbert import (DualScaleVLNBert,
                                                ZdictAttention)
from vln_magic_tpu_torch.pretrain.tasks import PathDataBuilder
from vln_magic_tpu_torch.utils.weights import (load_flax_params,
                                               load_trainer_params)

TOL = 1e-5
SPEC = chip_smoke.GOLDEN_INTERVENTIONS_SPEC
FIXTURE = chip_smoke.INTERVENTIONS_FIXTURE
HEADS = dict(do_back_txt=True, do_back_img=True, do_front_txt=True,
             do_front_img=True, do_front_his=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.integer):
        return torch.from_numpy(x.astype(np.int64))
    return torch.from_numpy(x.copy())


def close(want, got, what, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    diff = float(np.max(np.abs(want - got))) if want.size else 0.0
    assert diff < tol, f"{what}: max abs diff {diff}"


# ---- the golden configuration: world, items, weights, dictionaries -------

def golden_cfg(module):
    return chip_smoke.interventions_config(module, SPEC)


def golden_run():
    """Both packages' world, items, navigators (JAX's weights) and the
    dictionaries; and JAX's decode with them, shared by the parity test and
    the fixture's freshness test."""
    jw = jax_world(**SPEC["world"])
    pw = make_synthetic_world(**SPEC["world"])
    items = make_synthetic_instructions(
        jw, rng=np.random.default_rng(SPEC["seed"]), **SPEC["items"])
    jc, pc = golden_cfg(jcfg), golden_cfg(tcfg)
    params = random_flax_params(jc.model, SPEC["seed"])
    flat = {k: np.asarray(v, np.float32)
            for k, v in flatten_params(params).items()}
    zd = chip_smoke.interventions_zdicts(SPEC)
    jnav = JaxNavigator(jc, jw, params=params)
    _, aux = jnav.run_items(items, zdicts={"student": zd})
    return {"jw": jw, "pw": pw, "items": items, "jc": jc, "pc": pc,
            "params": params, "flat": flat, "zd": zd, "jnav": jnav,
            "actions": np.asarray(aux["actions"])}


@pytest.fixture(scope="module")
def golden():
    return golden_run()


def golden_arrays(g) -> dict:
    """What the fixture holds: the spec, the weights, the dictionaries,
    one navigation batch with its fused logits, and the decode's actions."""
    out = {"spec": np.asarray(json.dumps(SPEC)),
           "actions": g["actions"].astype(np.int64)}
    out.update({f"params/{k}": v for k, v in g["flat"].items()})
    out.update({f"zd/{k}": v for k, v in P.flat_zdicts(
        g["zd"]).items()})
    x = chip_smoke.interventions_nav_inputs(g["jc"].model, SPEC)
    out.update({f"nav/{k}": v for k, v in x.items()})
    b = x["txt_masks"].shape[0]
    zb = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(a, (b,) + a.shape), g["zd"])
    outs = jax.jit(FlaxModel(g["jc"].model).apply,
                   static_argnames=("method",))(
        g["params"], *[x[k] for k in chip_smoke.NAV_ARGS],
        front_vp_feats=zb["front_vp_feats"],
        front_gmap_feats=zb["front_gmap_feats"],
        method=FlaxModel.navigation)
    out["fused_logits"] = np.asarray(outs["fused_logits"], np.float32)
    return out


def test_golden_fixture_is_a_fresh_jax_run(golden):
    """tests/fixtures/golden_interventions_5.npz: JAX's weights,
    dictionaries, fused logits and actions, which chip_smoke.py's phase 14
    and tests/test_torch_interventions_cuda.py hold the card to."""
    fixture = dict(np.load(FIXTURE))
    fresh = golden_arrays(golden)
    assert sorted(fixture) == sorted(fresh)
    assert json.loads(str(fixture["spec"])) == SPEC
    for k, v in fresh.items():
        if k == "fused_logits":     # computed: XLA's CPU code may round otherwise
            np.testing.assert_allclose(fixture[k], v, rtol=0, atol=1e-6)
        elif k != "spec":
            np.testing.assert_array_equal(fixture[k], v, err_msg=k)
    assert os.path.getsize(FIXTURE) < 2 * 2 ** 20


def test_golden_check_passes_on_the_cpu(golden):
    """chip_smoke.py's check of the fixture (logits within 1e-5, actions
    equal) through the port on the CPU."""
    got = chip_smoke.golden_interventions("cpu")
    assert got["actions_equal"] and got["max_abs_err"] < TOL


def test_decode_with_student_dicts_matches_jax(golden):
    nav = Navigator(golden["pc"], golden["pw"], params=golden["flat"],
                    device="cpu")
    _, aux = nav.run_items(golden["items"], zdicts={"student": golden["zd"]})
    np.testing.assert_array_equal(aux["actions"].numpy(), golden["actions"])
    # the dictionaries matter: without them the decode differs
    _, plain = nav.run_items(golden["items"])
    assert not np.array_equal(plain["actions"].numpy(), golden["actions"])


def test_stream_with_dicts_equals_waves(golden):
    nav = Navigator(golden["pc"], golden["pw"], params=golden["flat"],
                    device="cpu")
    zd = {"student": golden["zd"]}
    items = golden["items"]
    (_, _), waves = nav.evaluate(items, batch_size=2, stream=False,
                                 zdicts=zd)
    (_, _), stream = nav.evaluate(items, batch_size=2, stream=True,
                                  zdicts=zd)
    assert [p["trajectory"] for p in stream] == \
        [p["trajectory"] for p in waves]


def test_serving_with_dicts_equals_the_parity_wave(golden, tmp_path):
    """A ``NavServer`` session with the student's dictionaries gives the
    offline parity decode's targets; its bundle keeps them
    (``zdicts_baked``) and serves the same."""
    pc = dataclasses.replace(golden["pc"], env=dataclasses.replace(
        golden["pc"].env, observed_graph_parity=True))
    zd = {"student": golden["zd"]}
    world, items = golden["pw"], golden["items"]
    nav = Navigator(pc, world, params=golden["flat"], device="cpu")
    _, aux = nav.run_items(items, zdicts=zd)
    want = aux["actions"].numpy().T.tolist()
    assert any(a >= 0 for row in want for a in row)           # it moves
    server = NavServer(pc, golden["flat"], device="cpu", zdicts=zd)
    server.export_bundle(str(tmp_path / "b"))
    meta = json.loads((tmp_path / "b" / "meta.json").read_text())
    assert meta["zdicts_baked"]
    with pytest.raises(TypeError):
        NavServer.from_bundle(str(tmp_path / "b"), device="cpu", zdicts=zd)
    for srv in (server, NavServer.from_bundle(str(tmp_path / "b"),
                                              device="cpu")):
        for item, row in zip(items, want):
            got, _ = chip_smoke.served(world, srv.new_session(
                item["instr_encoding"]), item, len(row))
            assert got == row[:len(got)]
            assert all(a == -1 for a in row[len(got):])


# ---- word picking and the TSV layouts -------------------------------------

WORDS = "Walk forward past the Table, then turn left into the kitchen!".split()


@pytest.mark.parametrize("cat", [False, True])
def test_word_picker_matches_jax(tmp_path, cat):
    cat_file = None
    if cat:
        cat_file = str(tmp_path / "cats.tsv")
        (tmp_path / "cats.tsv").write_text("category\tx\ntable\t1\nKitchen\t2\n")
    got = P.WordPicker(cat_file=cat_file).pick(WORDS)
    want = J.WordPicker(cat_file=cat_file).pick(WORDS)
    assert got == want and got[1]


def _zdicts(module, rng, dim=6):
    return {kind: module.Zdict(rng.standard_normal((n, dim)).astype(
        np.float32), rng.random(n), [f"w{i}" for i in range(n)])
        for kind, n in (("direction", 3), ("landmark", 4))}


@pytest.mark.parametrize("layout", ["zdict", "backdoor", "cfp"])
def test_tsv_layouts_match_jax_byte_for_byte(tmp_path, layout):
    rng = np.random.default_rng(3)
    paths = {m: str(tmp_path / f"{m.__name__.split('.')[0]}.tsv")
             for m in (J, P)}
    if layout == "zdict":
        for m in (J, P):
            _zdicts(m, np.random.default_rng(3))["direction"].save_tsv(
                paths[m])
        got = P.Zdict.load_tsv(paths[J], 6)
        want = J.Zdict.load_tsv(paths[P], 6)
        assert got.keys == want.keys
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.pzs, want.pzs)
        for g, w in zip(got.as_batch(2), want.as_batch(2)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    elif layout == "backdoor":
        for m in (J, P):
            m.save_backdoor_tsv(paths[m], _zdicts(m, np.random.default_rng(3)))
        got, want = (P.load_backdoor_tsv(paths[J], 6),
                     J.load_backdoor_tsv(paths[P], 6))
        for kind in want:
            assert got[kind].keys == want[kind].keys
            np.testing.assert_array_equal(got[kind].features,
                                          want[kind].features)
            np.testing.assert_array_equal(got[kind].pzs, want[kind].pzs)
    else:
        feats = {k: rng.standard_normal((5, 6)).astype(np.float32)
                 for k in ("txt", "gmap", "vp")}
        ids = [f"{i}_0" for i in range(5)]
        for m in (J, P):
            m.save_cfp_tsv(paths[m], feats, ids)
        (got, gids), (want, wids) = (P.load_cfp_tsv(paths[J], 6),
                                     J.load_cfp_tsv(paths[P], 6))
        assert gids == wids == ids
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with open(paths[J], "rb") as a, open(paths[P], "rb") as b:
        assert a.read() == b.read()


def test_reference_rows_without_kind_are_classified(tmp_path):
    """Reference-written instr dicts have no ``kind:`` prefix: direction
    words go to 'direction', the rest to 'landmark', as JAX's."""
    path = str(tmp_path / "ref.tsv")
    z = P.Zdict(np.ones((3, 4), np.float32), np.array([0.2, 0.3, 0.5]),
                ["left", "table", "stop"])
    z.save_tsv(path)
    got, want = P.load_backdoor_tsv(path, 4), J.load_backdoor_tsv(path, 4)
    assert got["direction"].keys == want["direction"].keys == ["left", "stop"]
    assert got["landmark"].keys == want["landmark"].keys == ["table"]


@pytest.mark.parametrize("pad", [0, 4, 81])
def test_build_rollout_zdicts_matches_jax(pad):
    front = {k: np.random.default_rng(1).standard_normal((4, 6)).astype(
        np.float32) for k in ("txt", "vp", "gmap")}
    got = P.build_rollout_zdicts(_zdicts(P, np.random.default_rng(2)),
                                 front, pad_entries=pad)
    want = J.build_rollout_zdicts(_zdicts(J, np.random.default_rng(2)),
                                  front, pad_entries=pad)
    got, want = P.flat_zdicts(got), P.flat_zdicts(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if pad:
        assert got["instr_zdict.direction_pzs"].shape == (pad, 1)
        assert not got["instr_zdict.direction_pzs"][3:].any()


# ---- the dictionaries from the model ---------------------------------------

@pytest.fixture(scope="module")
def small():
    """A small navigator pair (kd heads on, so the CFP features take the
    projection heads) on the golden world, JAX's weights."""
    jc = dataclasses.replace(golden_cfg(jcfg), model=jcfg.ModelConfig(
        **{**SPEC["model"], **{k: False for k in HEADS}}))
    pc = tcfg.config_from_dict(jcfg.config_to_dict(jc))
    params = random_flax_params(jc.model, 4)
    flat = flatten_params(params)
    jw, pw = jax_world(**SPEC["world"]), make_synthetic_world(**SPEC["world"])
    items = make_synthetic_instructions(jw, 40, np.random.default_rng(8),
                                        vocab_size=200, min_path=2,
                                        max_path=5)
    return {"jnav": JaxNavigator(jc, jw, params=params),
            "pnav": Navigator(pc, pw, params=flat, device="cpu"),
            "jw": jw, "pw": pw, "jc": jc, "pc": pc, "items": items}


def test_update_backdoor_dict_matches_jax(small):
    got = P.update_backdoor_dict(small["pnav"], small["items"],
                                 P.WordPicker(), batch_size=16)
    want = J.update_backdoor_dict(small["jnav"], small["items"],
                                  J.WordPicker(), batch_size=16)
    for kind in ("direction", "landmark"):
        assert got[kind].keys == want[kind].keys and got[kind].keys
        np.testing.assert_array_equal(got[kind].pzs, want[kind].pzs)
        close(want[kind].features, got[kind].features, kind)


def _builders(s):
    kw = dict(max_steps=s["jc"].env.max_action_len + 1,
              max_gmap=s["jc"].env.max_gmap_len,
              max_txt=s["jc"].env.max_instr_len,
              vocab_size=s["jc"].model.vocab_size, seed=0)
    return JaxBuilder(s["jw"], **kw), PathDataBuilder(s["pw"], **kw)


@pytest.fixture(scope="module")
def cfp(small):
    jb, pb = _builders(small)
    got = P.extract_cfp_features(small["pnav"], small["items"], pb,
                                 batch_size=16)
    want = J.extract_cfp_features(small["jnav"], small["items"], jb,
                                  batch_size=16)
    return got, want


def test_extract_cfp_features_matches_jax(cfp):
    (got, gids), (want, wids) = cfp
    assert gids == wids
    for k in ("txt", "gmap", "vp"):
        assert got[k].shape == (40, SPEC["model"]["kd_target_size"])
        close(want[k], got[k], k)


@pytest.mark.parametrize("k", [4, 24])
@pytest.mark.parametrize("data", ["cfp", "random768"])
def test_kmeans_labels_equal_sklearn(cfp, data, k):
    from sklearn.cluster import KMeans

    if data == "cfp":
        sets = cfp[1][0].values()
    else:
        x = np.random.default_rng(k).standard_normal((200, 768))
        sets = [x.astype(np.float32)]
    for x in sets:
        n = min(k, len(x))
        want = KMeans(n_clusters=n, n_init=4, random_state=0).fit(x).labels_
        got, centers = P.kmeans(x, n, seed=0)
        np.testing.assert_array_equal(got, want)
        assert centers.shape == (n, x.shape[1])


def test_random_pick_front_features_matches_jax(cfp):
    feats = cfp[1][0]
    got = P.KMeansPicker(feats, 6, seed=2).random_pick_front_features(
        np.random.default_rng(9))
    want = J.KMeansPicker(feats, 6, seed=2).random_pick_front_features(
        np.random.default_rng(9))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---- ZdictAttention and the heads ------------------------------------------

@pytest.mark.parametrize("priors", [True, False])
@pytest.mark.parametrize("method", ["add", "door"])
def test_zdict_attention_matches_jax(method, priors):
    cfg = jcfg.ModelConfig(hidden_size=32, num_attention_heads=2,
                           do_add_method=method)
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, z = f(3, 7, 32), f(3, 6, 20)
    pzs = rng.random((3, 6, 1)).astype(np.float32)
    pzs[:, -2:] = 0.0                    # padded rows: p(z) = 0
    flax_mod = FlaxZdict(cfg)
    params = flax_mod.init(jax.random.PRNGKey(0), x, z, pzs)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        + (1.0 if a.ndim == 1 and a.shape[0] == 32 else 0.0), params)
    mod = ZdictAttention(tcfg.ModelConfig(**dataclasses.asdict(cfg)), 20)
    load_flax_params(mod, flatten_params(params))
    p = pzs if priors else None
    want = flax_mod.apply(params, x, z, p)
    got = mod(t(x), t(z), None if p is None else t(p))
    close(want, got, "zdict attention")
    assert hasattr(mod, "gate") == (method == "door")


@pytest.fixture(scope="module")
def heads_pair():
    jc = golden_cfg(jcfg).model
    params = random_flax_params(jc, 6)
    model = DualScaleVLNBert(golden_cfg(tcfg).model, device="cpu")
    load_flax_params(model, flatten_params(params))      # strict
    return jc, params, model


def _batched(zd, b):
    return jax.tree_util.tree_map(
        lambda a: np.broadcast_to(a, (b,) + a.shape).copy(), zd)


@pytest.mark.parametrize("mode", ["language", "panorama", "navigation",
                                  "extract_cfp"])
def test_modes_with_all_heads_match_jax(heads_pair, mode):
    jc, params, model = heads_pair
    x = chip_smoke.interventions_nav_inputs(jc, SPEC)
    b = x["txt_masks"].shape[0]
    zd = _batched(chip_smoke.interventions_zdicts(SPEC), b)
    tz = jax.tree_util.tree_map(t, zd)
    fm = jax.jit(FlaxModel(jc).apply, static_argnames=("method",))
    apply = lambda *a, **k: fm(params, *a, method=getattr(
        FlaxModel, mode), **k)
    if mode == "language":
        want, _ = apply(x["txt_ids"], x["txt_masks"],
                        instr_zdict=zd["instr_zdict"],
                        front_txt_feats=zd["front_txt_feats"])
        got, _ = model.language(t(x["txt_ids"]), t(x["txt_masks"]),
                                instr_zdict=tz["instr_zdict"],
                                front_txt_feats=tz["front_txt_feats"])
        close(want, got, mode)
    elif mode == "panorama":
        keys = ("view_img_fts", "loc_fts", "nav_types", "pano_masks")
        want = apply(*[x[k] for k in keys], z_img_feats=zd["z_img_feats"],
                     z_img_pzs=zd["z_img_pzs"])
        got = model.panorama(*[t(x[k]) for k in keys],
                             z_img_feats=tz["z_img_feats"],
                             z_img_pzs=tz["z_img_pzs"])
        close(want[0], got[0], "pano_embeds")
        close(want[1], got[1], "pano_fused")
    else:
        want = fm(params, *[x[k] for k in chip_smoke.NAV_ARGS],
                        front_vp_feats=zd["front_vp_feats"],
                        front_gmap_feats=zd["front_gmap_feats"],
                        method=FlaxModel.navigation)
        got = model.navigation(*[t(x[k]) for k in chip_smoke.NAV_ARGS],
                               front_vp_feats=tz["front_vp_feats"],
                               front_gmap_feats=tz["front_gmap_feats"])
        if mode == "navigation":
            for k in ("gmap_embeds", "vp_embeds", "fused_logits",
                      "cls_embeds"):
                close(want[k], got[k], k)
        else:
            want = apply(x["txt_embeds"], want["gmap_embeds"],
                         want["vp_embeds"])
            got = model.extract_cfp(t(x["txt_embeds"]), got["gmap_embeds"],
                                    got["vp_embeds"])
            for k in ("txt", "gmap", "vp"):
                close(want[k], got[k], k)


# ---- training ----------------------------------------------------------------

def _train_spec():
    """tests/test_torch_trainer.py's golden spec with all five heads in
    both roles; one (imitation) rollout keeps JAX's compile short."""
    s = json.loads(json.dumps(GOLDEN))
    s["model"].update(HEADS)
    s["train"]["train_alg"] = "imitation"
    return s


def _train_zdicts(spec, seed):
    """Random dictionaries of each role at its widths: backdoor rows
    padded to 6 (p 0), four frontdoor rows at the CFP width."""
    rng = np.random.default_rng(seed)
    out = {}
    for role, d, front in (
            ("student", spec["model"]["hidden_size"],
             spec["model"]["kd_target_size"]),
            ("teacher", spec["teacher_model"]["hidden_size"],
             spec["teacher_model"]["kd_target_size"])):
        back = {k: J.Zdict(rng.standard_normal((n, d)).astype(np.float32),
                           rng.random(n) + 0.1)
                for k, n in (("direction", 3), ("landmark", 4))}
        feats = {k: rng.standard_normal((4, front)).astype(np.float32)
                 for k in ("txt", "vp", "gmap")}
        out[role] = J.build_rollout_zdicts(back, feats, pad_entries=6)
    return out


@pytest.fixture(scope="module")
def train_pair():
    """JAX's and the port's trainer on tests/test_torch_trainer.py's golden
    spec with all five heads in both roles, and JAX's ``compute_grads``
    with dictionaries in both roles (the slice's one compile of it)."""
    spec = _train_spec()
    jw = jax_world(**spec["world"])
    # the trainer's jitted flax init is half of the fixture's time: its
    # parameters come from the shapes alone, filled from numpy instead
    orig, rng = FlaxModel.init, np.random.default_rng(11)

    def init(self, key, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(orig, self), key, *args,
                                **kwargs)
        return jax.tree_util.tree_map_with_path(
            lambda path, s: jnp.asarray(
                0.05 * rng.standard_normal(s.shape).astype(np.float32)
                + (path[-1].key == "scale")), shapes)

    FlaxModel.init = init
    try:
        jt = jax_trainer.Trainer(golden_config(jcfg, spec), jw)
    finally:
        FlaxModel.init = orig
    zd = _train_zdicts(spec, 3)
    loss, (g, tg) = jt.compute_grads(golden_items(jw, spec),
                                     jax.random.PRNGKey(spec["seed"]),
                                     zdicts=zd)
    pw = make_synthetic_world(**spec["world"])
    pt = port_trainer.Trainer(golden_config(tcfg, spec), pw, device="cpu")
    load_trainer_params(pt, flatten_params(jt.params),
                        flatten_params(jt.t_params),
                        flatten_params(jt.critic_params))
    return {"spec": spec, "zd": zd, "loss": float(loss),
            "grads": {"params": flatten_params(g),
                      "t_params": flatten_params(tg)},
            "port": pt, "items": golden_items(pw, spec,
                                              make=port_instructions)}


def test_compute_grads_with_dicts_matches_jax(train_pair):
    tp = train_pair
    loss, grads = tp["port"].compute_grads(tp["items"],
                                           seed=tp["spec"]["seed"],
                                           zdicts=tp["zd"])
    np.testing.assert_allclose(loss.item(), tp["loss"], rtol=TOL)
    _check_grads(grads, tp["grads"], "compute_grads with dicts")
    # every head of both roles takes a gradient
    for part in ("params", "t_params"):
        for name in ("txt_backdoor_direction", "txt_frontdoor",
                     "vp_frontdoor", "gmap_frontdoor"):
            g = grads[part][f"params.{name}.z_proj.kernel"]
            assert float(g.abs().max()) > 0, (part, name)


def test_trainer_defaults_to_its_own_dicts(train_pair):
    tp = train_pair
    tr = tp["port"]
    explicit, _ = tr.compute_grads(tp["items"], seed=1, zdicts=tp["zd"])
    tr.zdicts = tp["zd"]
    try:
        default, _ = tr.compute_grads(tp["items"], seed=1)
        none, _ = tr.compute_grads(tp["items"], seed=1, zdicts={})
    finally:
        tr.zdicts = {}
    assert default.item() == explicit.item() != none.item()


if __name__ == "__main__":
    g = golden_run()
    np.savez(FIXTURE, **golden_arrays(g))
    print(f"wrote {FIXTURE}: {os.path.getsize(FIXTURE)} bytes")
