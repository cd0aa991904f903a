"""The port's DualScaleVLNBert (vln_magic_tpu_torch.models.vlnbert) held
against flax ``apply`` of vln_magic_tpu's model, mode by mode, on identical
weights carried across by ``utils.weights.load_flax_params``.

Inputs come from numpy with a fixed seed.  Tolerance 2e-5 absolute in f32.
The ``packed`` configuration sends the port's attention through
``ops.attention.packed_attention`` (its plain version on the CPU), while
flax on the CPU runs its einsum path: the two must agree all the same.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vln_magic_tpu.config import ModelConfig
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.models.vlnbert import dummy_step_batch
from vln_magic_tpu.utils.checkpoint import flatten_params, save_torch_checkpoint
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.utils.checkpoint import load_reference_checkpoint
from vln_magic_tpu_torch.utils.weights import load_flax_params

TOL = 2e-5
B, LT, P, G = 3, 12, 9, 7      # batch, text, pano tokens, gmap tokens

BASE = ModelConfig(vocab_size=120, hidden_size=48, num_attention_heads=3,
                   num_l_layers=2, num_pano_layers=2, num_x_layers=2,
                   image_feat_size=24, max_position_embeddings=48)
CONFIGS = {
    "base": BASE,
    # lang2visn never takes the packed path: it runs the f32-logits einsum
    "packed": dataclasses.replace(BASE, use_pallas_attention=True,
                                  attn_logits_f32=True),
    # the other side of each switch: fixed 0.5 gate, mean pano pooling, no
    # lang2visn (all cross K/V hoisted), no sprel bias, softmax in the
    # compute dtype, tanh gelu
    "variant": dataclasses.replace(BASE, glocal_fuse=False,
                                   adaptive_pano_fusion=False,
                                   use_lang2visn_attn=False,
                                   graph_sprels=False,
                                   softmax_compute_dtype_attn=True,
                                   gelu_approximate=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    d, p2 = cfg.hidden_size, P + 2
    txt_masks = np.ones((B, LT), bool)
    txt_masks[:, -3:] = False
    pano_masks = np.ones((B, P), bool)
    pano_masks[:, -2:] = False
    gmap_masks = np.ones((B, G), bool)
    gmap_masks[:, 1] = False
    gmap_masks[:, -1] = False
    gmap_visited = np.zeros((B, G), bool)
    gmap_visited[:, 1:3] = True
    vp_nav = np.ones((B, p2), bool)
    vp_nav[:, 1] = False
    vp_nav[:, -4:] = False
    return {
        "txt_ids": rng.integers(2, cfg.vocab_size, (B, LT)).astype(np.int32),
        "txt_masks": txt_masks,
        "view_img_fts": f(B, P, cfg.image_feat_size),
        "loc_fts": f(B, P, cfg.loc_feat_size),
        "nav_types": rng.integers(0, 3, (B, P)).astype(np.int32),
        "pano_masks": pano_masks,
        "txt_embeds": f(B, LT, d),
        "gmap_img_embeds": f(B, G, d),
        "gmap_step_ids": rng.integers(0, 5, (B, G)).astype(np.int32),
        "gmap_pos_fts": f(B, G, cfg.gmap_pos_size),
        "gmap_masks": gmap_masks,
        "gmap_visited_masks": gmap_visited,
        "gmap_pair_dists": np.abs(f(B, G, G)) * 5.0,
        "vp_img_embeds": f(B, p2, d),
        "vp_pos_fts": f(B, p2, cfg.vp_pos_size),
        "vp_masks": np.concatenate([np.ones((B, 2), bool), pano_masks], 1),
        "vp_nav_masks": vp_nav,
        "gmap_local_slot": rng.integers(-1, p2, (B, G)).astype(np.int32),
        "vp_cand_visited": (rng.random((B, p2)) < 0.3).astype(np.float32),
    }


def _torch(x):
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.integer):
        return torch.from_numpy(x.astype(np.int64))
    return torch.from_numpy(x.copy())


NAV_ARGS = ("txt_embeds", "txt_masks", "gmap_img_embeds", "gmap_step_ids",
            "gmap_pos_fts", "gmap_masks", "gmap_visited_masks",
            "gmap_pair_dists", "vp_img_embeds", "vp_pos_fts", "vp_masks",
            "vp_nav_masks", "gmap_local_slot", "vp_cand_visited")
NAV_KEYS = ("gmap_embeds", "vp_embeds", "global_logits", "local_logits",
            "fused_logits", "fuse_weights", "cls_embeds")


def flax_params(cfg, seed):
    """Random params of the flax model's own tree: the shapes come from
    ``jax.eval_shape`` of ``init`` (which compiles nothing), the values from
    numpy, with non-zero biases and LayerNorm scales near 1 so that every
    leaf, not only the kernels, shows up in the outputs."""
    shapes = jax.eval_shape(FlaxModel(cfg).init, jax.random.PRNGKey(0),
                            dummy_step_batch(cfg, batch_size=1))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        x = 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(x + 1.0 if path[-1].key == "scale" else x)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(a, b, what):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert diff < TOL, f"{what}: max abs diff {diff}"


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    params = flax_params(cfg, seed=3)
    tmodel = DualScaleVLNBert(cfg, device="cpu")
    load_flax_params(tmodel, flatten_params(params))
    fmodel = FlaxModel(cfg)
    apply = jax.jit(fmodel.apply, static_argnames=("method",))
    return request.param, cfg, apply, params, tmodel, _inputs(cfg)


def test_language_matches_flax(pair):
    name, cfg, apply, params, tmodel, x = pair
    want, want_attn = apply(params, jnp.asarray(x["txt_ids"]),
                                   jnp.asarray(x["txt_masks"]),
                                   method=FlaxModel.language)
    got, got_attn = tmodel.language(_torch(x["txt_ids"]),
                                    _torch(x["txt_masks"]))
    _close(want, got, "txt_embeds")
    if name != "packed":          # the packed path returns zeros instead
        _close(want_attn, got_attn, "txt_attns")


def test_panorama_matches_flax(pair):
    name, cfg, apply, params, tmodel, x = pair
    keys = ("view_img_fts", "loc_fts", "nav_types", "pano_masks")
    want = apply(params, *[jnp.asarray(x[k]) for k in keys],
                        method=FlaxModel.panorama)
    got = tmodel.panorama(*[_torch(x[k]) for k in keys])
    for w, g, what in zip(want, got, ("pano_embeds", "pano_fused",
                                      "img_attns")):
        if not (name == "packed" and what == "img_attns"):
            _close(w, g, what)


@pytest.mark.parametrize("hoisted", [False, True])
def test_text_cross_kv_and_navigation_match_flax(pair, hoisted):
    name, cfg, apply, params, tmodel, x = pair
    f_kv = t_kv = None
    if hoisted:
        f_kv = apply(params, jnp.asarray(x["txt_embeds"]),
                            method=FlaxModel.text_cross_kv)
        t_kv = tmodel.text_cross_kv(_torch(x["txt_embeds"]))
        for branch in ("global", "local"):
            assert len(f_kv[branch]) == len(t_kv[branch])
            for fk, tk in zip(f_kv[branch], t_kv[branch]):
                assert (fk is None) == (tk is None)
                if fk is not None:
                    _close(fk[0], tk[0], f"{branch} key")
                    _close(fk[1], tk[1], f"{branch} value")
    want = apply(params, *[jnp.asarray(x[k]) for k in NAV_ARGS],
                        txt_cross_kvs=f_kv, method=FlaxModel.navigation)
    got = tmodel.navigation(*[_torch(x[k]) for k in NAV_ARGS],
                            txt_cross_kvs=t_kv)
    for k in NAV_KEYS:
        _close(want[k], got[k], k)
    if name != "packed":
        _close(want["gmap_attns"], got["gmap_attns"], "gmap_attns")
        _close(want["vp_attns"], got["vp_attns"], "vp_attns")


def test_load_flax_params_raises_on_missing_or_unmatched_keys():
    flat = flatten_params(flax_params(BASE, seed=0))
    tmodel = DualScaleVLNBert(BASE, device="cpu")
    missing = dict(flat)
    del missing["params.global_encoder.layer_1.self_attention.out.kernel"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(tmodel, missing)
    extra = dict(flat, **{"params.no_such_module.kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="unmatched"):
        load_flax_params(tmodel, extra)
    bad = dict(flat)
    bad["params.cls_fuse.kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_flax_params(tmodel, bad)


def test_reference_checkpoint_container_round_trip(tmp_path):
    """flax params -> the reference .pt container -> the port's model."""
    params = flax_params(BASE, seed=1)
    path = str(tmp_path / "nav.pt")
    save_torch_checkpoint(params, path, epoch=3)
    flat, epoch = load_reference_checkpoint(path)
    assert epoch == 3
    want = flatten_params(params)
    assert sorted(flat) == sorted(want)
    tmodel = DualScaleVLNBert(BASE, device="cpu")
    load_flax_params(tmodel, flat)
    w = tmodel.global_encoder.layer_0.crossattention.query.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        want["params.global_encoder.layer_0.crossattention.query.kernel"].T)


@pytest.mark.parametrize("flag", ["do_back_txt", "do_front_img", "do_back_img",
                                  "fuse_branches"])
def test_intervention_and_fused_configurations_match_flax(flag):
    """Each switch the port once refused builds, loads JAX's params
    strictly (its heads' names and widths) and gives JAX's forward: the
    mode that switch changes, fed a dictionary where it reads one."""
    cfg = dataclasses.replace(BASE, **{flag: True})
    params = flax_params(cfg, seed=5)
    tmodel = DualScaleVLNBert(cfg, device="cpu")
    load_flax_params(tmodel, flatten_params(params))
    apply = jax.jit(FlaxModel(cfg).apply, static_argnames=("method",))
    x = _inputs(cfg)
    rng = np.random.default_rng(6)
    z = lambda d: rng.standard_normal((B, 5, d)).astype(np.float32)
    pzs = np.full((B, 5, 1), 0.25, np.float32)
    pzs[:, -1] = 0.0                                  # a padded row
    if flag == "do_back_txt":
        zd = {"direction_features": z(48), "direction_pzs": pzs,
              "landmark_features": z(48), "landmark_pzs": pzs}
        want, _ = apply(params, x["txt_ids"], x["txt_masks"],
                        instr_zdict=zd, method=FlaxModel.language)
        got, _ = tmodel.language(_torch(x["txt_ids"]), _torch(x["txt_masks"]),
                                 instr_zdict={k: _torch(v)
                                              for k, v in zd.items()})
        _close(want, got, "txt_embeds")
    elif flag == "do_back_img":
        keys = ("view_img_fts", "loc_fts", "nav_types", "pano_masks")
        zi = z(cfg.image_feat_size)
        want = apply(params, *[x[k] for k in keys], z_img_feats=zi,
                     z_img_pzs=pzs, method=FlaxModel.panorama)
        got = tmodel.panorama(*[_torch(x[k]) for k in keys],
                              z_img_feats=_torch(zi), z_img_pzs=_torch(pzs))
        _close(want[0], got[0], "pano_embeds")
        _close(want[1], got[1], "pano_fused")
    else:
        kw = {"front_vp_feats": z(48)} if flag == "do_front_img" else {}
        want = apply(params, *[x[k] for k in NAV_ARGS], **kw,
                     method=FlaxModel.navigation)
        got = tmodel.navigation(*[_torch(x[k]) for k in NAV_ARGS],
                                **{k: _torch(v) for k, v in kw.items()})
        for k in NAV_KEYS:
            _close(want[k], got[k], k)


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DualScaleVLNBert(BASE)
