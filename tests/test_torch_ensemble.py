"""The port's MC-dropout ensembles (``ensemble_n`` > 1: ``Rollout._apply_mc``)
held against vln_magic_tpu's ``_apply_mc``: with every dropout rate 0,
``evaluate(ensemble_n=3)`` gives JAX's trajectories and metrics; with
dropout on, each mode's output is the mean of three single-draw forwards
taken from the same generator state, the panorama's averaged before the
navigation reads it; only the deterministic language encoder launches the
packed kernel; streaming is refused, as in JAX.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_rollout import golden_cfg, golden_items
from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent.navigator import Navigator as JaxNavigator
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.utils.checkpoint import unflatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.rollout import Rollout
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.models import layers as port_layers
from vln_magic_tpu_torch.ops import attention

TOL = 1e-5
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_params_777.npz")
NO_DROPOUT = {"hidden_dropout": 0.0, "attention_dropout": 0.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    return make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                seed=777)


@pytest.fixture(scope="module")
def flat():
    return dict(np.load(FIXTURE))


def test_dropout_free_ensemble_matches_jax(world, flat):
    jw = jax_world(num_scans=2, nodes_per_scan=20, feat_dim=24, seed=777)
    items = golden_items(jw)
    jnav = JaxNavigator(golden_cfg(jcfg, **NO_DROPOUT), jw,
                        params=unflatten_params(flat)[0])
    (want, _), want_preds = jnav.evaluate(items, ensemble_n=3)
    nav = Navigator(golden_cfg(tcfg, **NO_DROPOUT), world, params=flat,
                    device="cpu")
    (got, _), preds = nav.evaluate(items, ensemble_n=3)
    assert [p["trajectory"] for p in preds] == \
        [p["trajectory"] for p in want_preds]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)
    # with no dropout the ensemble is the single decode
    (_, _), single = nav.evaluate(items)
    assert [p["trajectory"] for p in single] == \
        [p["trajectory"] for p in preds]


def _step_inputs(cfg, seed=0):
    from test_torch_model import _inputs, _torch

    x = _inputs(cfg.model, seed)
    return {k: _torch(v) for k, v in x.items()}


@pytest.mark.parametrize("mode", ["panorama", "navigation"])
def test_each_mode_is_the_mean_of_single_draws(world, flat, mode):
    cfg = golden_cfg(tcfg)
    assert cfg.model.hidden_dropout > 0
    nav = Navigator(cfg, world, params=flat, device="cpu")
    x = _step_inputs(cfg)
    if mode == "panorama":
        args = [x[k] for k in ("view_img_fts", "loc_fts", "nav_types",
                               "pano_masks")]
    else:
        from test_torch_model import NAV_ARGS
        args = [x[k] for k in NAV_ARGS]
    fn = getattr(nav.model, mode)
    gen = lambda: torch.Generator().manual_seed(11)
    drop = {"deterministic": True, "generator": gen(), "need_maps": False}
    with torch.no_grad():
        got = Rollout._apply_mc(fn, 3, drop, *args)
        g = gen()
        runs = [fn(*args, deterministic=False, generator=g)
                for _ in range(3)]
        single = fn(*args)
    if mode == "panorama":
        pairs = [(got[i], [r[i] for r in runs]) for i in range(3)]
    else:
        pairs = [(got[k], [r[k] for r in runs]) for k in got]
    for value, draws in pairs:
        assert torch.equal(value, torch.stack(draws).mean(0))
    # the draws differ, so the mean is not the deterministic forward
    first = got[0] if mode == "panorama" else got["fused_logits"]
    plain = single[0] if mode == "panorama" else single["fused_logits"]
    assert not torch.allclose(first, plain)


def test_model_step_feeds_the_mean_panorama_to_navigation(world, flat,
                                                          monkeypatch):
    """Each mode is averaged on its own (JAX's ``_apply_mc`` per mode):
    a step's viewpoint tokens are assembled from the mean of its three
    panorama draws, and its three navigation draws all read them."""
    nav = Navigator(golden_cfg(tcfg), world, params=flat, device="cpu")
    model = nav.model
    pano_out, assembled, nav_in = [], [], []
    real_pano, real_nav = model.panorama, model.navigation
    real_vp = Rollout.assemble_vp

    def panorama(*a, **k):
        out = real_pano(*a, **k)
        pano_out.append(out[0])
        return out

    def navigation(*a, **k):
        nav_in.append(a[8])                       # vp_img_embeds
        return real_nav(*a, **k)

    def assemble_vp(self, state, pano_embeds, *a, **k):
        assembled.append(pano_embeds)
        return real_vp(self, state, pano_embeds, *a, **k)

    monkeypatch.setattr(model, "panorama", panorama)
    monkeypatch.setattr(model, "navigation", navigation)
    monkeypatch.setattr(Rollout, "assemble_vp", assemble_vp)
    nav.run_items(golden_items(world)[:2], ensemble_n=3)
    t = nav.cfg.env.max_action_len
    assert len(pano_out) == len(nav_in) == 3 * t and len(assembled) == t
    for step in range(t):
        draws = pano_out[3 * step : 3 * step + 3]
        assert torch.equal(assembled[step], torch.stack(draws).mean(0))
        assert not torch.equal(draws[0], draws[1])
        assert all(torch.equal(x, nav_in[3 * step])
                   for x in nav_in[3 * step : 3 * step + 3])


def test_ensemble_is_reproducible_and_launches_only_language(
        world, flat, monkeypatch):
    cfg = golden_cfg(tcfg, use_pallas_attention=True)
    nav = Navigator(cfg, world, params=flat, device="cpu")
    calls = []
    real = attention.packed_attention

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(port_layers, "packed_attention", counted)
    items = golden_items(world)
    (_, _), a = nav.evaluate(items, ensemble_n=3)
    (_, _), b = nav.evaluate(items, ensemble_n=3)
    assert [p["trajectory"] for p in a] == [p["trajectory"] for p in b]
    # the deterministic language encoder only: 2 layers, one wave each run
    assert len(calls) == 2 * cfg.model.num_l_layers


def test_streaming_is_refused(world, flat, monkeypatch):
    nav = Navigator(golden_cfg(tcfg), world, params=flat, device="cpu")
    items = golden_items(world)
    with pytest.raises(ValueError, match="ensemble_n"):
        nav.evaluate(items, batch_size=4, ensemble_n=2, stream=True)
    streamed = []
    monkeypatch.setattr(nav, "_evaluate_stream",
                        lambda *a, **k: streamed.append(1))
    (avg, _), preds = nav.evaluate(items, batch_size=4, ensemble_n=2)
    assert not streamed and len(preds) == len(items)
    assert np.isfinite(avg["nDTW"])
