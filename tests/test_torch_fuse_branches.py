"""The port's branch-fused cross-modal trunk (``ModelConfig.fuse_branches``:
``DualScaleVLNBert._branched_encoders``) held against vln_magic_tpu's
``_branched_encoders`` and against the port's own unfused trunk, in f32:
``navigation`` within 1e-5 (also through the packed route's plain version),
a decode equal to JAX's and to the pinned golden trajectories,
``packed_attention`` calls counted at the wrapper (8 a step at 6/2/3
layers, against 14 unfused, both branches at batch 2B), training
gradients equal to the unfused trunk's, and the stacked-weight cache
following a load and an optimizer step.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from test_torch_model import NAV_ARGS, NAV_KEYS, _inputs, flax_params
from test_torch_rollout import golden_cfg, golden_items
from test_torch_trainer import GOLDEN, golden_config
from vln_magic_tpu import config as jcfg
from vln_magic_tpu.agent.navigator import Navigator as JaxNavigator
from vln_magic_tpu.env import make_synthetic_world as jax_world
from vln_magic_tpu.models import DualScaleVLNBert as FlaxModel
from vln_magic_tpu.utils.checkpoint import flatten_params, unflatten_params
from vln_magic_tpu_torch import config as tcfg
from vln_magic_tpu_torch.agent import trainer as port_trainer
from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.models import layers as port_layers
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.ops import attention
from vln_magic_tpu_torch.utils.weights import init_params, load_flax_params

TOL = 1e-5
HERE = os.path.dirname(__file__)
FIXTURE = os.path.join(HERE, "fixtures", "golden_params_777.npz")
BASE = jcfg.ModelConfig(vocab_size=120, hidden_size=48, num_attention_heads=3,
                        num_l_layers=2, num_pano_layers=2, num_x_layers=2,
                        image_feat_size=24, max_position_embeddings=48)
CONFIGS = {
    "base": BASE,
    "packed": dataclasses.replace(BASE, use_pallas_attention=True),
    # no lang2visn, no graph sprels (the global bias all zeros), fixed gate
    "variant": dataclasses.replace(BASE, use_lang2visn_attn=False,
                                   graph_sprels=False, glocal_fuse=False),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.integer):
        return torch.from_numpy(x.astype(np.int64))
    return torch.from_numpy(x.copy())


def _close(a, b, what):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (what, a.shape, b.shape)
    diff = float(np.max(np.abs(a - b)))
    assert diff < TOL, f"{what}: max abs diff {diff}"


def _pair(cfg, fused=True):
    """Port models with JAX's weights: (fused, unfused)."""
    params = flax_params(cfg, seed=4)
    models = []
    for fuse in (fused, False):
        m = DualScaleVLNBert(tcfg.ModelConfig(**dataclasses.asdict(
            dataclasses.replace(cfg, fuse_branches=fuse))), device="cpu")
        load_flax_params(m, flatten_params(params))
        models.append(m)
    return params, models


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_navigation_matches_jax_and_the_unfused_trunk(name):
    cfg = CONFIGS[name]
    params, (fused, unfused) = _pair(cfg)
    x = _inputs(cfg)
    jc = dataclasses.replace(cfg, fuse_branches=True)
    want = jax.jit(FlaxModel(jc).apply, static_argnames=("method",))(
        params, *[x[k] for k in NAV_ARGS], method=FlaxModel.navigation)
    with torch.no_grad():
        got = fused.navigation(*[_t(x[k]) for k in NAV_ARGS])
        plain = unfused.navigation(*[_t(x[k]) for k in NAV_ARGS])
    for k in NAV_KEYS:
        _close(want[k], got[k], f"{k} vs JAX")
        _close(plain[k].numpy(), got[k], f"{k} vs unfused")
    if name != "packed":          # the packed route returns zeros for maps
        for k in ("gmap_attns", "vp_attns"):
            _close(want[k], got[k], f"{k} vs JAX")


@pytest.fixture(scope="module")
def golden_world():
    return make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                seed=777)


@pytest.fixture(scope="module")
def jax_fused_decode():
    """JAX's fused-branch decode of the golden weights and items."""
    flat = dict(np.load(FIXTURE))
    world = jax_world(num_scans=2, nodes_per_scan=20, feat_dim=24, seed=777)
    nav = JaxNavigator(golden_cfg(jcfg, fuse_branches=True), world,
                       params=unflatten_params(flat)[0])
    (_, _), preds = nav.evaluate(golden_items(world), batch_size=8)
    return flat, [p["trajectory_idx"] for p in preds]


@pytest.mark.parametrize("packed", [False, True])
def test_decode_matches_jax_and_the_golden(golden_world, jax_fused_decode,
                                           packed):
    flat, want = jax_fused_decode
    nav = Navigator(golden_cfg(tcfg, fuse_branches=True,
                               use_pallas_attention=packed),
                    golden_world, params=flat, device="cpu")
    (_, _), preds = nav.evaluate(golden_items(golden_world), batch_size=8)
    got = [p["trajectory_idx"] for p in preds]
    assert got == want
    with open(os.path.join(HERE, "golden_decode.json")) as f:
        assert got == json.load(f)


def test_stream_equals_waves(golden_world):
    flat = dict(np.load(FIXTURE))
    nav = Navigator(golden_cfg(tcfg, fuse_branches=True), golden_world,
                    params=flat, device="cpu")
    items = golden_items(golden_world)
    (_, _), waves = nav.evaluate(items, batch_size=3, stream=False)
    (_, _), stream = nav.evaluate(items, batch_size=3, stream=True)
    assert [p["trajectory"] for p in stream] == \
        [p["trajectory"] for p in waves]


def _counted_decode(world, fuse, monkeypatch):
    """A decode of T 2 at 6/2/3 layers with every ``packed_attention`` call
    recorded at the wrapper: (language calls, step calls) as (batch, Lq)."""
    cfg = golden_cfg(tcfg, fuse_branches=fuse, use_pallas_attention=True)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_l_layers=6,
                                       num_pano_layers=2, num_x_layers=3),
        env=dataclasses.replace(cfg.env, max_action_len=2))
    nav = Navigator(cfg, world, seed=1, device="cpu")
    calls = []
    real = attention.packed_attention

    def counted(q, k, v, mask, sprel=None, *, num_heads):
        calls.append((q.shape[0], q.shape[1], sprel is not None))
        return real(q, k, v, mask, sprel, num_heads=num_heads)

    monkeypatch.setattr(port_layers, "packed_attention", counted)
    items = golden_items(world)[:4]
    nav.evaluate(items, batch_size=4)
    return calls


def test_eight_packed_calls_a_step_against_fourteen(golden_world,
                                                    monkeypatch):
    fused = _counted_decode(golden_world, True, monkeypatch)
    unfused = _counted_decode(golden_world, False, monkeypatch)
    assert len(fused) == 6 + 2 * 8 and len(unfused) == 6 + 2 * 14
    step = fused[6:14]
    # 2 panorama calls at B 4, then each layer's cross and self attention
    # at B 8 = 2B, the self-attention with the sprel bias of both branches
    assert [c[0] for c in step] == [4, 4] + [8] * 6
    assert [c[2] for c in step] == [False] * 2 + [False, True] * 3


def _train_pair(fuse):
    spec = json.loads(json.dumps(GOLDEN))
    spec["model"]["fuse_branches"] = fuse
    world = make_synthetic_world(**spec["world"])
    tr = port_trainer.Trainer(golden_config(tcfg, spec), world, device="cpu")
    return tr, world


def test_training_grads_equal_the_unfused_trunk():
    from test_torch_trainer import items_for

    (fused, world), (plain, _) = _train_pair(True), _train_pair(False)
    items = items_for(world)
    got_loss, got = fused.compute_grads(items, seed=3)
    want_loss, want = plain.compute_grads(items, seed=3)
    np.testing.assert_allclose(got_loss.item(), want_loss.item(), rtol=TOL)
    for part in want:
        top = max(float(v.abs().max()) for v in want[part].values())
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(),
                                       rtol=0, atol=TOL * top,
                                       err_msg=f"{part} {k}")
    # both encoders' layers took gradients through the stacked weights
    for enc in ("global_encoder", "local_encoder"):
        g = got["params"][f"params.{enc}.layer_0.self_attention.query.kernel"]
        assert float(g.abs().max()) > 0


def test_weight_cache_follows_loads_and_optimizer_steps():
    cfg = CONFIGS["base"]
    params, (fused, unfused) = _pair(cfg)
    x = [_t(v) for v in (_inputs(cfg)[k] for k in NAV_ARGS)]

    def agree():
        with torch.no_grad():
            a = fused.navigation(*x)["fused_logits"]
            b = unfused.navigation(*x)["fused_logits"]
        return float((a - b).abs().max())

    assert agree() < TOL
    key = fused._stacked[0]
    with torch.no_grad():                 # a second call reuses the stack
        fused.navigation(*x)
    assert fused._stacked[0] == key
    # a load into both models
    new = flatten_params(flax_params(cfg, seed=9))
    for m in (fused, unfused):
        load_flax_params(m, new)
    assert agree() < TOL and fused._stacked[0] != key
    # an optimizer step on both
    for m in (fused, unfused):
        opt = torch.optim.SGD(m.parameters(), lr=0.5)
        m.navigation(*x)["fused_logits"].sum().backward()
        opt.step()
    assert agree() < TOL
    # the unfused model's weights alone: the fused one must not follow
    init_params(unfused, 5)
    assert agree() > 1e-3
