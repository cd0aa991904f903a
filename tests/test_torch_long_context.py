"""The port's long-context models (ops/ema.py, models/mega.py,
models/luna.py, models/lra.py) held against JAX's on the CPU: the damped
EMA scan against JAX's scan and its sequential reference, with and
without an initial state; a Mega block, the Mega encoder, a Luna layer,
the Luna encoder and the LRA classifier with each trunk, outputs and
gradients, on weights the port draws and carries to JAX by flax name;
masking; chunk locality; three ``lra_train_step``s under Adam against
JAX's step under optax; and the golden fixture of ``chip_smoke.py``'s
phase 17 (``GOLDEN_LONG_CONTEXT_SPEC``), which
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_long_context.py``
rewrites."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vln_magic_tpu.models import lra as jlra
from vln_magic_tpu.models import luna as jluna
from vln_magic_tpu.models import mega as jmega
from vln_magic_tpu.ops import ema as jema
from vln_magic_tpu_torch.models import lra as tlra
from vln_magic_tpu_torch.models import luna as tluna
from vln_magic_tpu_torch.models import mega as tmega
from vln_magic_tpu_torch.models._init import flax_default_init
from vln_magic_tpu_torch.ops import ema as tema
from vln_magic_tpu_torch.utils.weights import (export_flax_params,
                                               flax_named_grads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

SPEC = cs.GOLDEN_LONG_CONTEXT_SPEC
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_params(model) -> dict:
    """The port's weights as JAX's nested ``{"params": ...}``."""
    tree = {}
    for name, arr in export_flax_params(model).items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def flat(tree) -> dict:
    return {".".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def assert_grads(port_model, jax_grads):
    """Each gradient leaf within ``GRAD_TOL``, the absolute part scaled by
    the largest gradient of the model (leaves whose gradient is zero in
    exact arithmetic, as an attention key bias's, hold only rounding)."""
    got = {k: v.numpy() for k, v in flax_named_grads(port_model).items()}
    want = flat(jax_grads)
    assert sorted(got) == sorted(want)
    scale = max(np.abs(w).max() for w in want.values())
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * scale)


T = lambda a: torch.as_tensor(np.asarray(a))


# ---- the EMA scan ---------------------------------------------------------

@pytest.mark.parametrize("length", [1, 17, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ema_scan_matches_jax(length, with_h0):
    rng = np.random.default_rng(length)
    b, d, n = 2, 8, 4
    x = rng.standard_normal((b, length, d)).astype(np.float32)
    alpha, delta = (rng.uniform(0.1, 0.9, (d, n)).astype(np.float32)
                    for _ in range(2))
    beta, eta = (rng.standard_normal((d, n)).astype(np.float32)
                 for _ in range(2))
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) if with_h0 \
        else None
    args = (x, alpha, delta, beta, eta)
    y, h = tema.damped_ema_scan(*map(T, args),
                                None if h0 is None else T(h0))
    ry, rh = tema.damped_ema_reference(*map(T, args),
                                       None if h0 is None else T(h0))
    for fn in (jema.damped_ema_scan, jema.damped_ema_reference):
        jy, jh = jax.jit(fn)(*map(jnp.asarray, args),
                             None if h0 is None else jnp.asarray(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(ry.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(rh.numpy(), np.asarray(jh), **TOL)


# ---- Mega -----------------------------------------------------------------

def mega_block(hidden=32, chunk=8, ndim=4, seed=0):
    m = tmega.MovingAverageGatedAttention(hidden, chunk_size=chunk,
                                          ema_ndim=ndim)
    m.init_weights(np.random.default_rng(seed))
    return m, jmega.MovingAverageGatedAttention(hidden, chunk_size=chunk,
                                                ema_ndim=ndim)


@pytest.mark.parametrize("causal", [False, True])
def test_mega_block_matches_jax(causal):
    """Outputs and gradients (of a random projection of the output, with
    respect to every weight) of a masked block, 20 tokens in chunks of 8
    (one padded chunk)."""
    m, jm = mega_block()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    r = rng.standard_normal((2, 20, 32)).astype(np.float32)
    mask = np.ones((2, 20), bool)
    mask[1, 15:] = False
    params = jax_params(m)
    fwd = jax.jit(lambda p: jm.apply(p, jnp.asarray(x), jnp.asarray(mask),
                                     causal))
    jy, grad_fn = fwd(params), jax.jit(jax.grad(
        lambda p: (fwd(p) * r).sum()))
    y = m(T(x), T(mask), causal)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    (y * T(r)).sum().backward()
    jg = grad_fn(params)
    assert_grads(m, jg)


def test_mega_masking():
    """Tokens past a row's mask change no output at its unmasked
    positions (the EMA reads masked input, attention masked keys), on
    both sides."""
    m, jm = mega_block()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    mask = np.ones((2, 20), bool)
    mask[1, 15:] = False
    x2 = x.copy()
    x2[1, 15:] += 5.0
    with torch.no_grad():
        y1, y2 = (m(T(a), T(mask)).numpy() for a in (x, x2))
    assert y1.shape == x.shape and np.isfinite(y1).all()
    np.testing.assert_allclose(y1[1, :15], y2[1, :15], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(y1[0], y2[0])
    params = jax_params(m)
    jy = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x2),
                                      jnp.asarray(mask)))
    np.testing.assert_allclose(y2, jy, **TOL)


def test_mega_chunking_is_local():
    """With the EMA's input expansion zeroed (no context flows through
    it) and the reset gate open, perturbing token 0 leaves every token
    past its chunk of 4 as it was and changes its own chunk (JAX's
    tests/test_mega.py)."""
    m, jm = mega_block(hidden=16, chunk=4, ndim=2, seed=1)
    with torch.no_grad():
        m.beta.zero_()
        m.reset.bias.fill_(1.0)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 12, 16)).astype(np.float32))
    x2 = x.clone()
    x2[0, 0] += 10.0
    with torch.no_grad():
        y1, y2 = m(x), m(x2)
    torch.testing.assert_close(y1[0, 8:], y2[0, 8:], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(y1[0, 4:8], y2[0, 4:8], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(y1[0, 1], y2[0, 1])
    jy = jax.jit(jm.apply)(jax_params(m), jnp.asarray(x2.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), **TOL)


def test_mega_encoder_matches_jax():
    enc = tmega.MegaEncoder(32, num_layers=2, chunk_size=16, ema_ndim=4,
                            seed=4, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 50, 32)).astype(
        np.float32)
    mask = np.ones((2, 50), bool)
    mask[0, 40:] = False
    jenc = jmega.MegaEncoder(32, num_layers=2, chunk_size=16, ema_ndim=4)
    jy = jax.jit(jenc.apply)(jax_params(enc), jnp.asarray(x),
                             jnp.asarray(mask))
    with torch.no_grad():
        y = enc(T(x), T(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


# ---- Luna -----------------------------------------------------------------

def test_luna_layer_matches_jax():
    """A pre-LN Luna layer: both streams and the gradients."""
    layer = tluna.LunaEncoderLayer(32, 2, 64, dropout=0.0)
    flax_default_init(layer, np.random.default_rng(5))
    jl = jluna.LunaEncoderLayer(32, 2, 64, dropout=0.0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    p = rng.standard_normal((2, 8, 32)).astype(np.float32)
    mask = np.ones((2, 20), bool)
    mask[1, 12:] = False
    params = jax_params(layer)
    fwd = jax.jit(lambda w: jl.apply(w, jnp.asarray(x), jnp.asarray(p),
                                     jnp.asarray(mask)))
    jx, jp = fwd(params)
    y, q = layer(T(x), T(p), T(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jp), **TOL)
    (y.sum() + 2 * q.sum()).backward()
    jg = jax.jit(jax.grad(lambda w: sum(
        c * s.sum() for c, s in zip((1, 2), fwd(w)))))(params)
    assert_grads(layer, jg)


def test_luna_encoder_matches_jax():
    enc = tluna.LunaEncoder(100, 32, num_layers=2, num_heads=2, proj_len=8,
                            seed=6, device="cpu")
    ids = np.asarray([[5, 6, 7, 8, 1, 1], [9, 10, 1, 1, 1, 1]], np.int64)
    mask = ids != 1
    jenc = jluna.LunaEncoder(vocab_size=100, hidden_size=32, num_layers=2,
                             num_heads=2, proj_len=8)
    want = jax.jit(jenc.apply)(jax_params(enc), jnp.asarray(ids),
                               jnp.asarray(mask))
    with torch.no_grad():
        got = enc(T(ids), T(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---- the LRA classifier ---------------------------------------------------

def lra_pair(trunk, seed=0):
    lr = SPEC["lra"]
    kw = dict(vocab_size=lr["vocab"], num_classes=lr["classes"],
              hidden_size=lr["hidden"], num_layers=lr["layers"],
              num_heads=lr["heads"], encoder=trunk,
              chunk_size=lr["chunk_size"], proj_len=lr["proj_len"])
    return (tlra.LRAClassifier(**kw, seed=seed, device="cpu"),
            jlra.LRAClassifier(**kw))


@pytest.mark.parametrize("trunk", cs.LRA_TRUNKS)
def test_lra_logits_and_grads_match_jax(trunk, monkeypatch):
    """Logits and CE gradients of each trunk on masked rows; no attention
    kernel is reached (the dense trunk is the einsum path)."""
    from vln_magic_tpu_torch.models import layers

    calls = []
    monkeypatch.setattr(layers, "packed_attention",
                        lambda *a, **k: calls.append(1))
    model, jm = lra_pair(trunk)
    x = cs.long_context_inputs()
    tokens, mask, labels = x["lra_tokens"], x["lra_mask"], x["lra_labels"]
    params = jax_params(model)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(tokens), jnp.asarray(mask))
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                    -1).mean(), logits

    (_, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    logits = model(T(tokens), T(mask))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    loss = -torch.log_softmax(logits, -1).gather(
        1, T(labels)[:, None])[:, 0].mean()
    loss.backward()
    assert_grads(model, jg)
    assert calls == []


@pytest.mark.parametrize("trunk", cs.LRA_TRUNKS)
def test_lra_train_step_matches_optax(trunk):
    """Three ``lra_train_step``s under ``torch.optim.Adam`` against JAX's
    step under ``optax.adam`` at the same rate: losses, accuracies and the
    logits after."""
    lr = SPEC["lra"]
    model, jm = lra_pair(trunk)
    x = cs.long_context_inputs()
    args = (x["lra_tokens"], x["lra_mask"], x["lra_labels"])
    opt = optax.adam(lr["lr"])
    params = jax_params(model)
    state = opt.init(params)
    jstep = jlra.lra_train_step(jm, opt)
    step = tlra.lra_train_step(model, torch.optim.Adam(model.parameters(),
                                                       lr=lr["lr"]))
    for i in range(lr["steps"]):
        params, state, jl, jacc = jstep(params, state,
                                        *map(jnp.asarray, args),
                                        jax.random.PRNGKey(i))
        loss, acc = step(*map(T, args))
        assert float(loss) == pytest.approx(float(jl), rel=1e-4)
        assert float(acc) == pytest.approx(float(jacc))
    with torch.no_grad():
        logits = model(T(args[0]), T(args[1]))
    jlogits = jm.apply(params, jnp.asarray(args[0]), jnp.asarray(args[1]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-3, atol=1e-4)


# ---- the golden fixture ---------------------------------------------------

def jax_golden_outputs() -> dict:
    """JAX's values of ``chip_smoke.long_context_outputs`` on the port's
    seeded weights."""
    x = cs.long_context_inputs()
    models = cs.long_context_models("cpu")
    out = {}
    ema = [jnp.asarray(x[f"ema_{k}"]) for k in ("x", "alpha", "delta",
                                                  "beta", "eta")]
    out["ema_y"], out["ema_h"] = jema.damped_ema_scan(*ema)
    out["ema_y_h0"], out["ema_h_h0"] = jema.damped_ema_scan(
        *ema, jnp.asarray(x["ema_h0"]))
    m, lu, lr = SPEC["mega"], SPEC["luna"], SPEC["lra"]
    out["mega_y"] = jmega.MovingAverageGatedAttention(
        m["hidden"], chunk_size=m["chunk_size"],
        ema_ndim=m["ema_ndim"]).apply(
        jax_params(models["mega"]), jnp.asarray(x["mega_x"]),
        jnp.asarray(x["mega_mask"]))
    out["luna_x"], out["luna_p"] = jluna.LunaEncoderLayer(
        lu["hidden"], lu["heads"], lu["intermediate"], dropout=0.0).apply(
        jax_params(models["luna"]), jnp.asarray(x["luna_x"]),
        jnp.asarray(x["luna_p"]), jnp.asarray(x["luna_mask"]))
    args = [jnp.asarray(x[k]) for k in ("lra_tokens", "lra_mask",
                                        "lra_labels")]
    for trunk in cs.LRA_TRUNKS:
        jm = jlra.LRAClassifier(
            lr["vocab"], lr["classes"], lr["hidden"], lr["layers"],
            lr["heads"], trunk, chunk_size=lr["chunk_size"],
            proj_len=lr["proj_len"])
        params = jax_params(models[f"lra_{trunk}"])
        out[f"lra_{trunk}_logits"] = jm.apply(params, *args[:2])
        opt = optax.adam(lr["lr"])
        state, step = opt.init(params), jlra.lra_train_step(jm, opt)
        losses = []
        for i in range(lr["steps"]):
            params, state, loss, _ = step(params, state, *args,
                                          jax.random.PRNGKey(i))
            losses.append(loss)
        out[f"lra_{trunk}_losses"] = jnp.stack(losses)
        out[f"lra_{trunk}_logits_after"] = jm.apply(params, *args[:2])
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def test_golden_fixture():
    """The fixture holds the spec and JAX's values (written by this file
    from ``jax_golden_outputs``); the port on the CPU reproduces them
    (phase 17 does so on the card).  The tests above hold the same
    computations against JAX directly."""
    fx = dict(np.load(cs.LONG_CONTEXT_FIXTURE))
    assert json.loads(str(fx.pop("spec"))) == json.loads(json.dumps(SPEC))
    errs = cs.golden_long_context("cpu")
    assert sorted(errs) == sorted(fx)
    assert os.path.getsize(cs.LONG_CONTEXT_FIXTURE) < 1 << 20


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(cs.LONG_CONTEXT_FIXTURE, spec=json.dumps(SPEC),
                        **jax_golden_outputs())
    print(f"wrote {cs.LONG_CONTEXT_FIXTURE}")
