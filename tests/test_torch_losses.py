"""The port's distillation losses (vln_magic_tpu_torch.agent.losses and
.distill) held against vln_magic_tpu's on the same numpy-seeded inputs:
every function's value, and its gradients with respect to the student-side
and the teacher-side inputs (``jax.grad`` against ``backward``), which pins
where ``.detach()`` stands: the detached side gets a zero gradient.

Values to 1e-6 relative; gradients to 1e-6 of the array's largest
magnitude (f32 sums in another order).
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vln_magic_tpu.agent import distill as jd
from vln_magic_tpu.agent import losses as jl
from vln_magic_tpu.config import DistillConfig as JaxDistillConfig
from vln_magic_tpu_torch.agent import distill as td
from vln_magic_tpu_torch.agent import losses as tl
from vln_magic_tpu_torch.config import DistillConfig

RTOL = 1e-6
B, C, L, DS, DT = 4, 9, 6, 8, 12      # batch, classes/tokens, length, widths


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(*case) -> int:
    """A seed per test case that does not change between processes."""
    return zlib.crc32(repr(case).encode())


def _close(got, want, what, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _logits(rng, *shape, masked=True):
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    if masked:                      # the rollout's -1e9 masks and an -inf
        x[..., -2] = -1e9
        x[0, ..., -1] = -np.inf
    return x


def _pair_grads(jfn, tfn, a, b):
    """Value and gradients with respect to both inputs, in both packages."""
    jv, (ja, jb) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(a),
                                                           jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    tv = tfn(ta, tb)
    tv.backward()
    return (jv, ja, jb), (tv, ta.grad, tb.grad)


def _finite_grad(g):
    return np.where(np.isfinite(g), g, 0.0)


@pytest.mark.parametrize("loss_type", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "mktd"])
@pytest.mark.parametrize("name", ["mse", "kd", "kd_t2", "dkd"])
def test_losses_and_their_gradients_match_jax(name, weighted, loss_type):
    rng = np.random.default_rng(_seed(name, weighted, loss_type))
    w = rng.uniform(0.1, 1.0, B).astype(np.float32) if weighted else None
    kw = {"loss_type": loss_type}
    jkw = dict(kw, t_sample_weights=None if w is None else jnp.asarray(w))
    tkw = dict(kw, t_sample_weights=None if w is None else torch.tensor(w))
    if name == "mse":
        a = rng.standard_normal((B, L, DS)).astype(np.float32)
        b = rng.standard_normal((B, L, DS)).astype(np.float32)
        jf = lambda x, y: jl.mse_loss(x, y, **jkw)
        tf = lambda x, y: tl.mse_loss(x, y, **tkw)
    elif name.startswith("kd"):
        temp = 2.0 if name == "kd_t2" else 1.0
        a, b = _logits(rng, B, C), _logits(rng, B, C)
        jf = lambda x, y: jl.kd_loss(x, y, temperature=temp, **jkw)
        tf = lambda x, y: tl.kd_loss(x, y, temperature=temp, **tkw)
    else:
        a, b = _logits(rng, B, C), _logits(rng, B, C)
        target = rng.integers(0, C - 2, B)
        jf = lambda x, y: jl.dkd_loss(x, y, jnp.asarray(target),
                                      temperature=2.0, alpha=1.0, beta=8.0,
                                      **jkw)
        tf = lambda x, y: tl.dkd_loss(x, y, torch.tensor(target),
                                      temperature=2.0, alpha=1.0, beta=8.0,
                                      **tkw)
    (jv, ja, jb), (tv, ta, tb) = _pair_grads(jf, tf, a, b)
    _close(tv, jv, f"{name} value")
    _close(ta, _finite_grad(np.asarray(ja)), f"{name} d/student")
    _close(tb, _finite_grad(np.asarray(jb)), f"{name} d/teacher")


@pytest.mark.parametrize("method", ["exp", "norm"])
def test_mktd_weights_match_jax(method):
    ce = np.random.default_rng(1).uniform(0, 5, B).astype(np.float32)
    _close(tl.mktd_sample_weights(torch.tensor(ce), method, 0.7),
           jl.mktd_sample_weights(jnp.asarray(ce), method, 0.7), method)
    _close(tl.exponential_decay(torch.tensor(ce), 0.3),
           jl.exponential_decay(jnp.asarray(ce), 0.3), "exponential_decay")
    _close(tl.invert_normalized_losses(torch.tensor(ce)),
           jl.invert_normalized_losses(jnp.asarray(ce)), "invert")


def test_grad_softmax_weights_and_masked_ce_match_jax():
    rng = np.random.default_rng(2)
    g = rng.uniform(0, 3, 5).astype(np.float32)
    _close(tl.grad_softmax_weights(g, 0.5),
           jl.grad_softmax_weights(jnp.asarray(g), 0.5), "grad weights")
    logits = _logits(rng, B, C, masked=False)
    targets = np.array([0, 3, -100, C - 1])
    ce_j, valid_j = jl.masked_softmax_ce(jnp.asarray(logits),
                                         jnp.asarray(targets))
    ce_t, valid_t = tl.masked_softmax_ce(torch.tensor(logits),
                                         torch.tensor(targets))
    _close(ce_t, ce_j, "ce")
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


@pytest.mark.parametrize("seed", range(4))
def test_mkrw_weights_are_positive_and_sum_to_five(seed):
    gen = torch.Generator().manual_seed(seed)
    for temp in (0.5, 1.0, 2.0):
        w = tl.mkrw_weights(gen, 5, temp)
        assert w.shape == (5,) and bool((w > 0).all())
        assert abs(float(w.sum()) - 5.0) < 1e-5


# ---- makd_step_losses, both roles -------------------------------------

HEADS = ("txt_emb_w", "kdl_img_w", "kdl_avg_img_w", "local_cross_w",
         "global_cross_w")
# (tensor name, shape for a model of width d and depth n)
OUTS = {"txt_embeds": lambda d, n: (B, L, d),
        "txt_attns": lambda d, n: (B, n, L, L),
        "pano_embeds": lambda d, n: (B, 7, d),
        "pano_fused_embeds": lambda d, n: (B, d),
        "img_attns": lambda d, n: (B, n, 7, 7),
        "vp_embeds": lambda d, n: (B, 7, d),
        "vp_attns": lambda d, n: (B, n, 7, L),
        "gmap_embeds": lambda d, n: (B, 5, d),
        "gmap_attns": lambda d, n: (B, n, 5, L),
        "fused_logits": lambda d, n: (B, C)}


def _outs(rng, d, depth):
    out = {}
    for k, shape in OUTS.items():
        if k == "fused_logits":
            out[k] = _logits(rng, *shape(d, depth))
        elif "attns" in k:
            x = rng.uniform(0, 1, shape(d, depth)).astype(np.float32)
            out[k] = x / x.sum(-1, keepdims=True)
        else:
            out[k] = rng.standard_normal(shape(d, depth)).astype(np.float32)
    return out


VARIANTS = {
    "sum_mse_kd_learned": dict(),
    "mean_kl_dkd_rw_norm": dict(loss_type="mean", feat_loss="kl",
                                attn_loss="kl", logit_loss="dkd",
                                sample_preprocess="norm", weights="rw"),
    "sum_mse_kd_no_adaptive": dict(weights=None),
    "mean_mse_dkd_learned_t2": dict(loss_type="mean", logit_loss="dkd",
                                    temperature=2.0),
}


@pytest.mark.parametrize("t_step", [0, 2])
@pytest.mark.parametrize("role", ["t2s", "s2t"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_makd_step_losses_and_gradients_match_jax(variant, role, t_step):
    """``makd_step_losses`` on the same random model outputs, projection
    heads (a fixed random affine map each), targets and weights: each of
    the ten losses, and the gradients of their sum with respect to the
    student's and the teacher's outputs and the learned weights."""
    opts = dict(VARIANTS[variant])
    weights = opts.pop("weights", "learned")
    cfg_kw = dict(opts, ability_types=("txt", "img", "local", "global",
                                       "action"))
    jcfg, tcfg = JaxDistillConfig(**cfg_kw), DistillConfig(**cfg_kw)
    rng = np.random.default_rng(_seed(variant, role, t_step))
    stu, tea = _outs(rng, DS, 2), _outs(rng, DT, 3)
    proj = {h: (rng.standard_normal((DS, DT)).astype(np.float32) * 0.3,
                rng.standard_normal(DT).astype(np.float32) * 0.1)
            for h in HEADS}
    targets = np.array([1, 0, -100, 4])
    ce = rng.uniform(0.1, 3.0, B).astype(np.float32)
    rw = rng.uniform(0.2, 2.0, 5).astype(np.float32)
    learned = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    sw_j = jl.mktd_sample_weights(jnp.asarray(ce), jcfg.sample_preprocess,
                                  jcfg.sample_exp_decay)
    sw_t = tl.mktd_sample_weights(torch.tensor(ce), tcfg.sample_preprocess,
                                  tcfg.sample_exp_decay)
    # in 's2t' the teacher's outputs are the trained side and the student's
    # the (projected) target
    first, second = (stu, tea) if role == "t2s" else (tea, stu)

    def jax_total(first_j, second_j, learned_j):
        project = lambda name, x: x @ jnp.asarray(proj[name][0]) \
            + jnp.asarray(proj[name][1])
        out = jd.makd_step_losses(
            jcfg, jnp.asarray(t_step), first_j, second_j, project,
            jnp.asarray(targets), jnp.asarray(rw) if weights == "rw" else None,
            sw_j, learned_j if weights == "learned" else None, role=role)
        return sum(out.values()), out

    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    (jv, jout), jgrads = jax.value_and_grad(
        jax_total, argnums=(0, 1, 2), has_aux=True)(
            to_j(first), to_j(second), jnp.asarray(learned))

    to_t = lambda d: {k: torch.tensor(v, requires_grad=True)
                      for k, v in d.items()}
    first_t, second_t = to_t(first), to_t(second)
    learned_t = torch.tensor(learned, requires_grad=True)
    project = lambda name, x: x @ torch.tensor(proj[name][0]) \
        + torch.tensor(proj[name][1])
    tout = td.makd_step_losses(
        tcfg, t_step, first_t, second_t, project, torch.tensor(targets),
        torch.tensor(rw) if weights == "rw" else None, sw_t,
        learned_t if weights == "learned" else None, role=role)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        # KL between two attention maps read as logits: the maps' softmaxes
        # are near uniform, so log p_t - log p_s cancels to about 1e-3 of
        # either log, and one f32 rounding of each log is 1e-4 of the
        # difference; such a loss is held to 1e-5
        kl_of_maps = k.endswith("attn_loss") and tcfg.attn_loss == "kl"
        _close(tout[k], jout[k], f"{variant} {role} {k}",
               rtol=1e-5 if kl_of_maps else RTOL)
    sum(tout.values()).backward()
    for side, jg, tt in (("trained", jgrads[0], first_t),
                         ("target", jgrads[1], second_t)):
        for k in OUTS:
            want = _finite_grad(np.asarray(jg[k]))
            got = (tt[k].grad if tt[k].grad is not None
                   else torch.zeros_like(tt[k]))
            _close(got, want, f"{variant} {role} d/{side} {k}")
            if side == "target":     # detached: no gradient reaches it
                assert not np.any(want) and not got.any(), k
    if weights == "learned":
        _close(learned_t.grad, jgrads[2], f"{variant} {role} d/learned")


def test_makd_respects_the_ability_and_part_switches():
    """Abilities left out and the no_feat / no_attn / no_logit switches
    leave their losses at zero, in both packages alike."""
    rng = np.random.default_rng(5)
    stu, tea = _outs(rng, DS, 2), _outs(rng, DT, 3)
    project = lambda name, x: torch.cat([x, x[..., : DT - DS]], -1)
    jproject = lambda name, x: jnp.concatenate([x, x[..., : DT - DS]], -1)
    to_t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    for kw in (dict(ability_types=("img", "action")), dict(no_feat=True),
               dict(no_attn=True, no_logit=True)):
        tout = td.makd_step_losses(DistillConfig(**kw), 0, to_t(stu),
                                   to_t(tea), project, torch.tensor(
                                       [1, 2, 3, 4]), None, None)
        jout = jd.makd_step_losses(JaxDistillConfig(**kw), jnp.asarray(0),
                                   to_j(stu), to_j(tea), jproject,
                                   jnp.asarray([1, 2, 3, 4]), None, None)
        for k in jout:
            _close(tout[k], jout[k], f"{kw} {k}")
        assert any(float(v) == 0.0 for v in tout.values())
