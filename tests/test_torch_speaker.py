"""The back-translation speaker of the port (vln_magic_tpu_torch.models.
speaker, agent.speaker) held against vln_magic_tpu's on the CPU, on the
golden speaker's world and JAX's initial weights
(``chip_smoke.GOLDEN_SPEAKER_SPEC``; the weights carried with
``flatten_params``/``load_flax_params``): path features, noise and the
tokenizer exactly; the deterministic teacher-forced logits to 1e-5, loss to
1e-6 relative and gradients to 1e-5 relative L2 (JAX's loss at
``deterministic=True``, the port's model in ``eval()``); one AdamW update
against optax to 1e-6; greedy decodes and beam-3 decodes (length penalty 1
and 0.7) equal, beam scores to 1e-5; ``evaluate``'s BLEU and
``back_translate`` (greedy and beam) equal; the ``.pt`` container both
ways with the optimizer state.  Sampling is held to JAX's own properties
(its draws come from another generator).

The fixture ``tests/fixtures/golden_speaker_17.npz``, which
``chip_smoke.py`` phase 15 checks on the card, is rewritten with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_speaker.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from chip_smoke import (GOLDEN_SPEAKER_SPEC as SPEC, SPEAKER_FIXTURE,
                        check_speaker, speaker_outputs, speaker_world_items)
from vln_magic_tpu import env as jenv
from vln_magic_tpu.agent.speaker import Speaker as JaxSpeaker
from vln_magic_tpu.agent.speaker import SpeakerTokenizer as JaxTokenizer
from vln_magic_tpu.models.speaker import beam_decode as jax_beam_decode
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch import env as tenv
from vln_magic_tpu_torch.agent.speaker import Speaker, SpeakerTokenizer
from vln_magic_tpu_torch.models.layers import MultiHeadAttention
from vln_magic_tpu_torch.utils.weights import (export_flax_params,
                                               load_flax_params)

FEAT = SPEC["world"]["feat_dim"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _deterministic_loss(sp, cand, pano, masks, tokens, tok_masks):
    """JAX's teacher-forced CE (``Speaker._make_train_step``'s loss) at
    ``deterministic=True``: (loss, logits) as a function of the params."""
    def loss_fn(params):
        logits = sp.model.apply(params, cand, pano, masks, tokens[:, :-1])
        valid = tok_masks[:, 1:]
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.take_along_axis(logp, tokens[:, 1:, None], -1)[..., 0]
        return (ce * valid).sum() / jnp.maximum(valid.sum(), 1), logits
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_golden(spec=SPEC):
    """JAX's speaker on the spec: the fixture's arrays, and the live JAX
    speaker, its items and tokenizer for the other comparisons."""
    world, items = speaker_world_items(jenv, spec)
    tok = JaxTokenizer(list(spec["vocab"]))
    sp = JaxSpeaker(world, feat_dim=FEAT, vocab_size=tok.vocab_size,
                    rng=jax.random.PRNGKey(spec["seed"]), **spec["model"])
    cand, pano, masks = sp.path_features(items)
    tokens, tok_masks = sp.encode_targets(items, tok)
    grad_fn = _deterministic_loss(sp, cand, pano, masks, tokens, tok_masks)
    (loss, logits), grads = grad_fn(sp.params)
    greedy = sp.infer_batch(items, tok)
    forced = np.asarray(jax.jit(sp.model.apply)(
        sp.params, cand, pano, masks, jnp.asarray(greedy[:, :-1])))
    top2 = np.sort(forced, axis=-1)[..., -2:]
    out = {"spec": np.asarray(json.dumps(spec)),
           "logits": np.asarray(logits), "loss": np.float32(loss),
           "greedy": np.asarray(greedy, np.int32),
           "greedy_gap": top2[..., 1] - top2[..., 0]}
    out.update({f"w/{k}": np.asarray(v)
                for k, v in flatten_params(sp.params).items()})
    out.update({f"g/{k}": np.asarray(v)
                for k, v in flatten_params(grads).items()})
    for lp in spec["length_penalties"]:
        toks, scores = jax_beam_decode(
            sp.model, sp.params, jnp.asarray(cand), jnp.asarray(pano),
            jnp.asarray(masks), sp.L, tok.BOS, tok.EOS, beam=spec["beam"],
            length_penalty=lp)
        out[f"beam/{lp}/tokens"] = np.asarray(toks, np.int32)
        out[f"beam/{lp}/scores"] = np.asarray(scores)
    return out, {"sp": sp, "items": items, "tok": tok, "grads": grads,
                 "grad_fn": grad_fn}


@pytest.fixture(scope="module")
def jax_run():
    arrays, live = jax_golden()
    sp, items, tok = live["sp"], live["items"], live["tok"]
    noise = sp.drop_env_noise(np.random.default_rng(SPEC["noise_seed"]))
    live.update(
        arrays=arrays, noise=noise,
        features=sp.path_features(items),
        noisy_features=sp.path_features(items, noise=noise),
        bleu=sp.evaluate(items, tok),
        back_greedy=sp.back_translate(items, tok, rng=3),
        back_beam=sp.back_translate(items, tok, rng=4, beam=SPEC["beam"]))
    return live


def port_speaker(weights: dict, **kw):
    """The port's speaker on the spec's world with ``weights`` (flat flax
    names), and its items and tokenizer."""
    world, items = speaker_world_items(tenv)
    tok = SpeakerTokenizer(list(SPEC["vocab"]))
    sp = Speaker(world, feat_dim=FEAT, vocab_size=tok.vocab_size,
                 device="cpu", **{**SPEC["model"], **kw})
    load_flax_params(sp.model, weights)
    return sp, items, tok


def jax_weights(jax_run):
    return {k[2:]: v for k, v in jax_run["arrays"].items()
            if k.startswith("w/")}


# ---- against JAX ----------------------------------------------------------

def test_golden_speaker_fixture_is_a_fresh_jax_run(jax_run):
    fixture = dict(np.load(SPEAKER_FIXTURE))
    fresh = jax_run["arrays"]
    assert sorted(fixture) == sorted(fresh)
    assert json.loads(str(fixture["spec"])) == json.loads(json.dumps(SPEC))
    for k, v in fresh.items():
        if k.startswith("w/") or v.dtype.kind in "iU":
            np.testing.assert_array_equal(fixture[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(fixture[k], v, rtol=1e-6,
                                       atol=1e-6 * np.max(np.abs(v)),
                                       err_msg=k)


def test_golden_speaker_on_the_cpu():
    """``chip_smoke.golden_speaker``, which phase 15 runs on the card,
    passes against the fixture here."""
    errs = chip_smoke.golden_speaker("cpu")
    assert errs["greedy_tokens_differing"] == 0


def test_forward_loss_gradients_and_decodes_match_jax(jax_run):
    """The deterministic forward, teacher-forced loss and gradients, the
    greedy decode and the beam decodes at both length penalties."""
    sp, items, tok = port_speaker(jax_weights(jax_run))
    got = speaker_outputs(sp, items, tok)
    errs = check_speaker(got, jax_run["arrays"])
    assert errs["greedy_tokens_differing"] == 0
    # the one-node path's all-False step mask: JAX's uniform attention,
    # finite logits
    k = SPEC["one_node_path"]
    assert not jax_run["features"][2][k].any()
    assert np.isfinite(got["logits"][k]).all()


def test_path_features_noise_and_tokenizer_match_jax(jax_run):
    sp, items, tok = port_speaker(jax_weights(jax_run))
    noise = sp.drop_env_noise(np.random.default_rng(SPEC["noise_seed"]))
    np.testing.assert_array_equal(noise, jax_run["noise"])
    for got, want in ((sp.path_features(items), jax_run["features"]),
                      (sp.path_features(items, noise=noise),
                       jax_run["noisy_features"])):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    jtok = JaxTokenizer.build(jax_run["items"])
    ptok = SpeakerTokenizer.build(items)
    assert ptok.words == jtok.words
    for it in items:
        ids = ptok.encode(it["instruction"], 12)
        assert ids == jtok.encode(it["instruction"], 12)
        assert ptok.decode(ids[1:]) == jtok.decode(ids[1:])
        assert ptok.shrink(ids) == jtok.shrink(ids)
    np.testing.assert_array_equal(sp.encode_targets(items, tok)[0],
                                  jax_run["sp"].encode_targets(
                                      jax_run["items"], jax_run["tok"])[0])


def test_adamw_update_matches_optax(jax_run):
    """One update from JAX's gradients: ``clip_by_global_norm(40)`` then
    ``adamw(lr)`` with optax's defaults, weight decay on every leaf."""
    jsp = jax_run["sp"]
    updates, _ = jsp.opt.update(jax_run["grads"], jsp.opt_state, jsp.params)
    want = flatten_params(optax.apply_updates(jsp.params, updates))
    sp, _, _ = port_speaker(jax_weights(jax_run))
    grads = {k: torch.from_numpy(np.array(v)) for k, v in
             flatten_params(jax_run["grads"]).items()}
    from vln_magic_tpu_torch.utils.weights import _flax_names

    for name, (p, t) in _flax_names(sp.model).items():
        p.grad = grads[name].t().contiguous() if t else grads[name]
    sp.opt.step()
    got = export_flax_params(sp.model)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_evaluate_and_back_translate_match_jax(jax_run):
    sp, items, tok = port_speaker(jax_weights(jax_run))
    assert sp.evaluate(items, tok) == pytest.approx(jax_run["bleu"],
                                                    rel=1e-12)
    for kw, key in (({"rng": 3}, "back_greedy"),
                    ({"rng": 4, "beam": SPEC["beam"]}, "back_beam")):
        new, noise = sp.back_translate(items, tok, **kw)
        want_new, want_noise = jax_run[key]
        np.testing.assert_array_equal(noise, want_noise)
        assert [it["instruction"] for it in new] == \
            [it["instruction"] for it in want_new]
        assert [it["instruction"] for it in items] != \
            [it["instruction"] for it in new]


def test_checkpoint_container_crosses_both_ways(jax_run, tmp_path):
    """JAX writes after one update and the port loads it with the optimizer
    state; one deterministic step on each then gives equal parameters.  The
    port writes, and JAX's ``Speaker.load`` reads it (with and without the
    optimizer state) and decodes as the port does."""
    jsp, items, tok = jax_run["sp"], jax_run["items"], jax_run["tok"]
    initial, opt_state0 = jsp.params, jsp.opt_state

    def jax_step():
        grads = jax_run["grad_fn"](jsp.params)[1]
        updates, jsp.opt_state = jsp.opt.update(grads, jsp.opt_state,
                                                jsp.params)
        jsp.params = optax.apply_updates(jsp.params, updates)

    try:
        jax_step()
        path = str(tmp_path / "jax_speaker.pt")
        jsp.save(1, path)

        sp, pitems, ptok = port_speaker(jax_weights(jax_run), lr=1e-4)
        assert sp.load(path, load_optim=True) == 2
        assert sp.opt.count == 1
        sp.model.eval()
        cand, pano, masks = sp._tensors(*sp.path_features(pitems))
        tokens, tok_masks = sp._tensors(*sp.encode_targets(pitems, ptok))
        sp.loss(cand, pano, masks, tokens, tok_masks).backward()
        sp.opt.step()
        jax_step()
        got = export_flax_params(sp.model)
        for k, v in flatten_params(jsp.params).items():
            # a key bias shifts every score of a row alike, so its gradient
            # is 0 up to rounding, which Adam scales to as much as lr: the
            # two packages' rounding differs there
            atol = 1e-4 if k.endswith(".key.bias") else 1e-6
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=0,
                                       atol=atol, err_msg=k)

        out = str(tmp_path / "port_speaker.pt")
        sp.save(5, out)
        jsp.params, jsp.opt_state = initial, opt_state0
        assert jsp.load(out) == 6
        np.testing.assert_array_equal(jsp.infer_batch(items, tok),
                                      sp.infer_batch(pitems, ptok))
        assert jsp.load(out, load_optim=True) == 6
        leaves = jax.tree_util.tree_leaves(jsp.opt_state)
        assert int(leaves[0]) == sp.opt.count == 2
        blob = torch.load(out, weights_only=False)["transpeaker"]
        assert len(blob["optimizer"]) == len(leaves)
        for a, b in zip(leaves, blob["optimizer"]):
            np.testing.assert_array_equal(np.asarray(a), b)
    finally:
        jsp.params, jsp.opt_state = initial, opt_state0


def test_wemb_mismatch_raises(jax_run, tmp_path):
    """A checkpoint written with another ``--wemb`` is refused with
    ``ValueError``, the port's and JAX's alike."""
    world, _ = speaker_world_items(tenv)
    other = Speaker(world, feat_dim=FEAT, vocab_size=60, device="cpu",
                    **{**SPEC["model"], "word_size": 16})
    sp, _, _ = port_speaker(jax_weights(jax_run))
    for name, save in (("port", sp.save), ("jax", jax_run["sp"].save)):
        path = str(tmp_path / f"{name}.pt")
        save(0, path)
        with pytest.raises(ValueError, match="word_emb"):
            other.load(path)


# ---- the port alone -------------------------------------------------------

def test_sampled_decode_properties(jax_run):
    """JAX's own properties of sampling (tests/test_speaker.py): a
    temperature near 0 gives the greedy decode, the temperature is clamped
    at 1e-6 (0 gives the greedy decode too, no NaN), and hot draws from two
    generators differ."""
    sp, items, tok = port_speaker(jax_weights(jax_run))
    greedy = sp.infer_batch(items, tok)
    gen = lambda s: torch.Generator().manual_seed(s)
    for t in (1e-4, 0.0):
        np.testing.assert_array_equal(
            sp.infer_batch(items, tok, sample=True, generator=gen(0),
                           temperature=t), greedy)
    hot = [sp.infer_batch(items, tok, sample=True, generator=gen(s),
                          temperature=5.0) for s in (1, 2)]
    assert (hot[0] != hot[1]).any()
    assert (hot[0][:, 0] == tok.BOS).all()
    again = sp.infer_batch(items, tok, sample=True, generator=gen(1),
                           temperature=5.0)
    np.testing.assert_array_equal(again, hot[0])
    t = [Speaker.sample_temperature(i, 100) for i in (0, 50, 100)]
    assert t[0] == 1.0 and t[2] == 0.5 and t[2] < t[1] < t[0]


def test_speaker_runs_no_attention_kernel_and_trains():
    """Every attention of the speaker is the einsum path (JAX builds them
    with ``use_pallas=False``); a train step with dropout moves the
    weights, and the loss falls on a repeated batch."""
    world, items = speaker_world_items(tenv)
    tok = SpeakerTokenizer.build(items)
    sp = Speaker(world, feat_dim=FEAT, vocab_size=tok.vocab_size,
                 device="cpu", lr=3e-3, **SPEC["model"])
    attns = [m for m in sp.model.modules()
             if isinstance(m, MultiHeadAttention)]
    assert len(attns) == 3 * SPEC["model"]["layers"]
    assert not any(m.use_packed for m in attns)
    assert sp.model.training
    losses = [sp.train_step(items[:2], tok) for _ in range(12)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    world, _ = speaker_world_items(tenv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Speaker(world, feat_dim=FEAT, vocab_size=60, **SPEC["model"])


if __name__ == "__main__":
    arrays, _ = jax_golden()
    np.savez_compressed(SPEAKER_FIXTURE, **arrays)
    print(f"wrote {SPEAKER_FIXTURE}")
