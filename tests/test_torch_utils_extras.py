"""The rest of the port's utils/ held against JAX's on the CPU:
``debug`` (non-finite reports with JAX's leaf names, ``grad_health``,
``param_fingerprint`` equal to JAX's digest of the same weights named by
flax name, ``check_params_in_sync``, ``NanGuard``), ``profiling`` (a trace
naming its regions, the step timer, the memory figures) and ``hf_import``
(the RoBERTa and METER maps equal JAX's, and the loads put the same
values where JAX's merge does) on state dicts built in memory."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_magic_tpu.utils import debug as jdebug
from vln_magic_tpu.utils import hf_import as jhf
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch.config import ModelConfig
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.utils import debug as tdebug
from vln_magic_tpu_torch.utils import hf_import as thf
from vln_magic_tpu_torch.utils import profiling as tprof
from vln_magic_tpu_torch.utils.weights import export_flax_params, init_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nested(flat: dict) -> dict:
    tree = {}
    for name, arr in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


@pytest.fixture(scope="module")
def small():
    cfg = ModelConfig(vocab_size=64, hidden_size=32, num_attention_heads=2,
                      num_l_layers=2,
                      num_pano_layers=1, num_x_layers=1, image_feat_size=16,
                      max_position_embeddings=40, kd_heads=True,
                      kd_target_size=48, use_lang2visn_attn=True)
    model = DualScaleVLNBert(cfg, device="cpu")
    init_params(model, 3)
    return cfg, model


# ---- debug ----------------------------------------------------------------

def test_nonfinite_report_names_match_jax():
    tree = {"a": {"w": np.array([1.0, np.nan], np.float32),
                  "ok": np.ones(2, np.float32)},
            "b": [np.array([np.inf], np.float32), np.arange(3)],
            "c": np.zeros(1, np.float32)}
    want = jdebug.nonfinite_report(jax.tree_util.tree_map(jnp.asarray, tree))
    got = tdebug.nonfinite_report(
        {"a": {k: torch.from_numpy(v) for k, v in tree["a"].items()},
         "b": [torch.from_numpy(x) for x in tree["b"]],
         "c": torch.from_numpy(tree["c"])})
    assert got == want == ["a.w", "b.[0]"]
    assert tdebug.nonfinite_report(tree) == want       # arrays too
    with pytest.raises(FloatingPointError, match="a.w"):
        tdebug.assert_finite(tree, "step")
    tdebug.assert_finite({"x": torch.ones(3)})


def test_grad_health_matches_jax(small):
    _, model = small
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, 0.01 * (i % 5 - 2))
    grads = [p.grad for p in model.parameters()]
    got = tdebug.grad_health({"params": grads})
    want = jdebug.grad_health([jnp.asarray(g.numpy()) for g in grads])
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    grads[-1].view(-1)[0] = float("nan")
    assert int(tdebug.grad_health(grads)["grad_nonfinite"]) == 1
    model.zero_grad(set_to_none=True)


def test_param_fingerprint_matches_jax(small):
    """The port's digest of a model equals JAX's of the same weights in
    their flax tree, and moves with any weight."""
    _, model = small
    flat = export_flax_params(model)
    want = jdebug.param_fingerprint(_nested(flat))
    assert tdebug.param_fingerprint(model) == want
    assert tdebug.param_fingerprint(flat) == want
    with torch.no_grad():
        model.lang_encoder.emb_norm.bias.add_(1e-3)
    try:
        assert tdebug.param_fingerprint(model) != want
    finally:
        with torch.no_grad():
            model.lang_encoder.emb_norm.bias.sub_(1e-3)
    assert tdebug.param_fingerprint(model) == want


def test_check_params_in_sync_one_process(small):
    _, model = small
    assert not torch.distributed.is_initialized()
    assert tdebug.check_params_in_sync(model) is True
    assert jdebug.check_params_in_sync(_nested(export_flax_params(model)))


def test_nan_guard():
    guard = tdebug.NanGuard(check_inputs=True)
    f = guard(lambda x: {"loss": x * 2})
    assert float(f(torch.tensor(1.0))["loss"]) == 2.0
    with pytest.raises(FloatingPointError, match="step outputs: loss"):
        tdebug.NanGuard()(lambda x: {"loss": x / 0})(torch.tensor(0.0))
    with pytest.raises(FloatingPointError, match="step inputs"):
        f(torch.tensor(float("nan")))
    off = lambda x: x
    assert tdebug.NanGuard(enabled=False)(off) is off


# ---- profiling ------------------------------------------------------------

def test_trace_names_its_regions(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("vln_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "vln_region" in names
    assert any(e.key == "vln_region" for e in prof.key_averages())


def test_step_timer_and_memory_stats():
    t = tprof.StepTimer(warmup=1)
    for _ in range(3):
        with t:
            torch.ones(8).sum()
    assert t.count == 3 and t.mean > 0
    assert t.throughput(10) == pytest.approx(10 / t.mean)
    assert tprof.StepTimer(warmup=5).throughput(1) == 0.0
    stats = tprof.device_memory_stats()
    if torch.cuda.is_available():
        assert all(set(v) == {"bytes_in_use", "peak_bytes_in_use",
                              "bytes_limit"} for v in stats.values())
    else:
        assert stats == {"cpu": {}}


# ---- hf_import ------------------------------------------------------------

def roberta_state(cfg, n_layers, rng, prefix="roberta."):
    """A HuggingFace ``RobertaModel`` state dict's keys and shapes."""
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"embeddings.word_embeddings.weight": r(cfg.vocab_size, h),
          "embeddings.position_embeddings.weight":
              r(cfg.max_position_embeddings, h),
          "embeddings.token_type_embeddings.weight": r(1, h),
          "embeddings.LayerNorm.weight": r(h),
          "embeddings.LayerNorm.bias": r(h),
          "pooler.dense.weight": r(h, h), "pooler.dense.bias": r(h)}
    for i in range(n_layers):
        s = f"encoder.layer.{i}"
        for n in ("query", "key", "value"):
            sd[f"{s}.attention.self.{n}.weight"] = r(h, h)
            sd[f"{s}.attention.self.{n}.bias"] = r(h)
        for part, shape in (("attention.output", (h, h)),
                            ("intermediate", (ffn, h)),
                            ("output", (h, ffn))):
            sd[f"{s}.{part}.dense.weight"] = r(*shape)
            sd[f"{s}.{part}.dense.bias"] = r(shape[0])
        for part in ("attention.output", "output"):
            sd[f"{s}.{part}.LayerNorm.weight"] = r(h)
            sd[f"{s}.{part}.LayerNorm.bias"] = r(h)
    return {prefix + k: v for k, v in sd.items()}


def meter_state(cfg, rng):
    """A METER checkpoint's text stack and cross layers (as
    tests/test_checkpoint.py builds it)."""
    sd = {f"text_transformer.{k}": v for k, v in
          roberta_state(cfg, cfg.num_l_layers, rng, prefix="").items()}
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    for i in range(cfg.num_x_layers):
        for stack, attns in (("cross_modal_image_layers",
                              ("attention", "crossattention")),
                             ("cross_modal_text_layers", ("crossattention",))):
            s = f"{stack}.{i}"
            for attn in attns:
                for n in ("query", "key", "value"):
                    sd[f"{s}.{attn}.self.{n}.weight"] = r(h, h)
                    sd[f"{s}.{attn}.self.{n}.bias"] = r(h)
                sd[f"{s}.{attn}.output.dense.weight"] = r(h, h)
                sd[f"{s}.{attn}.output.dense.bias"] = r(h)
                sd[f"{s}.{attn}.output.LayerNorm.weight"] = r(h)
                sd[f"{s}.{attn}.output.LayerNorm.bias"] = r(h)
            if stack == "cross_modal_image_layers":
                sd[f"{s}.intermediate.dense.weight"] = r(ffn, h)
                sd[f"{s}.intermediate.dense.bias"] = r(ffn)
                sd[f"{s}.output.dense.weight"] = r(h, ffn)
                sd[f"{s}.output.dense.bias"] = r(h)
                sd[f"{s}.output.LayerNorm.weight"] = r(h)
                sd[f"{s}.output.LayerNorm.bias"] = r(h)
    return sd


def _same_maps(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("jump_init", [False, True])
def test_roberta_import_matches_jax(small, jump_init):
    """The map equals JAX's (tensors or arrays in), and the load writes
    what JAX's merge writes into the same tree; the model still runs."""
    cfg, model = small
    sd = roberta_state(cfg, 4, np.random.default_rng(0))
    want = jhf.roberta_to_lang_encoder(sd, cfg.num_l_layers, jump_init)
    _same_maps(thf.roberta_to_lang_encoder(sd, cfg.num_l_layers, jump_init),
               want)
    _same_maps(thf.roberta_to_lang_encoder(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg.num_l_layers,
        jump_init), want)
    tree = _nested(export_flax_params(model))
    new, j_loaded = jhf.load_roberta_weights(tree, sd, cfg.num_l_layers,
                                             jump_init)
    before = export_flax_params(model)
    loaded = thf.load_roberta_weights(model, sd, cfg.num_l_layers,
                                      jump_init)
    assert sorted(loaded) == sorted(j_loaded) and len(loaded) > 20
    after, j_flat = export_flax_params(model), flatten_params(new)
    for k in after:
        np.testing.assert_array_equal(after[k], j_flat[k], err_msg=k)
    src = 2 if jump_init else 1
    np.testing.assert_array_equal(
        after["params.lang_encoder.layer_1.attention.query.kernel"],
        sd[f"roberta.encoder.layer.{src}.attention.self.query.weight"].T)
    from vln_magic_tpu_torch.utils.weights import load_flax_params

    load_flax_params(model, before)


def test_meter_import_matches_jax(small):
    """METER's text stack into the language encoder, each image cross
    layer into both cross-modal encoders, the text cross layers into
    lang2visn, as JAX's merge does; skipped names equal JAX's."""
    cfg, model = small
    sd = meter_state(cfg, np.random.default_rng(1))
    _same_maps(thf.meter_to_params(sd, cfg.num_l_layers, cfg.num_x_layers),
               jhf.meter_to_params(sd, cfg.num_l_layers, cfg.num_x_layers))
    before = export_flax_params(model)
    new, j_loaded, j_skipped = jhf.load_meter_weights(
        _nested(before), sd, cfg.num_l_layers, cfg.num_x_layers)
    loaded, skipped = thf.load_meter_weights(model, sd, cfg.num_l_layers,
                                             cfg.num_x_layers)
    assert sorted(loaded) == sorted(j_loaded)
    assert sorted(skipped) == sorted(j_skipped)
    after, j_flat = export_flax_params(model), flatten_params(new)
    for k in after:
        np.testing.assert_array_equal(after[k], j_flat[k], err_msg=k)
    for enc in ("local_encoder", "global_encoder"):
        np.testing.assert_array_equal(
            after[f"params.{enc}.layer_0.crossattention.query.kernel"],
            sd["cross_modal_image_layers.0.crossattention.self.query.weight"]
            .T)
        np.testing.assert_array_equal(
            after[f"params.{enc}.layer_0.lang2visn_attention.out.kernel"],
            sd["cross_modal_text_layers.0.crossattention.output.dense.weight"]
            .T)
    from vln_magic_tpu_torch.utils.weights import load_flax_params

    load_flax_params(model, before)
