"""The port's int8 weight quantization (vln_magic_tpu_torch.utils.quantize)
and weight export held against vln_magic_tpu.utils.quantize on the same
seeded arrays: int8 values and scales bit for bit, dequantized values
exactly, the relative errors to 1e-6 (the same f32 arithmetic, summed in
another order), the npz round trip, the product quantizer's codes and
centroids, and ``export_flax_params`` -> ``load_flax_params`` bit for bit.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from vln_magic_tpu.utils import quantize as jq
from vln_magic_tpu.utils.checkpoint import flatten_params
from vln_magic_tpu_torch.config import ModelConfig
from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
from vln_magic_tpu_torch.utils import quantize as tq
from vln_magic_tpu_torch.utils.weights import (export_flax_params,
                                               init_params, load_flax_params)

ERR_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_tree(seed=0):
    """A nested tree: kernels that quantize, a bias and a small kernel that
    do not, an integer leaf, and an all-zero kernel (scale 1)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"params": {
        "enc": {"kernel": f(64, 48), "bias": f(48)},
        "embed": {"embedding": 3.0 * f(40, 32)},
        "tiny": {"kernel": f(8, 8)},
        "zero": {"kernel": np.zeros((32, 32), np.float32)},
        "steps": np.arange(12, dtype=np.int32).reshape(3, 4)}}


def test_quantize_params_equals_jax_bit_for_bit():
    tree = seeded_tree()
    want = flatten_params(jq.quantize_params(tree))
    got = tq.flatten(tq.quantize_params(tree))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith(".dtype"):
            assert tq._dtype_of(got[k]) == np.asarray(v).dtype.name, k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
    deq_want = flatten_params(jq.dequantize_params(jq.quantize_params(tree)))
    deq_got = tq.flatten(tq.dequantize_params(tq.quantize_params(tree)))
    for k, v in deq_want.items():
        np.testing.assert_array_equal(deq_got[k], v, err_msg=k)
    err_want = jq.quantization_error(tree, jq.quantize_params(tree))
    err_got = tq.quantization_error(tree, tq.quantize_params(tree))
    assert sorted(err_got) == sorted(err_want)
    for k, v in err_want.items():
        np.testing.assert_allclose(err_got[k], v, rtol=ERR_RTOL, atol=1e-12,
                                   err_msg=k)
    assert max(err_got.values()) < 0.02


@pytest.mark.parametrize("flat", [False, True], ids=["nested", "flat"])
def test_a_bf16_leaf_quantizes_and_keeps_its_dtype(flat):
    """A bfloat16 torch tensor quantizes as JAX's ml_dtypes bfloat16 array
    does, and comes back as bfloat16 with JAX's values."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    jax_leaf = x.astype(ml_dtypes.bfloat16)
    torch_leaf = torch.from_numpy(x).to(torch.bfloat16)
    want = jq.quantize_params({"w": jax_leaf}, min_size=16)["w"]
    tree = {"w": torch_leaf} if flat else {"a": {"w": torch_leaf}}
    q = tq.quantize_params(tree, min_size=16)
    got = q["w"] if flat else q["a"]["w"]
    np.testing.assert_array_equal(got["__int8__"], want["__int8__"])
    np.testing.assert_array_equal(got["scale"], want["scale"])
    assert tq._dtype_of(got["dtype"]) == "bfloat16"
    back = tq.dequantize_params(q)
    back = back["w"] if flat else back["a"]["w"]
    assert back.dtype == torch.bfloat16
    want_back = jq.dequantize_params({"w": want})["w"]
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(want_back, np.float32))


def test_save_and_load_quantized_match_jax(tmp_path):
    """The port's npz and JAX's load to the same values; the port also
    reads JAX's file (its dtype entry a zero-size array)."""
    tree = seeded_tree(2)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "t.npz")
    jq.save_quantized(tree, jax_path)
    tq.save_quantized(tree, port_path)
    want = flatten_params(jq.load_quantized(jax_path))
    for path in (port_path, jax_path):
        got = tq.load_quantized(path)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=(path, k))


def test_product_quantizer_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 16)).astype(np.float32)
    jp = jq.ProductQuantizer(num_blocks=4, num_centroids=8, iters=5,
                             seed=4).fit(w)
    tp = tq.ProductQuantizer(num_blocks=4, num_centroids=8, iters=5,
                             seed=4).fit(torch.from_numpy(w))
    np.testing.assert_array_equal(tp.centroids, jp.centroids)
    np.testing.assert_array_equal(tp.encode(w), jp.encode(w))
    codes = tp.encode(w)
    np.testing.assert_array_equal(tp.decode(codes), jp.decode(codes))
    again = tq.ProductQuantizer.from_state(tp.state())
    np.testing.assert_array_equal(again.decode(codes), tp.decode(codes))
    with pytest.raises(ValueError, match="uint8"):
        tq.ProductQuantizer(num_centroids=300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_export_then_load_gives_the_same_bits(dtype):
    cfg = ModelConfig(vocab_size=50, hidden_size=32, num_attention_heads=2,
                      num_l_layers=1, num_pano_layers=1, num_x_layers=1,
                      image_feat_size=16, max_position_embeddings=40,
                      kd_heads=True, kd_target_size=16)
    model = DualScaleVLNBert(cfg, dtype=dtype, device="cpu")
    init_params(model, 9)
    flat = export_flax_params(model)
    assert flat["params.cls_fuse.kernel"].shape == (64, 32)   # [in, out]
    other = DualScaleVLNBert(cfg, dtype=dtype, device="cpu")
    load_flax_params(other, flat)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 other.state_dict().items()):
        assert torch.equal(a, b), name
    again = export_flax_params(other)
    for k, v in flat.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
