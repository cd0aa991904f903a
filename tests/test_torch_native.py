"""The port's native host ops (vln_magic_tpu_torch.native, its own copy of
``vln_native.cpp`` built with g++ into ``vln_magic_tpu_torch/build/``) held
against vln_magic_tpu.native on seeded random corpora: BLEU counts and
score, edit distances, edit operations, batches under token and sentence
caps and WER (token ids and strings) equal; and the C++ results equal to
the port's numpy versions, which the library's absence selects.
"""

import os

import numpy as np
import pytest
import torch

from vln_magic_tpu import native as jax_native
from vln_magic_tpu_torch import native


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, so that the test workers sharing the machine do
    not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def corpus(seed, n=64, vocab=12, max_len=30):
    """``n`` (hypothesis, reference) pairs of token ids, empty ones
    included; a small vocabulary so that n-grams match."""
    rng = np.random.default_rng(seed)
    seq = lambda: rng.integers(0, vocab, rng.integers(0, max_len)).tolist()
    return [seq() for _ in range(n)], [seq() for _ in range(n)]


@pytest.fixture
def plain(monkeypatch):
    """The numpy versions: the loader finds no library."""
    monkeypatch.setattr(native, "_load", lambda: None)


def test_library_is_built_under_the_port_build_dir():
    assert native.native_available()
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), "build")
    assert os.path.exists(path)
    assert native._load()._name == path


@pytest.mark.parametrize("seed", [0, 1])
def test_bleu_matches_jax(seed):
    hyps, refs = corpus(seed)
    np.testing.assert_array_equal(native.bleu_counts(hyps, refs),
                                  jax_native.bleu_counts(hyps, refs))
    assert native.bleu_score(hyps, refs) == jax_native.bleu_score(hyps, refs)
    assert native.bleu_score(refs, refs) == pytest.approx(100.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_distance_and_ops_match_jax(seed):
    hyps, refs = corpus(seed)
    np.testing.assert_array_equal(native.edit_distance(hyps, refs),
                                  jax_native.edit_distance(hyps, refs))
    for a, b in zip(hyps[:16], refs[:16]):
        d, ops = native.edit_ops(a, b)
        jd, jops = jax_native.edit_ops(a, b)
        assert d == jd
        np.testing.assert_array_equal(ops, jops)


@pytest.mark.parametrize("caps", [(100, 0), (0, 7), (120, 5)])
def test_batch_by_size_matches_jax(caps):
    lengths = np.random.default_rng(3).integers(1, 50, 300)
    got = native.batch_by_size(lengths, *caps)
    want = jax_native.batch_by_size(lengths, *caps)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_wer_matches_jax():
    hyps, refs = corpus(4)
    assert native.wer(hyps, refs) == jax_native.wer(hyps, refs)
    text = lambda s: " ".join(f"w{x}" for x in s)
    th, tr = [text(h) for h in hyps], [text(r) for r in refs]
    assert native.wer(th, tr) == jax_native.wer(th, tr)
    assert native.wer([], []) == 0.0


def test_cpp_equals_numpy(monkeypatch):
    hyps, refs = corpus(5)
    lengths = np.random.default_rng(5).integers(1, 50, 200)

    def run():
        return (native.bleu_counts(hyps, refs).tolist(),
                native.bleu_score(hyps, refs),
                native.edit_distance(hyps, refs).tolist(),
                [b.tolist() for b in native.batch_by_size(lengths, 150, 9)],
                native.wer(hyps, refs))

    cpp = run()
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.native_available()
    assert run() == cpp


def test_edit_ops_needs_the_library(plain):
    with pytest.raises(NotImplementedError, match="native library"):
        native.edit_ops([1, 2], [2, 3])
