"""The port's back-translation speaker on the card: the golden speaker
(``chip_smoke.golden_speaker``, JAX's values) in f32, and the speaker at the
reference contract's width (vocabulary 992, hidden 512, word 256, 3 layers,
4 heads, CLIP-768 + 128 angle features, 15 steps, 80 tokens, batch 8): a
train step, greedy and beam decodes equal to the same weights on the CPU,
no attention kernel launched, and a checkpoint that crosses between the
card and the CPU.

These tests need an NVIDIA GPU; elsewhere they skip.  They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_speaker_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from vln_magic_tpu_torch.agent.speaker import Speaker, SpeakerTokenizer
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
from vln_magic_tpu_torch.ops.attention import fused_attention, packed_attention

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = {"hidden": 512, "word_size": 256, "layers": 3, "heads": 4,
         "max_steps": 15, "max_len": 80}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def full_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = make_synthetic_world(num_scans=1, nodes_per_scan=40,
                                 feat_dim=768, seed=0)
    items = make_synthetic_instructions(world, 8, np.random.default_rng(0),
                                        min_path=4, max_path=7)
    words = sorted({w for it in items for w in it["instruction"].split()})
    tok = SpeakerTokenizer(words + [f"word{i}" for i in
                                    range(988 - len(words))])
    return world, items, tok


def _speakers(world, tok, seed=0):
    return [Speaker(world, feat_dim=768, vocab_size=tok.vocab_size,
                    device=dev, seed=seed, **WIDTH) for dev in ("cuda", "cpu")]


def test_golden_speaker_on_the_card(chip_smoke):
    errs = chip_smoke.golden_speaker("cuda")
    assert errs["grads_rel_l2"] <= 1e-5


def test_full_width_decodes_equal_the_cpu(full_width):
    """The same weights on the card and the CPU (TF32 off): equal greedy
    tokens and beam-4 best hypotheses; 0 attention kernel launches."""
    world, items, tok = full_width
    gpu, cpu = _speakers(world, tok)
    assert tok.vocab_size == 992
    packed_attention.launches = fused_attention.launches = 0
    greedy = gpu.infer_batch(items, tok)
    beam, _ = gpu.back_translate(items, tok, rng=1, beam=4)
    assert packed_attention.launches == fused_attention.launches == 0
    assert greedy.shape == (8, 80)
    np.testing.assert_array_equal(greedy, cpu.infer_batch(items, tok))
    assert [b["instruction"] for b in beam] == [
        b["instruction"] for b in cpu.back_translate(items, tok, rng=1,
                                                      beam=4)[0]]


def test_full_width_train_step_and_checkpoint(full_width, tmp_path):
    """A train step on the card gives a finite loss; with dropout off
    (``eval()``) it gives the CPU's loss on the same weights; the card's
    checkpoint loads on the CPU with its optimizer state and decodes
    alike."""
    world, items, tok = full_width
    gpu, cpu = _speakers(world, tok)
    assert np.isfinite(gpu.train_step(items, tok))
    path = str(tmp_path / "speaker.pt")
    gpu.save(0, path)
    assert cpu.load(path, load_optim=True) == 1
    assert cpu.opt.count == gpu.opt.count == 1
    for sp in (gpu, cpu):
        sp.model.eval()
    losses = []
    for sp in (gpu, cpu):
        c, p, m = sp._tensors(*sp.path_features(items))
        t, tm = sp._tensors(*sp.encode_targets(items, tok))
        with torch.no_grad():
            losses.append(sp.loss(c, p, m, t, tm).item())
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    np.testing.assert_array_equal(gpu.infer_batch(items[:4], tok),
                                  cpu.infer_batch(items[:4], tok))


def test_sampling_on_the_card(full_width):
    world, items, tok = full_width
    gpu, _ = _speakers(world, tok)
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    greedy = gpu.infer_batch(items[:4], tok)
    np.testing.assert_array_equal(
        gpu.infer_batch(items[:4], tok, sample=True, generator=gen(0),
                        temperature=1e-4), greedy)
    hot = [gpu.infer_batch(items[:4], tok, sample=True, generator=gen(s),
                           temperature=5.0) for s in (1, 2)]
    assert (hot[0] != hot[1]).any()
