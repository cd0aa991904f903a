"""``Trainer.fit`` with the back-translation speaker, and the speaker's
CLIs, in the port.

``fit(aug_items=, speaker=, speaker_tok=)`` over two calls against
vln_magic_tpu's, both ``train_step`` replaced by a recorder (as
``test_torch_train_options.py::test_fit_batch_order_matches_jax``) and both
speakers on the same weights: the same batches in the same order, the
same back-translated instructions, the same ``instr_encoding`` and ``aug``
flags.  Then, port only, ``cli.train_speaker`` at tiny flags (its
``speaker.pt`` read by JAX's ``Speaker``, which decodes as the port does)
and ``main_nav --use_transpeaker`` followed by a ``--speaker`` run
(as ``tests/test_cli_orchestration.py``'s speaker round trip).
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import options_world_items
from test_torch_main_nav import CPU, TINY
from test_torch_train_options import (jax_options_trainer,
                                      port_options_trainer)
from vln_magic_tpu import env as jenv
from vln_magic_tpu.agent import trainer as jax_trainer
from vln_magic_tpu.agent.speaker import Speaker as JaxSpeaker
from vln_magic_tpu.agent.speaker import SpeakerTokenizer as JaxTokenizer
from vln_magic_tpu.utils.checkpoint import unflatten_params
from vln_magic_tpu_torch import env as tenv
from vln_magic_tpu_torch.agent import trainer as port_trainer
from vln_magic_tpu_torch.agent.speaker import Speaker, SpeakerTokenizer
from vln_magic_tpu_torch.cli import main_nav, train_speaker
from vln_magic_tpu_torch.utils.weights import export_flax_params

SPEAKER = {"max_steps": 4, "max_len": 12, "hidden": 32, "layers": 1,
           "heads": 2, "word_size": 16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_speaker_like(port_sp, world, tok):
    """A JAX ``Speaker`` on ``world`` with ``port_sp``'s weights."""
    sp = JaxSpeaker(world, feat_dim=world.tables.feat_dim,
                    vocab_size=tok.vocab_size, **SPEAKER)
    sp.params = unflatten_params(export_flax_params(port_sp.model),
                                 template=sp.params)[0]
    return sp


def test_fit_with_speaker_matches_jax(monkeypatch):
    pworld, items, _ = options_world_items(tenv)
    jworld, jitems, _ = options_world_items(jenv)
    aug = lambda its: [dict(it, instr_id=f"aug_{i}")
                       for i, it in enumerate(its + its[:3])]
    record = {"jax": [], "port": []}

    def recorder(key):
        def step(self, batch, zdicts=None, aug=False):
            record[key].append(
                ([b["instr_id"] for b in batch],
                 [b["instruction"] for b in batch],
                 [np.asarray(b["instr_encoding"]).tolist() for b in batch],
                 bool(aug)))
            return {}
        return step

    monkeypatch.setattr(jax_trainer.Trainer, "train_step", recorder("jax"))
    monkeypatch.setattr(port_trainer.Trainer, "train_step",
                        recorder("port"))
    ptok = SpeakerTokenizer.build(items)
    jtok = JaxTokenizer.build(jitems)
    psp = Speaker(pworld, feat_dim=pworld.tables.feat_dim,
                  vocab_size=ptok.vocab_size, device="cpu", seed=3,
                  **SPEAKER)
    jsp = jax_speaker_like(psp, jworld, jtok)
    jt, _ = jax_options_trainer("a2c")
    pt, _ = port_options_trainer("a2c")
    runs = ((jt, jsp, jtok, jitems, "jax"), (pt, psp, ptok, items, "port"))
    for tr, sp, tok, its, key in runs:
        aug_items = aug(its)
        for iters in (5, 4):
            hist = tr.fit(its, iters, aug_items=aug_items, speaker=sp,
                          speaker_tok=tok, aug_times=1)
            assert [h["aug"] for h in hist] == [
                float(r[3]) for r in record[key][-iters:]]
        # the aug items themselves keep their instructions
        assert [it["instruction"] for it in aug_items[:4]] == \
            [it["instruction"] for it in its]
    assert record["port"] == record["jax"]
    translated = [r for r in record["port"] if r[3]]
    assert translated and all(
        t not in {it["instruction"] for it in items}
        for r in translated for t in r[1])


def test_train_speaker_cli_loads_in_jax(tmp_path):
    """``train_speaker`` at tiny flags: its log lines and files; JAX's
    ``Speaker.load`` reads its ``speaker.pt`` (with the optimizer state)
    and decodes as the port does; ``--speaker`` resumes it."""
    out = str(tmp_path / "speaker")
    flags = ["--device", "cpu", "--iters", "3", "--log_every", "3",
             "--batch_size", "4", "--hDim", "32", "--wemb", "16",
             "--speaker_layer_num", "1", "--speaker_head_num", "2",
             "--synthetic_feat_dim", "16", "--synthetic_items", "16",
             "--synthetic_nodes", "12", "--maxDecode", "12",
             "--output_dir", out]
    sp, tok = train_speaker.main(flags)
    record = open(os.path.join(out, "speaker.txt")).read()
    assert "iter 3/3 loss=" in record and "bleu=" in record
    assert os.path.exists(os.path.join(out, "metrics.jsonl"))
    ckpt = os.path.join(out, "speaker.pt")

    jworld = jenv.make_synthetic_world(num_scans=2, nodes_per_scan=12,
                                       feat_dim=16, seed=0)
    items = jenv.synthetic.make_synthetic_instructions(
        jworld, 16, np.random.default_rng(0))
    jtok = JaxTokenizer(tok.words[4:])
    jsp = JaxSpeaker(jworld, feat_dim=16, vocab_size=jtok.vocab_size,
                     max_steps=8, max_len=12, hidden=32, layers=1, heads=2,
                     word_size=16)
    assert jsp.load(ckpt, load_optim=True) == 4
    np.testing.assert_array_equal(jsp.infer_batch(items[:8], jtok),
                                  sp.infer_batch(items[:8], tok))

    sp2, _ = train_speaker.main(flags[:3] + ["1"] + flags[4:]
                                + ["--speaker", ckpt])
    record = open(os.path.join(out, "speaker.txt")).read()
    assert f"resumed speaker from {ckpt} (epoch 4)" in record
    assert sp2.opt.count == 4


def test_main_nav_speaker_round_trip(tmp_path):
    """``--use_transpeaker`` saves ``speaker_latest.pt`` each interval; a
    second run loads it through ``--speaker`` (with ``--loadOptim``) and
    writes the record line."""
    common = TINY + ["--mode", "train", "--iters", "2", "--log_every", "2",
                     "--train_alg", "imitation", "--aug", "synthetic",
                     "--use_transpeaker", "--aug_times", "1", "--hDim", "32",
                     "--wemb", "16", "--speaker_layer_num", "1",
                     "--speaker_head_num", "2", "--maxDecode", "12",
                     "--output_dir", str(tmp_path)] + CPU
    main_nav.main(common + ["--name", "spk"])
    a = main_nav.parse_args(common + ["--name", "spk"])
    ckpt = os.path.join(a.ckpt_dir, "speaker_latest.pt")
    assert os.path.exists(ckpt)
    blob = torch.load(ckpt, weights_only=False)["transpeaker"]
    assert blob["epoch"] == 3
    assert int(blob["optimizer"][0]) == 0       # speakers do not train here

    main_nav.main(common + ["--name", "spk2", "--speaker", ckpt,
                            "--loadOptim"])
    b = main_nav.parse_args(common + ["--name", "spk2"])
    record = open(os.path.join(b.log_dir, "train.txt")).read()
    assert f"loaded speaker checkpoint {ckpt} (epoch 3)" in record
    loss = [ln for ln in open(os.path.join(b.log_dir, "metrics.jsonl"))
            if "loss/aug" in ln]
    assert loss
