"""Speaker training CLI: teacher-forced training and BLEU validation.

Port of ``vln_magic_tpu/cli/train_speaker.py``, the counterpart of the
reference's speaker driver loop (map_nav_src/r2r/transpeaker.py:14-358,
trained through main_nav's speaker path) as a standalone launcher: the
same flags, synthetic corpus, batch order, log lines, ``speaker.txt`` and
``speaker.pt`` (the transpeaker container, which either package's
``Speaker.load`` reads).  ``--speaker`` resumes a checkpoint with its
optimizer state.  Runs on ``--device`` (default ``cuda``; ``cpu`` on a
host without a GPU).

Usage:
    python -m vln_magic_tpu_torch.cli.train_speaker --iters 2000 \\
        --output_dir runs/speaker [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default="runs/speaker")
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--hDim", type=int, default=512)
    p.add_argument("--wemb", type=int, default=256)
    p.add_argument("--speaker", default=None,
                   help="checkpoint to resume from (transpeaker container)")
    p.add_argument("--speaker_layer_num", type=int, default=3)
    p.add_argument("--speaker_head_num", type=int, default=4)
    p.add_argument("--featdropout", type=float, default=0.3)
    p.add_argument("--maxDecode", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    # synthetic fallback knobs
    p.add_argument("--synthetic_scans", type=int, default=2)
    p.add_argument("--synthetic_nodes", type=int, default=24)
    p.add_argument("--synthetic_items", type=int, default=128)
    p.add_argument("--synthetic_feat_dim", type=int, default=64)
    args, _ = p.parse_known_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    return args


def main(argv=None):
    args = parse_args(argv)
    from ..agent.speaker import Speaker, SpeakerTokenizer
    from ..env.synthetic import (make_synthetic_instructions,
                                 make_synthetic_world)
    from ..utils.logging import MetricsLogger, write_to_record_file

    record = os.path.join(args.output_dir, "speaker.txt")
    logger = MetricsLogger(args.output_dir)
    world = make_synthetic_world(num_scans=args.synthetic_scans,
                                 nodes_per_scan=args.synthetic_nodes,
                                 feat_dim=args.synthetic_feat_dim,
                                 seed=args.seed)
    rng = np.random.default_rng(args.seed)
    items = make_synthetic_instructions(world, args.synthetic_items, rng)
    words = ("walk forward past the table then turn left at the door and "
             "stop near the lamp beside the stairs").split()
    for it in items:
        k = rng.integers(5, 12)
        it["instruction"] = " ".join(rng.choice(words, k))
    val_items = items[: max(len(items) // 5, 4)]

    tok = SpeakerTokenizer.build(items)
    sp = Speaker(world, feat_dim=args.synthetic_feat_dim,
                 vocab_size=tok.vocab_size, max_steps=8,
                 max_len=args.maxDecode, hidden=args.hDim,
                 layers=args.speaker_layer_num, heads=args.speaker_head_num,
                 word_size=args.wemb, lr=args.lr,
                 feat_dropout=args.featdropout, device=args.device)
    if args.speaker and os.path.exists(args.speaker):
        ep = sp.load(args.speaker, load_optim=True)
        write_to_record_file(f"resumed speaker from {args.speaker} "
                             f"(epoch {ep})", record)
    order = rng.permutation(len(items))
    pos = 0
    for it_num in range(1, args.iters + 1):
        if pos + args.batch_size > len(order):
            order = rng.permutation(len(items))
            pos = 0
        batch = [items[i] for i in order[pos : pos + args.batch_size]]
        pos += args.batch_size
        loss = sp.train_step(batch, tok)
        if it_num % args.log_every == 0 or it_num == args.iters:
            bleu = sp.evaluate(val_items, tok)
            logger.log(it_num, {"speaker/loss": loss, "speaker/bleu": bleu})
            write_to_record_file(
                f"iter {it_num}/{args.iters} loss={loss:.3f} bleu={bleu:.1f}",
                record)
    ckpt = os.path.join(args.output_dir, "speaker.pt")
    sp.save(args.iters, ckpt)
    write_to_record_file(f"saved speaker checkpoint {ckpt}", record)
    logger.close()
    return sp, tok


if __name__ == "__main__":
    main()
