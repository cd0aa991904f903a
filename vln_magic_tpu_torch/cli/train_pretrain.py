"""Pretraining orchestration CLI.

Port of ``vln_magic_tpu/cli/train_pretrain.py``, the counterpart of the
reference's ``pretrain_src/train_r2r_magic.py`` launcher (argparse +
JSON-config merge where the CLI wins, pretrain_src/parser.py:151-162):
``--config`` points at a training JSON (batch size, lr, steps, task ratios,
kdl block) and ``--model_config`` at a model JSON with the reference key
names (teacher_*/student_* promotion, train_r2r_magic.py:127-160).

Every ``--valid_steps`` steps it logs the mean loss and a validation to
``<output_dir>/metrics.jsonl`` and ``pretrain.txt``, saves the student as
``latest`` and ``model_step_N`` in ``<output_dir>/ckpts`` (the port's own
format, ``utils.checkpoint.CheckpointManager``) and exports
``ckpts/model_step_N.pt``, the reference container that either package's
fine-tuning loads as its pretrained trunk.  ``--checkpoint NAME`` starts
from the student saved under NAME.  Runs on ``--device`` (default
``cuda``; ``cpu`` on a host without a GPU).  ``--dp``/``--mp`` pretrain
over a dp x mp mesh, one process per device under torchrun, as
``main_nav``'s ``build_mesh`` sets it up; the global batch is
``--train_batch_size`` x dp, and only rank 0 writes.

Usage:
    python -m vln_magic_tpu_torch.cli.train_pretrain --config cfg.json \\
        --output_dir runs/pretrain [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--model_config", default=None)
    p.add_argument("--output_dir", default="runs/pretrain")
    p.add_argument("--mode", default="train")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_train_steps", type=int, default=1000)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--valid_steps", type=int, default=200)
    p.add_argument("--log_steps", type=int, default=50)
    p.add_argument("--train_kdl", action="store_true", default=False)
    p.add_argument("--checkpoint", default=None)
    # the multi-device mesh (the reference pretrains via
    # torch.distributed.launch --nproc_per_node, run_r2r_magic.sh:8);
    # --train_batch_size stays per device, the global batch is it x dp
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh axis; default WORLD_SIZE / mp")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel mesh axis (Megatron splits)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    # synthetic fallback knobs
    p.add_argument("--synthetic_scans", type=int, default=2)
    p.add_argument("--synthetic_nodes", type=int, default=24)
    p.add_argument("--synthetic_items", type=int, default=128)
    p.add_argument("--synthetic_feat_dim", type=int, default=64)
    args, _ = p.parse_known_args(argv)

    # JSON-config merge, CLI wins (pretrain_src/parser.py:151-162)
    if args.config and os.path.exists(args.config):
        with open(args.config) as f:
            blob = json.load(f)
        given = {a.split("=")[0].lstrip("-") for a in (argv or [])}
        for k, v in blob.items():
            if hasattr(args, k) and k not in given:
                setattr(args, k, v)
        args.config_blob = blob
    else:
        args.config_blob = {}
    return args


def reference_pretrain_flags(blob: dict) -> tuple[dict, dict]:
    """Translate the reference pretrain JSON schema into flag names
    from_reference_flags understands, plus the task-mix ratios.

    Handles the nested ``kdl`` block's distinct key spellings
    (r2r_magic_pretrain.json: knowledge_distillation / kd_alpha /
    kd_temperature / kd_loss / kdl_logits_loss / train_teacher) and
    ``train_datasets.<name>.tasks`` + ``mix_ratio`` lists
    (train_r2r_magic.py:42-73 create_dataloaders)."""
    flags = dict(blob)
    kdl = blob.get("kdl") or {}
    rename = {
        "knowledge_distillation": "train_kdl",
        "kd_alpha": "kdl_alpha",
        "kd_temperature": "kdl_temperature",
        "kd_loss": "kdl_feat_loss",
        "kdl_logits_loss": "kdl_logit_loss",
        "train_teacher": "train_kdl_teacher",
    }
    for k, v in kdl.items():
        flags.setdefault(rename.get(k, k), v)
    # top-level spellings that differ from the nav parser
    for src, dst in (("learning_rate", "lr"), ("grad_norm", "grad_clip"),
                     ("max_txt_len", "max_instr_len"),
                     ("num_train_steps", "iters"),
                     ("warmup_steps", "warmup_iters")):
        if src in blob:
            flags.setdefault(dst, blob[src])
    ratios = None
    for ds in (blob.get("train_datasets") or {}).values():
        tasks = ds.get("tasks")
        mix = ds.get("mix_ratio")
        if tasks:
            ratios = dict(zip(tasks, mix or [1] * len(tasks)))
            break
    return flags, ratios


def main(argv=None):
    args = parse_args(argv)
    from ..config import from_reference_flags
    from ..env.synthetic import make_synthetic_instructions, make_synthetic_world
    from ..pretrain.trainer import PretrainTrainer
    from ..utils.checkpoint import CheckpointManager, save_reference_checkpoint
    from ..parallel import full_state_dict
    from ..utils.logging import MetricsLogger, write_to_record_file
    from .main_nav import build_mesh, leave_mesh

    os.makedirs(args.output_dir, exist_ok=True)
    record = os.path.join(args.output_dir, "pretrain.txt")
    logger = MetricsLogger(args.output_dir)

    model_blob = {}
    model_cfg_path = args.model_config or args.config_blob.get("model_config")
    if model_cfg_path and os.path.exists(model_cfg_path):
        with open(model_cfg_path) as f:
            model_blob = json.load(f)
    cfg_flags, cfg_ratios = reference_pretrain_flags(args.config_blob)
    flags = {**model_blob, **cfg_flags}
    flags.setdefault("train_kdl", args.train_kdl)
    mesh = build_mesh(args) if args.mode == "train" else None
    batch_size = args.train_batch_size
    if mesh is not None:
        batch_size *= mesh.shape["dp"]   # per-device batch x dp (DDP)
        if mesh.rank == 0:
            print(f"mesh: dp={mesh.shape['dp']} x mp={mesh.shape['mp']} "
                  f"(global batch {batch_size})")
    cfg = from_reference_flags(flags)
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model,
                                  image_feat_size=args.synthetic_feat_dim,
                                  vocab_size=min(cfg.model.vocab_size, 2000)),
        train=dataclasses.replace(cfg.train,
                                  batch_size=batch_size,
                                  lr=args.learning_rate, seed=args.seed))
    if cfg.teacher_model is not None:
        cfg = dataclasses.replace(
            cfg, teacher_model=dataclasses.replace(
                cfg.teacher_model, image_feat_size=args.synthetic_feat_dim,
                vocab_size=min(cfg.teacher_model.vocab_size, 2000)))

    world = make_synthetic_world(num_scans=args.synthetic_scans,
                                 nodes_per_scan=args.synthetic_nodes,
                                 feat_dim=args.synthetic_feat_dim,
                                 seed=args.seed)
    rng = np.random.default_rng(args.seed)
    train_items = make_synthetic_instructions(world, args.synthetic_items, rng,
                                              vocab_size=cfg.model.vocab_size)
    val_items = make_synthetic_instructions(world, args.synthetic_items // 4,
                                            rng, vocab_size=cfg.model.vocab_size)

    trainer = PretrainTrainer(cfg, world,
                              builder_kwargs=dict(max_steps=8, max_gmap=32),
                              device=args.device)
    ckpt_dir = os.path.join(args.output_dir, "ckpts")
    mgr = CheckpointManager(ckpt_dir)
    if args.checkpoint and mgr.has(args.checkpoint):
        trainer.model.load_state_dict(mgr.restore(args.checkpoint,
                                                  map_location=trainer.device))
    if mesh is not None:
        trainer.use_mesh(mesh)   # after the restore: shards whatever loaded

    ratios = cfg_ratios or args.config_blob.get(
        "mix_ratio", {"mlm": 1, "sap": 1, "cfp": 1})
    done = 0
    while done < args.num_train_steps:
        n = min(args.valid_steps, args.num_train_steps - done)
        hist = trainer.fit(train_items, n, task_ratios=ratios)
        done += n
        mean_loss = float(np.mean([h["loss"] for h in hist]))
        logger.log(done, {"pretrain/loss": mean_loss})
        val = trainer.validate(val_items, num_batches=2)
        logger.log(done, {f"val/{k}": v for k, v in val.items()})
        write_to_record_file(
            f"step {done}/{args.num_train_steps} loss={mean_loss:.3f} "
            + " ".join(f"{k}={v:.3f}" for k, v in val.items()), record)
        # whole leaves on a mesh; rank 0 writes
        state = full_state_dict(trainer.model)
        mgr.save("latest", state)
        mgr.save(f"model_step_{done}", state)
        # the reference container for the --bert_ckpt_file fine-tune flow
        save_reference_checkpoint(
            trainer.model, os.path.join(ckpt_dir, f"model_step_{done}.pt"),
            epoch=done)
    logger.close()
    if mesh is not None:
        leave_mesh()
    return trainer


if __name__ == "__main__":
    main()
