"""Navigation train/valid/serve CLI.

Port of ``vln_magic_tpu/cli/main_nav.py``, the counterpart of the
reference's entry point (reference: map_nav_src/r2r/main_nav.py +
parser.py): the reference's public flag names verbatim (unknown flags are
tolerated, as upstream does via ``parse_known_args``) plus ``--device``
(default ``cuda``; ``cpu`` on a host without a GPU).  It reads R2R/RxR
annotations, connectivity, the candidate-view file and the CLIP view
features (``data/``) under ``--root_dir``, or builds the synthetic world
when that tree is absent, and runs one mode:

- ``valid``: greedy decode of every validation split (and ``test`` under
  ``--test``/``--submit``), metrics to ``logs/valid.txt``, submission files
  ``preds/submit_<split>.json`` under ``--submit``, per-node stop
  probabilities under ``--detailed_output``; the MAGIC teacher too under
  ``--train_kdl --teacher_resume_file``.  Model selection follows the
  reference: spl+sr for R2R, nDTW+SDTW for RxR (main_nav.py:473-486).
- ``train``: imitation / DAgger fine-tuning with distillation
  (``agent.trainer.Trainer``), validation each ``--log_every`` iterations,
  ``best_<split>.pt``, ``latest_dict.pt`` and the resumable train state;
  SIGTERM saves the train state and exits 143.
- ``serve``: the JSON-lines robot control protocol over stdin/stdout
  (``agent.serving``).
- ``extract_cfp_features``: the frontdoor CFP feature TSV of the train
  split, ``preds/cfp_features_<epoch>.tsv``.

The causal interventions (``--do_back_txt``, ``--do_front_txt|img|his``)
take their dictionaries from the ``--*_backdoor_dict_file``/
``--*_frontdoor_dict_file`` TSVs when given, else rebuild them from the
model on the train split (``agent/interventions.py``); training refreshes
them at iteration 0, every ``--update_iter`` and on each new best
(``--z_instr_update`` for the backdoor), writing
``ckpts/cfp_features_<role>_<it>.tsv``.  ``--ensemble_n`` > 1 validates with
MC-dropout ensembles.

The weights files are the reference ``.pt`` container, which the JAX
package reads and writes too (``utils.checkpoint``); optimizer sidecars,
train states and serving bundles are this package's own.  Like the JAX
CLI, no flag turns on ``ModelConfig.use_pallas_attention``, so no CUDA
kernel of ``ops/attention.py`` runs in any mode.

``train`` and ``valid`` run over a dp x mp mesh (``parallel``) under
``--dp``/``--mp`` (``--world_size`` is a dp hint), one process per device,
as torchrun starts them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); ``--batch_size`` is then per device and
the global batch ``--batch_size`` x dp (DDP semantics), and only rank 0
writes logs, checkpoints and submissions:

    torchrun --nproc_per_node 2 -m vln_magic_tpu_torch.cli.main_nav \
        --mode train --dp 2 ...

Usage:
    python -m vln_magic_tpu_torch.cli.main_nav --mode valid --name exp1 ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="vln_magic_tpu_torch navigation")
    # identity / IO (reference parser.py:8-31)
    p.add_argument("--root_dir", type=str, default="")
    p.add_argument("--dataset", type=str, default="r2r", choices=["r2r", "rxr"])
    p.add_argument("--output_dir", type=str, default="runs")
    p.add_argument("--name", type=str, default="debug")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", type=str, required=True)
    p.add_argument("--tokenizer", default="roberta")
    # RxR language filter; the reference hard-codes English
    # (data_utils.py:163-178).  "en hi te" or "all" keeps multilingual
    # splits (RxR ships XLM-R encodings, so no retokenization needed).
    p.add_argument("--langs", nargs="+", default=["en"])
    p.add_argument("--iters", type=int, default=200000)
    p.add_argument("--log_every", type=int, default=1000)
    p.add_argument("--eval_first", action="store_true", default=False)
    # data (parser.py:33-36)
    p.add_argument("--max_instr_len", type=int, default=200)
    p.add_argument("--max_action_len", type=int, default=15)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--ignoreid", type=int, default=-100)
    p.add_argument("--for_debug", action="store_true", default=False)
    # checkpoints (parser.py:38-44)
    p.add_argument("--resume_file", default=None)
    p.add_argument("--teacher_resume_file", default=None)
    p.add_argument("--bert_ckpt_file", default=None)
    p.add_argument("--aug", default=None)
    # optimization (parser.py:73-101)
    p.add_argument("--ml_weight", type=float, default=0.2)
    p.add_argument("--optim", type=str, default="adamW")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--train_alg", choices=["imitation", "dagger"],
                   default="dagger")
    p.add_argument("--dagger_sample", default="sample")
    p.add_argument("--feedback", type=str, default="sample")
    p.add_argument("--expert_policy", default="spl", choices=["spl", "ndtw"])
    p.add_argument("--use_lr_sch", action="store_true", default=False)
    p.add_argument("--lr_sch", type=str, default="polynomial")
    p.add_argument("--test", action="store_true", default=False)
    p.add_argument("--submit", action="store_true", default=False)
    # model dims (parser.py:56-58, 173-195)
    p.add_argument("--num_l_layers", type=int, default=6)
    p.add_argument("--num_pano_layers", type=int, default=2)
    p.add_argument("--num_x_layers", type=int, default=3)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--feat_dropout", type=float, default=0.4)
    p.add_argument("--features", type=str, default="clip768")
    p.add_argument("--angle_feat_size", type=int, default=4)
    p.add_argument("--student_hidden_size", type=int, default=384)
    p.add_argument("--student_num_attention_heads", type=int, default=6)
    p.add_argument("--teacher_hidden_size", type=int, default=768)
    p.add_argument("--teacher_num_attention_heads", type=int, default=12)
    # distillation (parser.py:145-197)
    p.add_argument("--train_kdl", action="store_true", default=False)
    p.add_argument("--train_kdl_noFeat", action="store_true", default=False)
    p.add_argument("--train_kdl_noAttn", action="store_true", default=False)
    p.add_argument("--train_kdl_noLogit", action="store_true", default=False)
    p.add_argument("--kd_ability_types", nargs="+", type=str,
                   default=["txt", "img", "local", "global", "action"])
    p.add_argument("--kdl_feat_loss", type=str, default="mse")
    p.add_argument("--kdl_attn_loss", type=str, default="mse")
    p.add_argument("--kdl_logit_loss", type=str, default="kd")
    p.add_argument("--kdl_temperature", type=float, default=1)
    p.add_argument("--kdl_alpha", type=float, default=0.5)
    p.add_argument("--kdl_dkd_alpha", type=float, default=1.0)
    p.add_argument("--kdl_dkd_beta", type=float, default=8.0)
    p.add_argument("--kd_loss_type", type=str, default="sum")
    p.add_argument("--train_kdl_teacher", action="store_true", default=False)
    p.add_argument("--t_lr", type=float, default=5e-6)
    p.add_argument("--t_kdl_alpha", type=float, default=0.5)
    p.add_argument("--kdl_adaptive_ability_weight", action="store_true",
                   default=False)
    p.add_argument("--kdl_adaptive_ability_weight_type", type=str, default="RW")
    p.add_argument("--rw_temp", type=float, default=1.0)
    p.add_argument("--aw_update_iter", type=int, default=3000)
    p.add_argument("--teacher_sample_hard_mining", action="store_true",
                   default=False)
    p.add_argument("--t_sample_preprocess", type=str, default="exp")
    p.add_argument("--t_sample_preprocess_exp_decay", type=float, default=0.7)
    # causal learning (parser.py:128-143)
    p.add_argument("--do_back_img", action="store_true", default=False)
    p.add_argument("--do_back_txt", action="store_true", default=False)
    p.add_argument("--do_front_img", action="store_true", default=False)
    p.add_argument("--do_front_his", action="store_true", default=False)
    p.add_argument("--do_front_txt", action="store_true", default=False)
    p.add_argument("--do_back_txt_type", type=str, default="type_2")
    p.add_argument("--do_add_method", type=str, default="door")
    p.add_argument("--z_instr_update", action="store_true", default=False)
    p.add_argument("--update_iter", type=int, default=3000)
    p.add_argument("--front_n_clusters", type=int, default=24)
    # remaining reference flags, verbatim names (map_nav_src/r2r/parser.py).
    # Wired ones are consumed below / via config._FLAG_MAP; the rest are
    # accepted no-ops whose reference role the design absorbs (dataloader
    # workers -> device tables; etc.)
    p.add_argument("--world_size", type=int, default=1)       # dp size hint
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--node_rank", type=int, default=0)
    # the JAX package's mesh axes (the reference's counterpart is
    # torch.distributed.launch + DDP, main_nav.py:681): one process per
    # device under torchrun (build_mesh)
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh axis (episode-batch rows); "
                        "default WORLD_SIZE / mp")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel mesh axis (Megatron column/row "
                        "splits)")
    p.add_argument("--num_workers", type=int, default=0)      # tables, no loaders
    p.add_argument("--enc_full_graph", action="store_true", default=True)
    p.add_argument("--fusion", default="dynamic",
                   choices=["global", "local", "avg", "dynamic"])
    p.add_argument("--expl_max_ratio", type=float, default=0.6)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--entropy_loss_weight", type=float, default=0.01)
    p.add_argument("--cat_file", type=str, default=None)      # landmark categories
    p.add_argument("--featdropout", type=float, default=None) # legacy alias
    p.add_argument("--image_feat_size", type=int, default=None)
    p.add_argument("--views", type=int, default=36)
    p.add_argument("--ensemble_n", type=int, default=1)       # MC-dropout eval
    p.add_argument("--save_optimizer", action="store_true", default=False)
    p.add_argument("--resume_optimizer", action="store_true", default=False)
    p.add_argument("--loadOptim", dest="load_optim", action="store_const",
                   default=False, const=True)                 # legacy alias
    p.add_argument("--do_back_img_type", type=str, default="type_1")
    p.add_argument("--act_visited_nodes", action="store_true", default=False)
    p.add_argument("--fix_lang_embedding", action="store_true", default=False)
    p.add_argument("--fix_local_branch", action="store_true", default=False)
    p.add_argument("--fix_pano_embedding", action="store_true", default=False)
    p.add_argument("--accumulateGrad", dest="accumulate_grad",
                   action="store_const", default=False, const=True)
    p.add_argument("--epsilon", type=float, default=0.1)
    p.add_argument("--decay", dest="weight_decay", type=float, default=0.0)
    # per-role dims (parser.py:173-195); None -> the shared --num_* values
    for role in ("student", "teacher"):
        p.add_argument(f"--{role}_num_l_layers", type=int, default=None)
        p.add_argument(f"--{role}_num_pano_layers", type=int, default=None)
        p.add_argument(f"--{role}_num_x_layers", type=int, default=None)
        p.add_argument(f"--{role}_mlp_ratio", type=int, default=None)
        p.add_argument(f"--{role}_intermediate_size", type=int, default=None)
        p.add_argument(f"--{role}_bert_ckpt_file", default=None)
    # intervention dictionary files (parser.py:236-259): when provided, the
    # z-dicts load from these TSVs instead of being rebuilt from the model
    p.add_argument("--backdoor_dict_file", default=None)
    p.add_argument("--s_backdoor_dict_file", default=None)
    p.add_argument("--t_backdoor_dict_file", default=None)
    p.add_argument("--frontdoor_dict_file", default=None)
    p.add_argument("--s_frontdoor_dict_file", default=None)
    p.add_argument("--t_frontdoor_dict_file", default=None)
    # speaker / back-translation (parser.py:103-126)
    p.add_argument("--speaker", default=None)                 # speaker ckpt
    p.add_argument("--use_transpeaker", action="store_true", default=False)
    p.add_argument("--use_drop", action="store_true", default=False)
    p.add_argument("--speaker_dropout", type=float, default=0.2)
    p.add_argument("--speaker_angle_size", type=int, default=128)
    p.add_argument("--speaker_layer_num", type=int, default=3)
    p.add_argument("--speaker_head_num", type=int, default=4)
    p.add_argument("--maxDecode", dest="max_decode", type=int, default=120)
    p.add_argument("--wemb", type=int, default=256)
    p.add_argument("--hDim", dest="h_dim", type=int, default=512)
    p.add_argument("--proj_hidden", type=int, default=1024)
    p.add_argument("--aemb", type=int, default=64)
    p.add_argument("--subout", dest="sub_out", type=str, default="tanh")
    p.add_argument("--use_aug_env", action="store_true", default=False)
    p.add_argument("--env_edit", action="store_true", default=False)
    p.add_argument("--obj_features", type=str, default="vitbase")
    p.add_argument("--obj_ft_dim", type=int, default=768)
    # env shape (framework addition: the reference pads gmaps to the batch
    # max; fixed shapes need the budget explicit and raisable per dataset)
    p.add_argument("--max_gmap_len", type=int, default=None,
                   help="gmap token budget; default 128 (r2r) / 208 (rxr: "
                        "28 actions can observe ~170 nodes)")
    p.add_argument("--feat_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="view-feature table storage dtype; bfloat16 halves "
                        "its device memory (~1.7 vs ~3.4 GB at 90 scans), "
                        "compute stays f32")
    p.add_argument("--aug_times", type=int, default=1)
    p.add_argument("--detailed_output", action="store_true", default=False)
    # preemption safety (SURVEY §5.3 rebuild item): resume from the latest
    # emergency/periodic train state automatically
    p.add_argument("--auto_resume", action="store_true", default=False)
    # synthetic fallback knobs (framework addition)
    p.add_argument("--synthetic_scans", type=int, default=2)
    p.add_argument("--synthetic_nodes", type=int, default=24)
    p.add_argument("--synthetic_items", type=int, default=64)
    # None sentinel: --mode serve must NOT silently shrink a production
    # model just because no dataset tree is mounted (robot deployments have
    # none); the rewrite applies only when set explicitly there
    p.add_argument("--synthetic_feat_dim", type=int, default=None)
    # --mode serve knobs (online robot control loop, agent/serving.py)
    p.add_argument("--serve_max_nodes", type=int, default=None,
                   help="node-slot budget of an online serving session; "
                        "default follows the dataset's --max_gmap_len")
    p.add_argument("--serve_bundle", type=str, default=None,
                   help="load the serving endpoint from a deployment "
                        "bundle directory (NavServer.export_bundle).  The "
                        "bundle pins the FULL config and slot budgets: "
                        "--resume_file, --serve_max_nodes/--serve_max_cands, "
                        "--fusion and every other model/env flag are ignored "
                        "(a warning is printed if passed)")
    p.add_argument("--export_serve_bundle", type=str, default=None,
                   help="write a serving bundle to this directory and "
                        "exit (use with --mode serve; --resume_file supplies "
                        "the weights)")
    p.add_argument("--serve_bundle_int8", action="store_true", default=False,
                   help="store the exported bundle's weights per-channel "
                        "int8 (~4x smaller artifact; dequantized at load)")
    p.add_argument("--serve_bundle_platforms", type=str, default=None,
                   help="the JAX package's lowering targets; accepted and "
                        "ignored: this package's bundle holds weights, "
                        "which load on any device")
    p.add_argument("--serve_max_cands", type=int, default=10,
                   help="candidate-slot budget per node in serving mode")

    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")

    args, _ = p.parse_known_args(argv)
    import sys as _sys

    args._raw_argv = list(argv) if argv is not None else _sys.argv[1:]
    # legacy aliases
    args.resume_optimizer = args.resume_optimizer or args.load_optim
    out_root = os.path.join(args.output_dir,
                            "navigator" if "train" in args.mode else "test",
                            args.name)
    args.ckpt_dir = os.path.join(out_root, "ckpts")
    args.log_dir = os.path.join(out_root, "logs")
    args.pred_dir = os.path.join(out_root, "preds")
    for d in (args.ckpt_dir, args.log_dir, args.pred_dir):
        os.makedirs(d, exist_ok=True)
    args.connectivity_dir = os.path.join(args.root_dir, "R2R", "connectivity")
    args.anno_dir = os.path.join(args.root_dir, "R2R", "annotations")
    args.img_ft_file = os.path.join(args.root_dir, "R2R", "features",
                                    "CLIP-ViT-B-16-views.hdf5")
    # EnvEdit-augmented feature table (reference postprocess_args:220-227)
    args.aug_img_ft_file = os.path.join(
        args.root_dir, "EnvEdit", "hamt_features",
        "CLIP-ViT-B-16-views-st-samefilter.hdf5")
    return args


def build_mesh(args):
    """The dp x mp mesh of ``--mode train/valid`` (JAX ``build_mesh``; the
    reference's init_distributed + DDP wrap, main_nav.py:681), or ``None``
    for a 1 x 1 mesh.  dp is ``--dp``, else ``--world_size`` when above 1
    (the reference flag as a dp hint), else the torchrun ``WORLD_SIZE`` /
    mp.  dp x mp must be the world size (``SystemExit`` otherwise, before
    any group starts).  The process group starts on ``cuda:LOCAL_RANK``
    (NCCL), or on the CPU (gloo) under ``--device cpu``; ``args.device``
    becomes the rank's device."""
    from ..parallel import init_distributed, make_mesh

    mp = max(args.mp, 1)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.dp is not None:
        dp = args.dp
    elif getattr(args, "world_size", 1) > 1:
        dp = args.world_size
    else:
        dp = max(world // mp, 1)
    if dp * mp <= 1:
        return None
    if dp * mp != world:
        raise SystemExit(f"--dp {dp} x --mp {mp} needs {dp * mp} devices; "
                         f"{world} visible (WORLD_SIZE)")
    dev = init_distributed(args.device)
    args.device = str(dev)
    return make_mesh(dp * mp, mp=mp, device=dev)


def feature_store(args, feat_dim: int):
    """The view-feature store of a dataset tree: the CLIP HDF5 file when it
    exists, else the deterministic hash store (main_nav.py:312-313)."""
    from ..data import HashFeatureStore, ImageFeatureStore

    if os.path.exists(args.img_ft_file):
        return ImageFeatureStore(args.img_ft_file, feat_dim)
    return HashFeatureStore(feat_dim)


def aug_feature_table(args, world):
    """The EnvEdit feature table of ``--env_edit``/``--use_aug_env``, in
    the world's feature layout, else None: the tree's EnvEdit HDF5 file
    when it exists, else the hash store at seed 1 (``args.seed + 1`` on
    the synthetic world), as JAX's ``build_dataset`` builds it."""
    if not (args.env_edit or args.use_aug_env):
        return None
    from ..data import HashFeatureStore, ImageFeatureStore

    dim = world.tables.features.shape[-1]
    if not os.path.isdir(args.connectivity_dir):
        return build_aug_table(world, HashFeatureStore(dim,
                                                       seed=args.seed + 1))
    if os.path.exists(args.aug_img_ft_file):
        store = ImageFeatureStore(args.aug_img_ft_file, dim)
        try:
            return build_aug_table(world, store)
        finally:
            store.close()
    return build_aug_table(world, HashFeatureStore(dim, seed=1))


def build_aug_table(world, store):
    """An alternate per-scan view-feature table shaped like
    ``world.tables.features`` from ``store`` (the EnvEdit aug DB,
    reference env.py:39,78; JAX's ``_build_aug_table``)."""
    t = world.tables
    aug = np.zeros_like(np.asarray(t.features))
    fn = store.feature_fn()
    for si, g in enumerate(world.graphs):
        aug[si, : g.num_nodes] = fn(g.scan, g.node_ids)
    return aug


def build_dataset(args, cfg):
    """World + per-split item lists; real data when mounted, synthetic
    otherwise (main_nav.py:31-163 equivalent)."""
    from ..env.graph import load_connectivity
    from ..env.world import World

    feat_dim = cfg.model.image_feat_size
    # bf16 halves the [S, N, 36, D] feature table's device memory; compute
    # casts to f32 at the read (rollout.assemble_pano)
    feat_dtype = np.float32
    if args.feat_dtype == "bfloat16":
        import ml_dtypes

        feat_dtype = ml_dtypes.bfloat16
    if os.path.isdir(args.connectivity_dir):
        from ..data import ImageFeatureStore, construct_instrs, get_tokenizer
        from ..data.annotations import attach_path_indices

        tok = get_tokenizer(os.path.join(args.root_dir, "pretrained", "roberta"))
        splits = {}
        # the test env exists for leaderboard submission (main_nav.py:617-622)
        names = ["train", "val_seen", "val_unseen"]
        if args.test or args.submit:
            names.append("test")
        for split in names:
            try:
                splits[split] = construct_instrs(
                    args.anno_dir, args.dataset, [split], tok,
                    args.max_instr_len, args.for_debug,
                    langs=None if "all" in args.langs else tuple(args.langs))
            except FileNotFoundError:
                continue
        # EnvEdit/aug annotation file for the aug-alternation env
        # (--aug, main_nav.py aug env; reference parser.py:41)
        if args.aug and os.path.exists(args.aug):
            splits["aug"] = construct_instrs(
                os.path.dirname(args.aug), args.dataset,
                [os.path.basename(args.aug)], tok, args.max_instr_len,
                args.for_debug)
        scans = sorted({it["scan"] for items in splits.values() for it in items})
        store = feature_store(args, feat_dim)
        graphs = [load_connectivity(args.connectivity_dir, s) for s in scans]
        # precomputed candidate views/angles (parser.py:261); synthesized
        # from connectivity geometry when the file is absent
        scanvp_cands = None
        cands_path = os.path.join(args.anno_dir,
                                  "scanvp_candview_relangles.json")
        if os.path.exists(cands_path):
            from ..env.world import load_scanvp_candidates

            scanvp_cands = load_scanvp_candidates(cands_path)
        try:
            world = World(graphs, store.feature_fn(), feat_dim,
                          feat_dtype=feat_dtype, scanvp_cands=scanvp_cands)
        finally:
            if isinstance(store, ImageFeatureStore):
                store.close()
        splits = {k: attach_path_indices(v, world) for k, v in splits.items()}
        return world, splits

    # synthetic fallback
    from ..env.synthetic import make_synthetic_instructions, make_synthetic_world

    world = make_synthetic_world(
        num_scans=args.synthetic_scans, nodes_per_scan=args.synthetic_nodes,
        feat_dim=feat_dim, seed=args.seed, feat_dtype=feat_dtype)
    rng = np.random.default_rng(args.seed)
    n = args.synthetic_items
    splits = {
        "train": make_synthetic_instructions(world, n, rng),
        "val_seen": make_synthetic_instructions(world, max(n // 4, 4), rng),
        "val_unseen": make_synthetic_instructions(world, max(n // 4, 4), rng),
    }
    if args.test or args.submit:
        splits["test"] = make_synthetic_instructions(world, max(n // 4, 4), rng)
    if args.aug:
        splits["aug"] = make_synthetic_instructions(world, n, rng)
    return world, splits


def _score(avg, dataset):
    # best-model criterion (main_nav.py:473-486)
    if dataset == "rxr":
        return avg["nDTW"] + avg["SDTW"]
    return avg["spl"] + avg["sr"]


def _make_cfp_builder(cfg, world):
    from ..pretrain.tasks import PathDataBuilder

    return PathDataBuilder(
        world, max_steps=min(cfg.env.max_action_len + 1, 20),
        max_gmap=cfg.env.max_gmap_len, max_txt=cfg.env.max_instr_len,
        angle_feat_size=cfg.model.angle_feat_size,
        vocab_size=cfg.model.vocab_size, seed=cfg.train.seed)


def _word_picker(args):
    from ..agent.interventions import WordPicker

    return WordPicker(cat_file=args.cat_file if args.cat_file
                      and os.path.exists(args.cat_file) else None)


def _front_flags(mcfg) -> bool:
    return mcfg.do_front_txt or mcfg.do_front_img or mcfg.do_front_his


def refresh_intervention_dicts(args, cfg, trainer, world, items, it,
                               record=None):
    """Backdoor z-dict + frontdoor CFP dictionary refresh of each role
    (the reference refreshes at iter 0, every ``update_iter`` and on each
    new best, main_nav.py:218-222,439-444,488-494): the backdoor under
    ``--z_instr_update``, the frontdoor's CFP features written to
    ``ckpts/cfp_features_<role>_<it>.tsv``, k-means and a pick seeded
    ``seed + it``.  Sets and returns ``trainer.zdicts``.  Each role's
    language forward (under the trainer's autocast) and the CFP batch
    builder are cached on the trainer."""
    import dataclasses
    from types import SimpleNamespace

    from ..agent.interventions import (KMeansPicker, build_rollout_zdicts,
                                       extract_cfp_features, save_cfp_tsv,
                                       update_backdoor_dict)
    from ..utils.dist import is_primary
    from ..utils.logging import write_to_record_file

    cache = trainer.__dict__.setdefault("_zrefresh_cache", {})
    roles = [("student", trainer.model, cfg.model)]
    if trainer.kdl and cfg.teacher_model is not None:
        roles.append(("teacher", trainer.teacher_model, cfg.teacher_model))
    zd_all = {}
    for role, model, mcfg in roles:
        shim = SimpleNamespace(model=model,
                               cfg=dataclasses.replace(cfg, model=mcfg))
        back = front = None
        if mcfg.do_back_txt and args.z_instr_update:
            key = f"lang/{role}"
            if key not in cache:
                def lang(ids, mask, m=model):
                    with trainer.autocast():
                        return m.language(ids, mask)
                cache[key] = lang
            back = update_backdoor_dict(shim, items, _word_picker(args),
                                        lang_fn=cache[key])
        if _front_flags(mcfg):
            if "builder" not in cache:
                cache["builder"] = _make_cfp_builder(cfg, world)
            feats, ids = extract_cfp_features(shim, items, cache["builder"],
                                              autocast=trainer.autocast)
            if is_primary():        # every rank computes the same rows
                save_cfp_tsv(os.path.join(
                    args.ckpt_dir, f"cfp_features_{role}_{it}.tsv"), feats,
                    ids)
            front = KMeansPicker(
                feats, args.front_n_clusters,
                seed=cfg.train.seed).random_pick_front_features(
                np.random.default_rng(cfg.train.seed + it))
        z = build_rollout_zdicts(back, front, pad_entries=81)
        if z:
            zd_all[role] = z
    trainer.zdicts = zd_all
    if record and zd_all:
        write_to_record_file(
            f"iter {it}: refreshed intervention dicts for "
            f"{sorted(zd_all)}", record)
    return zd_all


def load_intervention_dict_files(args, cfg):
    """The dictionaries of the reference's TSV files, for the flags that
    name existing files (parser.py:236-259; main_nav.py:574-592):
    ``{role: rollout z-dicts}`` for each role with at least one file."""
    from ..agent.interventions import (KMeansPicker, build_rollout_zdicts,
                                       load_backdoor_tsv, load_cfp_tsv)

    out = {}
    role_files = {
        "student": (args.s_backdoor_dict_file or args.backdoor_dict_file,
                    args.s_frontdoor_dict_file or args.frontdoor_dict_file),
        "teacher": (args.t_backdoor_dict_file or args.backdoor_dict_file,
                    args.t_frontdoor_dict_file or args.frontdoor_dict_file),
    }
    dims = {"student": cfg.model.hidden_size,
            "teacher": (cfg.teacher_model.hidden_size
                        if cfg.teacher_model else cfg.model.hidden_size)}
    for role, (back_f, front_f) in role_files.items():
        back = front = None
        if back_f and os.path.exists(back_f):
            back = load_backdoor_tsv(back_f, dims[role])
        if front_f and os.path.exists(front_f):
            feats, _ = load_cfp_tsv(front_f, dims[role])
            front = KMeansPicker(
                feats, args.front_n_clusters,
                seed=cfg.train.seed).random_pick_front_features(
                np.random.default_rng(cfg.train.seed))
        z = build_rollout_zdicts(back, front, pad_entries=81)
        if z:
            out[role] = z
    return out


def _gmap_overflow_warning(split, n, cfg):
    return (f"WARNING: {split}: {n} episodes overflowed max_gmap_len="
            f"{cfg.env.max_gmap_len} (gmap tokens truncated); "
            f"raise --max_gmap_len")


def train(args, cfg, world, splits, mesh=None):
    """``--mode train``: ``Trainer.fit`` in intervals of ``--log_every``,
    with the train state saved after each; ``--aug`` batches (on the
    EnvEdit table, ``aug_feature_table``) alternate with the train split's
    every ``--aug_times`` (back-translated first by a speaker under
    ``--use_transpeaker``, loaded from ``--speaker`` and saved as
    ``speaker_latest.pt`` each interval), and the ``grad`` ability weights
    are refreshed at iteration 0 and every ``--aw_update_iter``."""
    import signal

    from ..agent.navigator import Navigator
    from ..agent.trainer import Trainer
    from ..utils.checkpoint import (restore_reference_checkpoint,
                                    save_reference_checkpoint)
    from ..utils.logging import MetricsLogger, write_to_record_file

    from ..utils.dist import is_primary

    record = os.path.join(args.log_dir, "train.txt")
    logger = MetricsLogger(args.log_dir)
    if is_primary():
        with open(os.path.join(args.log_dir, "training_args.json"),
                  "w") as f:
            json.dump({k: v for k, v in vars(args).items()
                       if isinstance(v, (int, float, str, bool, list,
                                         type(None)))}, f, indent=2)

    trainer = Trainer(cfg, world, device=args.device,
                      aug_features=aug_feature_table(args, world))
    resumed = False
    if args.auto_resume:
        # preemption recovery: pick up the full train state (params, both
        # optimizers, iteration, rng) written periodically / on SIGTERM
        resumed = trainer.load_state(args.ckpt_dir)
        if resumed:
            write_to_record_file(
                f"auto-resumed train state at iter {trainer.iteration}",
                record)
    if args.resume_file and not resumed:
        # --resume_optimizer / legacy --loadOptim (parser.py:40,116): the
        # sidecar that --save_optimizer wrote
        epoch, miss, unexp = trainer.load(
            args.resume_file, resume_optimizer=args.resume_optimizer)
        write_to_record_file(
            f"resumed {args.resume_file} (epoch {epoch}, "
            f"{len(miss)} missing, {len(unexp)} unexpected)", record)
    if args.teacher_resume_file and trainer.teacher_model is not None \
            and not resumed:
        restore_reference_checkpoint(
            trainer.teacher_model, args.teacher_resume_file,
            drop_kd_heads=not cfg.distill.train_teacher)
    # pretraining trunk checkpoints: strip the bert. prefix, drop task heads
    # (parser.py:44 --bert_ckpt_file; per-role student/teacher variants)
    s_bert = args.student_bert_ckpt_file or args.bert_ckpt_file
    if s_bert and not resumed:
        miss, _ = trainer.load_pretrained(s_bert, "student")
        write_to_record_file(
            f"loaded pretrain trunk {s_bert} "
            f"({len(miss)} params left at init)", record)
    if args.teacher_bert_ckpt_file and trainer.teacher_model is not None \
            and not resumed:
        trainer.load_pretrained(args.teacher_bert_ckpt_file, "teacher")
    if mesh is not None:
        # after every load: use_mesh shards whatever the checkpoints left
        trainer.use_mesh(mesh)
        write_to_record_file(
            f"mesh: dp={mesh.shape['dp']} x mp={mesh.shape['mp']}, global "
            f"batch {cfg.train.batch_size}", record)

    # SIGTERM (preemption) -> emergency train-state checkpoint, then exit
    # 143.  A train step updates the parameters tensor by tensor, so inside
    # ``fit`` the signal is only noted and acted on when the step in flight
    # has ended (JAX's step rebinds whole trees, so its handler saves at
    # once); elsewhere the handler saves at once.
    in_fit, pending = [False], []

    def _save_and_exit():
        path = trainer.save_state(args.ckpt_dir)
        write_to_record_file(
            f"SIGTERM at iter {trainer.iteration}: emergency train state "
            f"saved to {path}", record)
        raise SystemExit(143)

    def _on_sigterm(signum, frame):
        if in_fit[0]:
            pending.append(signum)
        else:
            _save_and_exit()

    def _after_step(_, __):
        if pending:
            _save_and_exit()

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    write_to_record_file("training loop armed (SIGTERM-safe)", record)

    nav = Navigator(cfg, world, device=args.device)
    if mesh is not None:
        nav.use_mesh(mesh)      # dp-split validation decodes
    grad_aw = (cfg.distill.adaptive_ability_weight
               and cfg.distill.adaptive_ability_weight_type == "grad"
               and trainer.kdl)
    needs_dicts = args.z_instr_update or _front_flags(cfg.model)
    # dictionaries from files first (--*_backdoor/frontdoor_dict_file); the
    # iter-0 / periodic refresh overwrites them when it runs
    file_dicts = load_intervention_dict_files(args, cfg)
    if file_dicts:
        trainer.zdicts = file_dicts
        write_to_record_file(
            f"loaded intervention dicts from files for "
            f"{sorted(file_dicts)}", record)

    # back-translation speaker for the aug alternation (--use_transpeaker;
    # the reference's self-train path, agent.py:737-752)
    speaker = speaker_tok = None
    if args.use_transpeaker and splits.get("aug"):
        from ..agent.speaker import Speaker, SpeakerTokenizer

        speaker_tok = SpeakerTokenizer.build(splits["train"])
        speaker = Speaker(
            world, feat_dim=cfg.model.image_feat_size,
            vocab_size=speaker_tok.vocab_size,
            max_steps=cfg.env.max_action_len,
            max_len=min(args.max_decode, 80), hidden=args.h_dim,
            layers=args.speaker_layer_num, heads=args.speaker_head_num,
            word_size=args.wemb,
            feat_dropout=args.featdropout or cfg.train.feat_dropout,
            device=args.device)
        if args.speaker:
            # a pretrained speaker (format transpeaker.py:322-344; the
            # optimizer state only under --loadOptim, transpeaker.py:349-351)
            ep = speaker.load(args.speaker, load_optim=args.load_optim)
            write_to_record_file(
                f"loaded speaker checkpoint {args.speaker} (epoch {ep})",
                record)

    def refresh(it):
        refresh_intervention_dicts(args, cfg, trainer, world,
                                   splits["train"], it, record)

    def run_validation(it, save_best=True):
        nav.model.load_state_dict(trainer.model.state_dict())
        new_best = False
        zd = ({"student": trainer.zdicts["student"]}
              if "student" in trainer.zdicts else None)
        for split, items in splits.items():
            if not split.startswith("val") or not items:
                continue
            (avg, _), _ = nav.evaluate(items, zdicts=zd)
            logger.log(it, {f"{split}/{k}": v for k, v in avg.items()
                            if isinstance(v, float)})
            write_to_record_file(
                f"  {split}: sr={avg['sr']:.1f} spl={avg['spl']:.1f} "
                f"nDTW={avg['nDTW']:.1f}", record)
            if avg.get("gmap_overflow"):
                write_to_record_file(
                    "  " + _gmap_overflow_warning(
                        split, int(avg["gmap_overflow"]), cfg), record)
            score = _score(avg, args.dataset)
            if save_best and score > best[split]:
                best[split] = score
                new_best = True
                save_reference_checkpoint(
                    trainer.model,
                    os.path.join(args.ckpt_dir, f"best_{split}.pt"), epoch=it)
        return new_best

    best = {s: -1.0 for s in splits if s.startswith("val")}
    t0 = time.time()
    it = trainer.iteration
    if needs_dicts:
        refresh(it)
    if grad_aw:
        trainer.update_ability_grads(splits["train"][: cfg.train.batch_size])
    if args.eval_first:
        run_validation(it, save_best=False)

    aug_items = splits.get("aug")
    try:
        while it < args.iters:
            interval = min(args.log_every, args.iters - it)
            in_fit[0] = True
            try:
                hist = trainer.fit(splits["train"], interval, log_every=1,
                                   callback=_after_step, aug_items=aug_items,
                                   speaker=speaker, speaker_tok=speaker_tok,
                                   aug_times=args.aug_times if aug_items
                                   else 0)
            finally:
                in_fit[0] = False
            _after_step(None, None)
            prev_it, it = it, it + interval
            mean = {k: float(np.mean([h[k] for h in hist if k in h]))
                    for k in hist[-1]}
            logger.log(it, {f"loss/{k}": v for k, v in mean.items()})
            if grad_aw:
                logger.log(it, {f"ability_grad/{i}": float(g) for i, g in
                                enumerate(trainer.ability_grads)})
            write_to_record_file(
                f"iter {it}/{args.iters} loss={mean.get('loss', 0):.3f} "
                f"({time.time() - t0:.0f}s)", record)
            ovf = sum(v for k, v in mean.items()
                      if k.endswith("gmap_overflow"))
            if ovf > 0:
                write_to_record_file(
                    f"  WARNING: ~{ovf:.1f} episodes/step overflowed "
                    f"max_gmap_len={cfg.env.max_gmap_len} (gmap tokens "
                    f"truncated); raise --max_gmap_len", record)
            # the periodic refresh, then the new-best one
            # (main_nav.py:439-455, 488-494)
            if needs_dicts and args.update_iter and \
                    prev_it // args.update_iter != it // args.update_iter:
                refresh(it)
            if grad_aw and args.aw_update_iter and \
                    prev_it // args.aw_update_iter != it // args.aw_update_iter:
                trainer.update_ability_grads(
                    splits["train"][: cfg.train.batch_size])
            if run_validation(it) and needs_dicts:
                refresh(it)
            # latest .pt (+ teacher_ prefix when co-training, + optimizer
            # sidecar under --save_optimizer) and the resumable train state
            trainer.save(os.path.join(args.ckpt_dir, "latest_dict.pt"),
                         save_optimizer=args.save_optimizer)
            trainer.save_state(args.ckpt_dir)
            if speaker is not None and is_primary():
                # the speaker in the transpeaker container, for --speaker
                speaker.save(it, os.path.join(args.ckpt_dir,
                                              "speaker_latest.pt"))
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        logger.close()
    return trainer


def valid(args, cfg, world, splits, mesh=None):
    from ..agent.evaluator import Evaluator, submission_format
    from ..agent.navigator import Navigator
    from ..utils.checkpoint import restore_reference_checkpoint
    from ..utils.dist import gather_predictions, is_primary, shard_items
    from ..utils.logging import write_to_record_file

    record = os.path.join(args.log_dir, "valid.txt")
    nav = Navigator(cfg, world, device=args.device)
    if args.resume_file:
        epoch, _, _ = restore_reference_checkpoint(nav.model, args.resume_file)
        write_to_record_file(f"loaded {args.resume_file} (epoch {epoch})",
                             record)
    if mesh is not None:
        # dp-split waves, every rank decoding its rows (no item shards)
        nav.use_mesh(mesh)
        write_to_record_file(
            f"mesh: dp={mesh.shape['dp']} x mp={mesh.shape['mp']}", record)

    # intervention dictionaries: the reference's TSV files when their flags
    # name existing paths (main_nav.py:574-592), else rebuilt from the
    # loaded weights on the train split
    zdicts = None
    file_dicts = load_intervention_dict_files(args, cfg)
    if "student" in file_dicts:
        zdicts = {"student": file_dicts["student"]}
    elif (cfg.model.do_back_txt or _front_flags(cfg.model)) \
            and splits.get("train"):
        from ..agent.interventions import (KMeansPicker, build_rollout_zdicts,
                                           extract_cfp_features,
                                           update_backdoor_dict)

        back = (update_backdoor_dict(nav, splits["train"], _word_picker(args))
                if cfg.model.do_back_txt else None)
        front = None
        if _front_flags(cfg.model):
            feats, _ = extract_cfp_features(nav, splits["train"],
                                            _make_cfp_builder(cfg, world))
            front = KMeansPicker(
                feats, args.front_n_clusters,
                seed=cfg.train.seed).random_pick_front_features(
                np.random.default_rng(cfg.train.seed))
        z = build_rollout_zdicts(back, front, pad_entries=81)
        zdicts = {"student": z} if z else None

    def eval_model(tag, navigator, zd=None):
        out = {}
        for split, items in splits.items():
            if split in ("train", "aug") or not items:
                continue
            t0 = time.time()
            # several processes: contiguous eval shards per process,
            # predictions merged over the collective (reference
            # sel_data_idxs + all_gather, env.py:126-134, main_nav.py:606-607);
            # on a mesh the navigator splits each wave itself
            my_items = items if mesh is not None else shard_items(items)
            (local_avg, _), preds = navigator.evaluate(
                my_items, zdicts=zd, detailed_output=args.detailed_output,
                ensemble_n=args.ensemble_n)
            if local_avg.get("gmap_overflow"):
                write_to_record_file(_gmap_overflow_warning(
                    split, int(local_avg["gmap_overflow"]), cfg), record)
            if mesh is None:
                preds = gather_predictions(preds)
            if args.submit and tag == "" and is_primary():
                with open(os.path.join(args.pred_dir,
                                       f"submit_{split}.json"), "w") as f:
                    json.dump(submission_format(preds), f)
            if split == "test":
                # leaderboard split has no ground truth: submission only
                # (main_nav.py:617-622)
                write_to_record_file(
                    f"{tag}test: {len(preds)} predictions written "
                    f"(cost time: {time.time() - t0:.1f}s)", record)
                continue
            avg, _ = Evaluator(world, items).eval_metrics(preds)
            write_to_record_file(
                f"{tag}{split}: "
                f"{json.dumps({k: round(v, 2) for k, v in avg.items()})} "
                f"(cost time: {time.time() - t0:.1f}s)", record)
            out[split] = avg
        return out

    results = eval_model("", nav, zdicts)
    # the reference also validates the teacher model (main_nav.py:624-667)
    if args.train_kdl and args.teacher_resume_file and cfg.teacher_model:
        import dataclasses

        t_cfg = dataclasses.replace(cfg, model=cfg.teacher_model)
        t_nav = Navigator(t_cfg, world, device=args.device)
        restore_reference_checkpoint(t_nav.model, args.teacher_resume_file,
                                     drop_kd_heads=True)
        if mesh is not None:
            t_nav.use_mesh(mesh)
        results.update({f"teacher_{k}": v
                        for k, v in eval_model("teacher ", t_nav).items()})
    return results


def extract_cfp(args, cfg, world, splits):
    """``--mode extract_cfp_features``: the frontdoor CFP feature TSV of
    the train split (reference main_nav.py:669-677, agent.py:1516-1561),
    which ``KMeansPicker`` turns into the frontdoor dictionaries."""
    from ..agent.interventions import extract_cfp_features, save_cfp_tsv
    from ..agent.navigator import Navigator
    from ..utils.checkpoint import restore_reference_checkpoint
    from ..utils.logging import write_to_record_file

    record = os.path.join(args.log_dir, "extract.txt")
    nav = Navigator(cfg, world, device=args.device)
    epoch = 0
    if args.resume_file:
        epoch, _, _ = restore_reference_checkpoint(nav.model, args.resume_file)
    feats, ids = extract_cfp_features(nav, splits["train"],
                                      _make_cfp_builder(cfg, world))
    out = os.path.join(args.pred_dir, f"cfp_features_{epoch}.tsv")
    save_cfp_tsv(out, feats, ids)
    write_to_record_file(
        f"extracted CFP features for {len(ids)} trajectories -> {out}",
        record)
    return out


def serve(args, cfg):
    """``--mode serve``: the online robot control loop as a JSON-lines
    protocol over stdin/stdout (agent/serving.py).  Messages, one JSON
    object per line:

      -> {"type": "session", "instruction": [token ids]}
      <- {"type": "ready"}
      -> {"type": "observation", "node": str, "position": [x, y, z],
          "heading": float, "pano_feats": [[36 x D floats]] | base64(f32le),
          "candidates": [{"node", "position", "dist",
                          "heading"?, "elevation"?, "view"?}, ...]}
      <- {"type": "decision", "stop": bool, "target": str|null,
          "path": [node...], "latency_ms": float}
      -> {"type": "finish"}
      <- {"type": "final", "stop_node": str, "trajectory": [...], "steps": N}
      -> {"type": "save", "path": str}        # persist the live session
      <- {"type": "saved", "path": str, "steps": N}
      -> {"type": "restore", "path": str}     # resume a saved session
      <- {"type": "ready", "resumed": true, "steps": N}
      -> {"type": "quit"}

    ``warmup()`` runs every per-step path before the first message, so no
    episode pays the first call's setup.  ``save``/``restore`` let a
    restarted server continue an episode with identical decisions
    (NavSession.save/restore).
    """
    import base64
    import sys as _sys

    import torch

    from ..agent.serving import Candidate, NavServer, NavSession, Observation
    from ..models.vlnbert import DualScaleVLNBert
    from ..utils.checkpoint import restore_reference_checkpoint
    from ..utils.device import resolve_device
    from ..utils.weights import init_params

    if args.serve_bundle:
        # the bundle pins the full config and slot budgets: warn on flags
        # it will ignore
        overridden = [f for f in (
            "--resume_file", "--serve_max_nodes", "--serve_max_cands",
            "--fusion", "--max_gmap_len", "--max_instr_len",
            "--student_hidden_size") if f in getattr(args, "_raw_argv", [])]
        if overridden:
            print(json.dumps({
                "type": "warning",
                "message": f"--serve_bundle pins the full config and slot "
                           f"budgets from meta.json; ignoring "
                           f"{' '.join(overridden)}"}), flush=True)
        server = NavServer.from_bundle(args.serve_bundle, device=args.device)
        cfg = server.cfg
        print(json.dumps({"type": "loaded", "bundle": args.serve_bundle}),
              flush=True)
    else:
        model = DualScaleVLNBert(
            cfg.model, dtype=getattr(torch, cfg.train.compute_dtype),
            device=resolve_device(args.device))
        init_params(model, cfg.train.seed)
        if args.resume_file:
            epoch, _, _ = restore_reference_checkpoint(model, args.resume_file)
            print(json.dumps({"type": "loaded", "ckpt": args.resume_file,
                              "epoch": epoch}), flush=True)
        server = NavServer(cfg, max_nodes=args.serve_max_nodes,
                           max_cands=args.serve_max_cands, model=model,
                           device=args.device)
    if args.export_serve_bundle:
        server.export_bundle(args.export_serve_bundle,
                             quantize=args.serve_bundle_int8)
        print(json.dumps({"type": "exported",
                          "bundle": args.export_serve_bundle}), flush=True)
        return
    server.warmup()   # no first-call setup inside a robot control loop
    d = cfg.model.image_feat_size

    def _feats(x):
        if isinstance(x, str):
            return np.frombuffer(base64.b64decode(x),
                                 np.float32).reshape(36, d)
        return np.asarray(x, np.float32)

    sess = None
    for line in _sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
            kind = msg.get("type")
            if kind == "session":
                sess = server.new_session(
                    np.asarray(msg["instruction"], np.int32))
                print(json.dumps({"type": "ready"}), flush=True)
            elif kind == "observation":
                dec = sess.step(Observation(
                    node=msg["node"], position=tuple(msg["position"]),
                    heading=float(msg.get("heading", 0.0)),
                    pano_feats=_feats(msg["pano_feats"]),
                    candidates=[Candidate(
                        node=c["node"], position=tuple(c["position"]),
                        dist=float(c["dist"]), heading=c.get("heading"),
                        elevation=c.get("elevation"), view=c.get("view"))
                        for c in msg["candidates"]]))
                print(json.dumps({
                    "type": "decision", "stop": dec.stop,
                    "target": dec.target, "path": dec.path,
                    "latency_ms": round(dec.latency_ms, 2)}), flush=True)
            elif kind == "finish":
                print(json.dumps({"type": "final", **sess.finish()}),
                      flush=True)
                sess = None
            elif kind == "save":
                sess.save(msg["path"])
                print(json.dumps({"type": "saved", "path": msg["path"],
                                  "steps": sess.t_step}), flush=True)
            elif kind == "restore":
                sess = NavSession.restore(server, msg["path"])
                print(json.dumps({"type": "ready", "resumed": True,
                                  "steps": sess.t_step}), flush=True)
            elif kind == "quit":
                break
            else:
                raise ValueError(f"unknown message type {kind!r}")
        except Exception as e:  # protocol errors must not kill the server
            print(json.dumps({"type": "error", "message": str(e)}),
                  flush=True)


def default_max_gmap_len(dataset: str) -> int:
    """RxR trajectories are ~2x longer (28 actions, run_rxr_*.sh) and can
    observe well past 128 nodes; silent truncation there would surface only
    as gmap_overflow warnings."""
    return 208 if dataset == "rxr" else 128


def build_config(args):
    """The ``MagicConfig`` of parsed flags, as JAX's ``main`` builds it:
    the dataset's gmap budget when ``--max_gmap_len`` is unset, then the
    synthetic world's feature width and a capped vocabulary when no dataset
    tree is mounted (in serve mode only under an explicit
    ``--synthetic_feat_dim``).  Sets both defaults on ``args``."""
    from ..config import from_reference_flags

    if args.max_gmap_len is None:
        args.max_gmap_len = default_max_gmap_len(args.dataset)
    cfg = from_reference_flags(vars(args))
    explicit_synth = args.synthetic_feat_dim is not None
    if args.synthetic_feat_dim is None:
        args.synthetic_feat_dim = 64
    if not os.path.isdir(args.connectivity_dir) and \
            (args.mode != "serve" or explicit_synth):
        # synthetic fallback needs matching dims
        import dataclasses

        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, image_feat_size=args.synthetic_feat_dim,
                vocab_size=min(cfg.model.vocab_size, 2000)))
        if cfg.teacher_model is not None:
            cfg = dataclasses.replace(
                cfg, teacher_model=dataclasses.replace(
                    cfg.teacher_model,
                    image_feat_size=args.synthetic_feat_dim,
                    vocab_size=min(cfg.teacher_model.vocab_size, 2000)))
    return cfg


def main(argv=None):
    from ..utils.device import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)     # a missing GPU fails before any work
    cfg = build_config(args)
    if args.mode == "serve":
        return serve(args, cfg)
    modes = {"train": train, "valid": valid,
             "extract_cfp_features": extract_cfp}
    if args.mode not in modes:
        raise SystemExit(f"unknown mode {args.mode}")
    mesh = build_mesh(args) if args.mode in ("train", "valid") else None
    if mesh is not None:
        # DDP semantics: --batch_size is per device; the global batch is
        # scaled by dp (reference: each rank rolls out batch_size episodes)
        import dataclasses

        dp = mesh.shape["dp"]
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, batch_size=cfg.train.batch_size * dp))
        if mesh.rank == 0:
            print(f"mesh: dp={dp} x mp={mesh.shape['mp']} "
                  f"(global batch {cfg.train.batch_size})")
    world, splits = build_dataset(args, cfg)
    if mesh is None:
        return modes[args.mode](args, cfg, world, splits)
    return modes[args.mode](args, cfg, world, splits, mesh=mesh)


if __name__ == "__main__":
    main()
