"""Typed configuration tree.

One dataclass hierarchy replaces the reference's flat ~120-flag argparse
namespace (reference: map_nav_src/r2r/parser.py:5-210) and its JSON model
config (reference: pretrain_src/config/r2r_magic_model_config.json).
``from_reference_flags`` accepts the reference's public flag names verbatim so
configs/scripts written for the reference keep working.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    """Dual-scale cross-modal transformer dimensions.

    Defaults are the teacher (768-d) configuration
    (reference: pretrain_src/config/r2r_magic_model_config.json:7-17;
    map_nav_src/r2r/parser.py:173-181).  The distillation chain uses
    hidden sizes 768 -> 384 -> 256 -> 128 with heads = hidden // 64.
    """

    vocab_size: int = 50265
    hidden_size: int = 768
    num_l_layers: int = 6
    num_pano_layers: int = 2
    num_x_layers: int = 3
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    max_action_steps: int = 100          # step-id embedding table size
    pad_token_id: int = 1                # RoBERTa convention

    image_feat_size: int = 768
    angle_feat_size: int = 4
    loc_feat_size: int = 7               # 4 angle + 3 box
    gmap_pos_size: int = 7
    vp_pos_size: int = 14

    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    use_lang2visn_attn: bool = True
    graph_sprels: bool = True
    # run the global+local cross-modal encoders as ONE vmapped computation
    # over branch-stacked params (same math, half the dispatches; parameter
    # trees and checkpoints identical either way).  MEASURED AND LOST on
    # eval (18.9k vs 23.9k steps/s: padding the vp stream to gmap length
    # makes every trunk relayout copy full-size — the step is copy-bound,
    # not dispatch-bound) and neutral on train (1,294 vs 1,321 ms);
    # docs/PERF.md decisions table.  Kept flag-gated for A/B.
    fuse_branches: bool = False
    # hoist the layer-0 cross-attention K/V over the instruction out of the
    # rollout scan: txt_embeds are loop-invariant, so the first cross layer's
    # key/value projections (and their head-split relayout copies — the
    # largest single slice of the profile's copy bucket, docs/PERF.md lever
    # #1) are computed once per episode instead of once per step.  Math is
    # bit-identical (the same Dense on the same values); deeper layers read
    # the lang stream updated by lang2visn attention and stay in-scan.
    hoist_text_kv: bool = True
    glocal_fuse: bool = True             # dynamic global/local fusion
    adaptive_pano_fusion: bool = True
    # which action scores drive the policy (parser.py:16):
    # dynamic = learned-gate fusion, avg = fixed 0.5 gate, global = global
    # branch only, local = local (viewpoint) branch action space
    fusion: str = "dynamic"

    # causal interventions (GOAT lineage); off by default like the valid script
    do_back_txt: bool = False
    do_back_img: bool = False
    do_front_txt: bool = False
    do_front_img: bool = False
    do_front_his: bool = False
    # the reference's backdoor variants (parser.py:128-138), kept for the
    # flag surface: nothing reads them, in this package or in JAX's; every
    # backdoor is ZdictAttention with the log-prior bias
    do_back_txt_type: str = "type_2"
    do_back_img_type: str = "type_1"
    do_add_method: str = "door"          # door | add
    cfp_temperature: float = 1.0

    # Pallas fused-attention kernel (TPU inference/eval path)
    use_pallas_attention: bool = False
    # tanh-approximate gelu in the FFNs: the exact-erf polynomial measured
    # ~11% of eval device time in the rollout scan (docs/PERF.md round 3).
    # Default False = exact BERT/reference parity; True is an opt-in speed
    # knob whose error (<~3e-3 absolute) sits at bf16 resolution —
    # measured +21% eval throughput (30.0k -> 36.4k steps/s)
    gelu_approximate: bool = False
    # attention softmax in the compute dtype instead of f32: the f32
    # convert+reduce pairs measured 16% of eval device time.  Default False
    # = f32 softmax (torch-parity numerics); True is the matching opt-in
    # speed knob for serving
    softmax_compute_dtype_attn: bool = False
    # attention logits from the MXU's f32 accumulator instead of
    # bf16-rounded scores converted before the softmax: drops the convert
    # pair AND is numerically closer to the torch-f32 reference; no-op at
    # f32 compute dtype (goldens unchanged).  Opt-in pending the TPU
    # semantic-fraction check (docs/PERF.md methodology)
    attn_logits_f32: bool = False

    # knowledge-distillation heads (student role projects to teacher width)
    kd_heads: bool = False
    kd_target_size: int = 768

    @property
    def intermediate_size(self) -> int:
        return self.hidden_size * self.mlp_ratio

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def derive(self, hidden_size: int, num_attention_heads: int | None = None, **kw) -> "ModelConfig":
        """Chain-stage config: same structure, smaller width.

        Mirrors the teacher_*/student_* key promotion in the reference
        (pretrain_src/train_r2r_magic.py:127-160: heads = hidden // 64,
        intermediate = hidden * mlp_ratio)."""
        heads = num_attention_heads or hidden_size // 64
        return dataclasses.replace(
            self, hidden_size=hidden_size, num_attention_heads=heads, **kw
        )


@dataclass
class EnvConfig:
    max_action_len: int = 15             # R2R; RxR uses 28
    max_instr_len: int = 200             # R2R; RxR uses 250
    max_gmap_len: int = 128              # [stop]+[mem]+visited+frontier, padded
    max_pano_len: int = 48               # cands + remaining views, padded
    max_candidates: int = 16
    ignore_id: int = -100
    error_margin: float = 3.0            # success threshold (env.py:21)
    expert_policy: str = "spl"           # spl | ndtw
    dataset: str = "r2r"
    # expl_sample feedback: fraction of steps that follow argmax instead of
    # exploring a random unvisited token (parser.py:18)
    expl_max_ratio: float = 0.6
    # only the current viewpoint counts as "visited" in the gmap token
    # classification, so earlier nodes stay selectable (agent.py:186)
    act_visited_nodes: bool = False
    # exact reference semantics: gmap distances/paths over the incrementally
    # observed subgraph (GraphMap behavior) instead of precomputed full-graph
    # tables; costs a [B, N, N] distance matrix in the episode state
    observed_graph_parity: bool = False
    # lax.scan unroll factor for the rollout time loop.  The per-step
    # pipeline is dispatch-latency bound (~1.3k device ops at ~3 us,
    # docs/PERF.md); unrolling lets XLA fuse across step boundaries and
    # drop loop-carry layout fix-ups.  Semantics are identical for any
    # value.  1 = rolled (default).
    scan_unroll: int = 1


@dataclass
class DistillConfig:
    """MAKD / MKRW / MKTD / ICoD knobs (reference: map_nav_src/r2r/parser.py:145-197)."""

    train_kdl: bool = False
    ability_types: tuple = ("txt", "img", "local", "global", "action")
    feat_loss: str = "mse"               # mse | kl
    attn_loss: str = "mse"
    logit_loss: str = "kd"               # kd | dkd
    temperature: float = 1.0
    alpha: float = 0.5                   # total = alpha*KD + (1-alpha)*IL
    dkd_alpha: float = 1.0
    dkd_beta: float = 8.0
    loss_type: str = "sum"               # sum | mean
    no_feat: bool = False
    no_attn: bool = False
    no_logit: bool = False
    # MKRW
    adaptive_ability_weight: bool = False
    adaptive_ability_weight_type: str = "RW"   # RW | learned_weight | grad
    rw_temp: float = 1.0
    # MKTD
    teacher_sample_hard_mining: bool = False
    sample_preprocess: str = "exp"       # exp | norm
    sample_exp_decay: float = 0.7
    # ICoD
    train_teacher: bool = False
    t_alpha: float = 0.5
    t_lr: float = 5e-6


@dataclass
class TrainConfig:
    iters: int = 100_000
    log_every: int = 1000
    batch_size: int = 16
    lr: float = 4e-5
    weight_decay: float = 0.0
    optim: str = "adamw"
    grad_clip: float = 40.0
    ml_weight: float = 0.2
    train_alg: str = "dagger"            # imitation | dagger
    # gradient accumulation: apply the optimizer every accum_steps
    # micro-batches on the AVERAGED gradients (reference --accumulateGrad
    # pairs the gt + back-translated batches into one update,
    # main_nav.py:336-353; pretrain gradient_accumulation_steps,
    # pretrain_src/data/loader.py:22-55).  1 = off.
    accum_steps: int = 1
    dagger_sample: str = "sample"
    # fused dual rollout: run the DAgger step's two rollouts (teacher-forced
    # at ml_weight + sampled at 1.0, agent_base.py:236-259) as ONE scan at
    # double batch width.  Math is exactly the two sequential rollouts
    # (per-half loss bookkeeping, tests/test_trainer.py) but MEASURED
    # NEUTRAL at the reference batch 16 (1,149 vs 1,154 ms — the train step
    # is not dispatch-bound the way eval is; docs/PERF.md decisions table),
    # so the default stays the reference-shaped two-rollout step.
    fuse_rollouts: bool = False
    feedback: str = "sample"
    use_lr_sch: bool = False
    lr_sch: str = "polynomial"
    warmup_iters: int = 0
    seed: int = 0
    feat_dropout: float = 0.4
    gamma: float = 0.9                   # RL discount (parser.py:93)
    entropy_loss_weight: float = 0.01    # (parser.py:48)
    compute_dtype: str = "float32"       # bfloat16 on TPU training
    # weight-grad accumulation dtype across the rollout scan's backward.
    # "bfloat16" casts the (f32 master) params to bf16 BEFORE jax.grad, so
    # the scan carry that sums per-step weight gradients — the train
    # backward's dominant non-matmul bucket (docs/PERF.md round-3
    # decomposition) — moves half the HBM bytes; the one f32 convert happens
    # at the cast's backward, and the optimizer still updates f32 masters.
    grads_dtype: str = "float32"
    # rematerialize each rollout step in the backward pass (jax.checkpoint):
    # trades ~one extra forward for O(T) less activation HBM, raising the
    # trainable batch ceiling (the dual-model 15-step scan otherwise keeps
    # both models' per-step activations live)
    remat: bool = False
    # remat policy: "full" recomputes the whole step in the backward;
    # "dots" (jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    # keeps weight-stationary MXU outputs resident and recomputes only the
    # cheap elementwise work; "dots_all" (dots_saveable) additionally keeps
    # batch-dim dots (attention scores/outputs) — least recompute, highest
    # HBM floor.  Pick per shape/batch.
    remat_policy: str = "full"
    # parameter freezing (reference parser.py declares fix_lang_embedding /
    # fix_local_branch / fix_pano_embedding but its released code never
    # consumes them; here they actually freeze via a zero-update optimizer
    # mask, Trainer._frozen_mask)
    fix_lang_embedding: bool = False
    fix_local_branch: bool = False
    fix_pano_embedding: bool = False


@dataclass
class MagicConfig:
    """Top-level config: model pair + env + training + distillation."""

    model: ModelConfig = field(default_factory=ModelConfig)          # student
    teacher_model: ModelConfig | None = None
    env: EnvConfig = field(default_factory=EnvConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)


# mapping: reference flag name -> (section, field)
_FLAG_MAP = {
    "max_action_len": ("env", "max_action_len"),
    "max_instr_len": ("env", "max_instr_len"),
    "max_gmap_len": ("env", "max_gmap_len"),
    "ignoreid": ("env", "ignore_id"),
    "expert_policy": ("env", "expert_policy"),
    "dataset": ("env", "dataset"),
    "iters": ("train", "iters"),
    "log_every": ("train", "log_every"),
    "batch_size": ("train", "batch_size"),
    "lr": ("train", "lr"),
    "optim": ("train", "optim"),
    "ml_weight": ("train", "ml_weight"),
    "train_alg": ("train", "train_alg"),
    "dagger_sample": ("train", "dagger_sample"),
    "feedback": ("train", "feedback"),
    "use_lr_sch": ("train", "use_lr_sch"),
    "lr_sch": ("train", "lr_sch"),
    "seed": ("train", "seed"),
    "feat_dropout": ("train", "feat_dropout"),
    "train_kdl": ("distill", "train_kdl"),
    "kd_ability_types": ("distill", "ability_types"),
    "kdl_feat_loss": ("distill", "feat_loss"),
    "kdl_attn_loss": ("distill", "attn_loss"),
    "kdl_logit_loss": ("distill", "logit_loss"),
    "kdl_temperature": ("distill", "temperature"),
    "kdl_alpha": ("distill", "alpha"),
    "kdl_dkd_alpha": ("distill", "dkd_alpha"),
    "kdl_dkd_beta": ("distill", "dkd_beta"),
    "kd_loss_type": ("distill", "loss_type"),
    "train_kdl_noFeat": ("distill", "no_feat"),
    "train_kdl_noAttn": ("distill", "no_attn"),
    "train_kdl_noLogit": ("distill", "no_logit"),
    "kdl_adaptive_ability_weight": ("distill", "adaptive_ability_weight"),
    "kdl_adaptive_ability_weight_type": ("distill", "adaptive_ability_weight_type"),
    "rw_temp": ("distill", "rw_temp"),
    "teacher_sample_hard_mining": ("distill", "teacher_sample_hard_mining"),
    "t_sample_preprocess": ("distill", "sample_preprocess"),
    "t_sample_preprocess_exp_decay": ("distill", "sample_exp_decay"),
    "train_kdl_teacher": ("distill", "train_teacher"),
    "t_kdl_alpha": ("distill", "t_alpha"),
    "t_lr": ("distill", "t_lr"),
    "dropout": ("model", "hidden_dropout"),
    "num_l_layers": ("model", "num_l_layers"),
    "num_pano_layers": ("model", "num_pano_layers"),
    "num_x_layers": ("model", "num_x_layers"),
    "angle_feat_size": ("model", "angle_feat_size"),
    "graph_sprels": ("model", "graph_sprels"),
    "adaptive_pano_fusion": ("model", "adaptive_pano_fusion"),
    "do_back_txt": ("model", "do_back_txt"),
    "do_back_img": ("model", "do_back_img"),
    "do_front_txt": ("model", "do_front_txt"),
    "do_front_img": ("model", "do_front_img"),
    "do_front_his": ("model", "do_front_his"),
    "do_back_txt_type": ("model", "do_back_txt_type"),
    "do_back_img_type": ("model", "do_back_img_type"),
    "do_add_method": ("model", "do_add_method"),
    "cfp_temperature": ("model", "cfp_temperature"),
    "fusion": ("model", "fusion"),
    "image_feat_size": ("model", "image_feat_size"),
    "expl_max_ratio": ("env", "expl_max_ratio"),
    "act_visited_nodes": ("env", "act_visited_nodes"),
    "gamma": ("train", "gamma"),
    "entropy_loss_weight": ("train", "entropy_loss_weight"),
    "grad_clip": ("train", "grad_clip"),
    "warmup_iters": ("train", "warmup_iters"),
    "weight_decay": ("train", "weight_decay"),
    "featdropout": ("train", "feat_dropout"),   # legacy alias (parser.py:115)
    "gradient_accumulation_steps": ("train", "accum_steps"),  # pretrain JSON
    "fix_lang_embedding": ("train", "fix_lang_embedding"),
    "fix_local_branch": ("train", "fix_local_branch"),
    "fix_pano_embedding": ("train", "fix_pano_embedding"),
}


def config_to_dict(cfg: MagicConfig) -> dict:
    """JSON-serializable dict of the full config tree (the counterpart of
    the reference's ``training_args.json`` dump, main_nav.py:170)."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> MagicConfig:
    """Rebuild a :class:`MagicConfig` from :func:`config_to_dict` output
    (e.g. read back from JSON).  Tuple-typed fields are re-coerced from the
    lists JSON produces; unknown keys are ignored for forward compat."""
    section_types = {"model": ModelConfig, "teacher_model": ModelConfig,
                     "env": EnvConfig, "train": TrainConfig,
                     "distill": DistillConfig}

    def build(cls, dd):
        if dd is None:
            return None
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for name, value in dd.items():
            f = fields.get(name)
            if f is None:
                continue
            default = (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory()
                       if f.default_factory is not dataclasses.MISSING
                       else None)
            if isinstance(default, tuple) and isinstance(value, list):
                value = tuple(value)
            kwargs[name] = value
        return cls(**kwargs)

    top = {}
    for name, value in d.items():
        if name in section_types:
            top[name] = build(section_types[name], value)
    return MagicConfig(**top)


def from_reference_flags(flags: dict) -> MagicConfig:
    """Build a :class:`MagicConfig` from a dict of reference-named flags.

    Student dims come from ``student_*`` keys, teacher dims from
    ``teacher_*`` keys, matching map_nav_src/r2r/parser.py:173-195.
    Unknown keys are ignored (the reference tolerates extra flags too).
    """
    cfg = MagicConfig()
    sections = {"model": {}, "env": {}, "train": {}, "distill": {}}
    for key, value in flags.items():
        # None means "not given" for alias flags (e.g. --featdropout, the
        # legacy spelling of --feat_dropout) — never overwrite with it
        if key in _FLAG_MAP and value is not None:
            sec, name = _FLAG_MAP[key]
            if name == "ability_types" and isinstance(value, list):
                value = tuple(value)
            sections[sec][name] = value

    # nav --accumulateGrad is boolean: gt + aug batches fold into one update
    # (main_nav.py:336-353) -> k=2 unless an explicit step count was given
    if flags.get("accumulate_grad") and \
            int(sections["train"].get("accum_steps", 1)) <= 1:
        sections["train"]["accum_steps"] = 2

    student_hidden = int(flags.get("student_hidden_size", 384))
    student_heads = int(flags.get("student_num_attention_heads", student_hidden // 64))
    teacher_hidden = int(flags.get("teacher_hidden_size", 768))
    teacher_heads = int(flags.get("teacher_num_attention_heads", teacher_hidden // 64))

    model = dataclasses.replace(ModelConfig(), **sections["model"])
    # fusion 'avg' fixes the global/local gate at 0.5 (the reference's
    # non-dynamic fuse; agent call sites + parser.py:16)
    if model.fusion == "avg":
        model = dataclasses.replace(model, glocal_fuse=False)
    train_kdl = bool(sections["distill"].get("train_kdl", False))

    def role_dim(role, name, default, hidden):
        v = flags.get(f"{role}_{name}")
        if v is None and name == "mlp_ratio":
            # *_intermediate_size is the explicit spelling of the same knob
            inter = flags.get(f"{role}_intermediate_size")
            v = (int(inter) // hidden) if inter else None
        return int(v) if v is not None else default

    # VLNBert(role='student') always takes student_* dims (parser.py:186-192);
    # KD projection heads exist only when distilling.
    student = model.derive(
        student_hidden, student_heads,
        num_l_layers=role_dim("student", "num_l_layers", model.num_l_layers,
                              student_hidden),
        num_pano_layers=role_dim("student", "num_pano_layers",
                                 model.num_pano_layers, student_hidden),
        num_x_layers=role_dim("student", "num_x_layers", model.num_x_layers,
                              student_hidden),
        mlp_ratio=role_dim("student", "mlp_ratio", model.mlp_ratio,
                           student_hidden),
        kd_heads=train_kdl, kd_target_size=teacher_hidden,
    )
    teacher = model.derive(
        teacher_hidden, teacher_heads,
        num_l_layers=role_dim("teacher", "num_l_layers", model.num_l_layers,
                              teacher_hidden),
        num_pano_layers=role_dim("teacher", "num_pano_layers",
                                 model.num_pano_layers, teacher_hidden),
        num_x_layers=role_dim("teacher", "num_x_layers", model.num_x_layers,
                              teacher_hidden),
        mlp_ratio=role_dim("teacher", "mlp_ratio", model.mlp_ratio,
                           teacher_hidden),
        kd_heads=bool(flags.get("train_kdl_teacher", False)),
        kd_target_size=student_hidden,
    )
    return dataclasses.replace(
        cfg,
        model=student,
        teacher_model=teacher if train_kdl else None,
        env=dataclasses.replace(cfg.env, **sections["env"]),
        train=dataclasses.replace(cfg.train, **sections["train"]),
        distill=dataclasses.replace(cfg.distill, **sections["distill"]),
    )
