"""Training: imitation / DAgger / A2C fine-tuning with MAKD distillation
and ICoD.

Port of ``vln_magic_tpu/agent/trainer.py``.  A DAgger step runs two
rollouts (teacher-forced at ``ml_weight``, then on-policy with
``dagger_sample`` at 1.0), or with ``fuse_rollouts`` both as one rollout at
double batch width; an A2C step (``train_alg`` other than ``imitation`` or
``dagger``) runs the teacher-forced one and a sampled one that trains the
policy and the critic on discounted distance-progress returns.  With
distillation each rollout runs the MAGIC teacher beside the student and
adds the MAKD losses (MKTD sample weights, MKRW, learned or
gradient-driven ability weights); with ``train_teacher`` (ICoD) the
teacher trains on its own CE and the reverse losses, with its own
optimizer at ``t_lr``.

The reference takes one ``jax.grad`` of ``total + t_total`` over the
parameter partitions.  Here each rollout's loss is backpropagated as soon
as it is built (the rollouts' losses add up, so the gradients accumulated
in ``.grad`` are those of the sum, with one rollout's activations alive at
a time); then each optimizer clips its own gradients and steps once.
Parameters are f32 masters; with ``compute_dtype="bfloat16"`` the forward
runs under ``torch.autocast``, as flax's ``dtype=bf16`` modules compute
from f32 params, with autocast's weight cache off, so that each use of a
weight casts it anew and the uses' gradients sum in f32, as JAX's do.
``grads_dtype="bfloat16"`` instead casts the masters to bf16 once a step
(``_bf16_weights``), so the uses' gradients, across both rollouts, sum in
bf16 and reach the masters once.  ``accum_steps`` > 1 applies each
optimizer every k steps to the mean gradient (``Optimizer``, optax's
``MultiSteps``).

Checkpoints (agent_base.py:298-359): ``save``/``load`` write and read the
reference ``.pt`` container, which the JAX package reads and writes too;
``load_pretrained`` takes a pretraining trunk (``model_step_N.pt``) into
the student or the teacher; ``save_state``/``load_state`` keep the whole
train state in the port's own format (``utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from ..config import MagicConfig
from ..data.tokenizer import HashTokenizer
from ..env.world import World
from ..models.vlnbert import Critic, DualScaleVLNBert
from ..utils.checkpoint import (CheckpointManager, pretrain_to_nav_key_map,
                                restore_reference_checkpoint,
                                save_reference_checkpoint)
from ..parallel.sharding import (all_reduce_tensors, full_state_dict,
                                 full_tensor, is_split, local_slice,
                                 reduce_gradients, reduce_metrics,
                                 shard_params)
from ..utils.device import resolve_device
from ..utils.weights import _flax_names, flax_named_grads, init_params
from .distill import total_kd_loss
from .navigator import episodes_from_items, pad_instructions
from .rollout import Rollout, Tables

OPTIMIZERS = ("adamw", "adam", "sgd", "radam", "ralamb", "rangerlars",
              "rms")
ABILITY_EMA = 0.5       # update_ability_grads' EMA of the gradient norms


# ----- learning-rate schedules (optax's, as functions of the step) -----

def noam_schedule(lr: float, warmup: int = 4000):
    """Linear warmup, then inverse-sqrt decay."""
    warmup = max(warmup, 1)

    def sched(step):
        step = max(step, 1)
        return lr * (step / warmup if step <= warmup
                     else warmup ** 0.5 * step ** -0.5)

    return sched


def warmup_linear_schedule(lr: float, warmup: int, total: int):
    """BERT schedule, floored at 1e-8."""
    warmup = max(warmup, 1)

    def sched(step):
        frac = (step / warmup if step < warmup
                else max(0.0, (total - step) / max(total - warmup, 1)))
        return max(lr * frac, 1e-8)

    return sched


def _polynomial(init: float, end: float, power: float, steps: int):
    """optax.polynomial_schedule (and linear_schedule at power 1)."""
    def sched(step):
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac ** power + end

    return sched


def _cosine(init: float, steps: int):
    """optax.cosine_decay_schedule with alpha 0."""
    def sched(step):
        return init * 0.5 * (1 + math.cos(math.pi * min(step, steps) / steps))

    return sched


def make_lr_schedule(cfg):
    """The student's learning rate as a function of the step: constant by
    default; with ``use_lr_sch`` warmup + cosine/linear/polynomial, or the
    pretrain schedules noam / warmup_linear."""
    t = cfg.train
    if not t.use_lr_sch:
        return lambda step: t.lr
    if t.lr_sch == "noam":
        return noam_schedule(t.lr, t.warmup_iters or 4000)
    if t.lr_sch == "warmup_linear":
        return warmup_linear_schedule(t.lr, t.warmup_iters, t.iters)
    decay_iters = max(t.iters - t.warmup_iters, 1)
    # 'linear' and 'polynomial' (the reference's default when use_lr_sch)
    # are both optax's linear decay to 0
    main = (_cosine(t.lr, decay_iters) if t.lr_sch == "cosine"
            else _polynomial(t.lr, 0.0, 1.0, decay_iters))
    if t.warmup_iters > 0:
        warm = _polynomial(0.0, t.lr, 1.0, t.warmup_iters)
        return lambda step: (warm(step) if step < t.warmup_iters
                             else main(step - t.warmup_iters))
    return main


# ----- optimizers: clip_by_global_norm, then the optax family -----

def global_norm(tensors, params=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    ``params``: the parameters the tensors are shaped like, where a mesh
    may have split some (``_whole_norms``)."""
    norms = torch._foreach_norm(tensors)
    whole = _whole_norms(norms, params)
    return torch.linalg.vector_norm(torch.stack(norms) if whole is None
                                    else whole)


def _whole_norms(norms, params):
    """The norms [n] of whole leaves, from ``norms`` of the tensors shaped
    like ``params``: where a mesh split a parameter over mp
    (``parallel.shard_params``) its tensor is a slice, whose square is
    summed over mp.  ``None`` where no parameter is split."""
    if params is None or not any(is_split(p) for p in params):
        return None
    split = [is_split(p) for p in params]
    sq = torch.stack(norms).float() ** 2
    part = sq * torch.tensor(split, device=sq.device)
    all_reduce_tensors([part], params[split.index(True)].tp_mesh.mp_group)
    return torch.where(torch.tensor(split, device=sq.device), part,
                       sq).sqrt()


def _f32_pow(b: float, t: int):
    """``b ** t`` as optax computes it: in f32, correctly rounded.  optax
    keeps its scalars in f32, and ``1 - b ** t`` (the bias corrections,
    RAdam's rho_t) cancels, so the f64 value would differ from optax's by
    up to 1e-5 relative, and RAdam's rectification by 1e-2 at rho_t near
    6."""
    return np.float32(float(np.float32(b)) ** t)


def frozen_flags(train_cfg, names) -> list[bool]:
    """JAX's ``Trainer._frozen_mask`` over flax names (``utils.weights``):
    the language embeddings (``fix_lang_embedding``), the local
    cross-modal branch and its action head (``fix_local_branch``), the
    panorama encoder (``fix_pano_embedding``)."""
    t = train_cfg

    def frozen(k):
        return ((t.fix_lang_embedding and "lang_encoder" in k
                 and ("embeddings" in k or "emb_norm" in k))
                or (t.fix_local_branch and ("local_encoder" in k
                                            or "local_sap_head" in k))
                or (t.fix_pano_embedding and "pano_encoder" in k))

    return [bool(frozen(k)) for k in names]


def flax_param_names(model) -> list[str]:
    """The flax name of each of ``model.parameters()``, in their order."""
    by_id = {id(p): k for k, (p, _) in _flax_names(model).items()}
    return [by_id[id(p)] for p in model.parameters()]


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), <kind>(schedule))``
    over ``params``' ``.grad`` (a missing gradient counts as zeros, as a
    leaf off the loss's path has zero gradient in JAX), as JAX's
    ``make_optimizer`` builds it.  ``adamw``/``adam``: b1 0.9, b2 0.999,
    eps 1e-8 and no eps_root, bias-corrected; ``adamw`` adds the decoupled
    weight decay to the update before the learning rate; ``sgd``: no
    momentum; ``radam``: ``scale_by_radam`` (the same moments, the
    rectified update once rho_t >= 5, else the corrected first moment);
    ``ralamb``: radam's direction scaled per tensor by
    ``scale_by_trust_ratio`` (||param|| / ||update||, 1 where either is 0);
    ``rangerlars``: JAX's ``lookahead`` around ralamb, slow weights in the
    state, every 6th step moved half way to the fast ones and taken as the
    parameters; ``rms``: ``rmsprop`` (decay 0.9, eps 1e-8 inside the
    root).

    ``frozen`` (one bool per parameter, ``frozen_flags``): JAX chains
    ``optax.masked(set_to_zero)`` after the whole chain, so a frozen
    parameter still counts in the clipped norm and its moments still
    update; only its update is zeroed.

    ``accum_steps`` k > 1 is ``optax.MultiSteps(chain, every_k_schedule=k)``:
    each step folds its gradients into their running mean (Welford's
    update, as optax's); the k-th clips that mean and applies the update,
    and the others change no parameter.  The count, and so the schedule,
    advances only on an applying step."""

    def __init__(self, params, kind: str, schedule, grad_clip: float,
                 weight_decay: float = 0.0, accum_steps: int = 1,
                 frozen=None):
        if kind not in OPTIMIZERS:
            raise ValueError(f"optim={kind!r}: use one of {OPTIMIZERS}")
        self.params = list(params)
        self.kind, self.schedule = kind, schedule
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.accum_steps = max(int(accum_steps), 1)
        self.frozen = (list(frozen) if frozen is not None and any(frozen)
                       else None)
        self.count = 0
        self.mini_step = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        if kind not in ("sgd", "rms"):
            self.mu = zeros()
        if kind != "sgd":
            self.nu = zeros()
        if kind == "rangerlars":
            self.slow = [p.detach().clone() for p in self.params]
        if self.accum_steps > 1:
            self.acc = zeros()

    def grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def shard(self, mesh) -> None:
        """Cut the per-parameter state to this rank's slices where
        ``parallel.shard_params`` split the parameters (state already
        loaded is kept); norms then count each split leaf whole."""
        for name in self._buffers():
            setattr(self, name, [local_slice(p, t).clone() for p, t in
                                 zip(self.params, getattr(self, name))])

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One step from the accumulated ``.grad``; returns their global
        norm before clipping (this step's, under accumulation too)."""
        grads = self.grads()
        norm = global_norm(grads, self.params)
        if self.accum_steps > 1:
            # acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, self.mini_step + 1)
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < self.accum_steps - 1:
                self.mini_step += 1
                return norm
            grads = self.acc
            self.acc = [torch.zeros_like(p) for p in self.params]
            self.mini_step = 0
            self._apply(grads, global_norm(grads, self.params))
        else:
            self._apply(grads, norm)
        return norm

    def _apply(self, grads, norm):
        """The update from ``grads`` (global norm ``norm``), clipped, at the
        current count."""
        scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        t = self.count + 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        if self.kind == "sgd":
            update = grads
        elif self.kind == "rms":
            torch._foreach_mul_(self.nu, 0.9)
            torch._foreach_addcmul_(self.nu, grads, grads, value=0.1)
            update = torch._foreach_mul(grads, torch._foreach_rsqrt(
                torch._foreach_add(self.nu, eps)))
        else:
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
            mu_hat = torch._foreach_div(self.mu, float(1 - _f32_pow(b1, t)))
            nu_hat = torch._foreach_div(self.nu, float(1 - _f32_pow(b2, t)))
            if self.kind in ("adam", "adamw"):
                update = self._adam(mu_hat, nu_hat, eps)
            else:
                update = self._radam(mu_hat, nu_hat, eps, b2, t)
        # the update to add to the parameters
        delta = torch._foreach_mul(update, -lr)
        if self.kind == "rangerlars":
            delta = self._lookahead(delta, t)
        if self.frozen is not None:
            for d, frozen in zip(delta, self.frozen):
                if frozen:
                    d.zero_()
        torch._foreach_add_(self.params, delta)
        self.count += 1

    def _adam(self, mu_hat, nu_hat, eps):
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        update = torch._foreach_div(mu_hat, denom)
        if self.kind == "adamw" and self.weight_decay:
            torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        return update

    def _radam(self, mu_hat, nu_hat, eps, b2, t):
        """``scale_by_radam`` (threshold 5), then for ralamb and rangerlars
        ``scale_by_trust_ratio``."""
        f32 = np.float32
        ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
        b2t = _f32_pow(b2, t)
        ro = ro_inf - f32(2 * t) * b2t / (f32(1) - b2t)
        if ro >= 5.0:
            r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                              / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro)))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, eps)
            update = torch._foreach_div(torch._foreach_mul(mu_hat, r), denom)
        else:
            update = mu_hat
        if self.kind == "radam":
            return update
        p_norm = self._leaf_norms(self.params)
        u_norm = self._leaf_norms(update)
        return [u * torch.where((pn == 0) | (un == 0), 1.0, pn / un)
                for u, pn, un in zip(update, p_norm, u_norm)]

    def _leaf_norms(self, tensors):
        """Each tensor's norm, of the whole leaf where a mesh split it."""
        norms = torch._foreach_norm(tensors)
        whole = _whole_norms(norms, self.params)
        return norms if whole is None else list(whole.unbind())

    def _lookahead(self, delta, t, sync_period=6, slow_step=0.5):
        """JAX's ``lookahead``: the fast weights are the parameters plus
        the inner update; every ``sync_period``-th step the slow weights
        move ``slow_step`` of the way to them and the parameters jump to
        the slow weights.  Returns the update that gets there."""
        fast = torch._foreach_add(self.params, delta)
        if t % sync_period:
            return torch._foreach_sub(fast, self.params)
        torch._foreach_add_(self.slow, torch._foreach_sub(fast, self.slow),
                            alpha=slow_step)
        return torch._foreach_sub(self.slow, self.params)

    def _buffers(self) -> list[str]:
        """The per-parameter state this optimizer keeps."""
        return [n for n in ("mu", "nu", "slow", "acc") if hasattr(self, n)]

    def state_dict(self) -> dict:
        """The moments, the slow weights, the running mean, the count and
        the mini-step (the parameters are the model's)."""
        state = {"count": self.count, "mini_step": self.mini_step}
        for name in self._buffers():
            # whole leaves on a mesh (a collective)
            state[name] = [full_tensor(p, t).clone() for p, t in
                           zip(self.params, getattr(self, name))]
        return state

    def load_state_dict(self, state: dict) -> None:
        want = sorted(["count", "mini_step"] + self._buffers())
        if sorted(state) != want:
            raise KeyError(f"optimizer state {sorted(state)} does not match "
                           f"{want}")
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for name in self._buffers():
            mine = getattr(self, name)
            # whole leaves, cut to this rank's slices on a mesh
            theirs = [local_slice(p, t)
                      for p, t in zip(self.params, state[name])]
            if [t.shape for t in theirs] != [t.shape for t in mine]:
                raise ValueError(f"optimizer state {name}: shapes do not "
                                 "match the parameters")
            setattr(self, name, [t.to(m.device, m.dtype).clone()
                                 for t, m in zip(theirs, mine)])


def make_optimizer(cfg, params, lr=None, names=None) -> Optimizer:
    """The trainer's optimizer over ``params``: ``cfg.train.optim`` at the
    lr schedule (or the constant ``lr``), behind ``clip_by_global_norm``;
    with ``names`` (each parameter's flax name) the ``fix_*`` freezing."""
    t = cfg.train
    sched = make_lr_schedule(cfg) if lr is None else (lambda step: lr)
    params = list(params)
    return Optimizer(params, t.optim.lower(), sched, t.grad_clip,
                     t.weight_decay, t.accum_steps,
                     frozen=None if names is None else frozen_flags(t, names))


class Trainer:
    """Owns the student (and the teacher under distillation), the critic,
    the optimizers, and the train step.  ``device`` defaults to ``"cuda"``
    and raises without a GPU unless it is ``"cpu"``.  Weights are random
    from ``cfg.train.seed`` (teacher ``seed + 1``, critic ``seed + 7``);
    ``utils.weights.load_trainer_params`` loads a JAX trainer's.
    ``aug_features``: the EnvEdit feature table that aug batches read
    (``Tables.from_world``)."""

    def __init__(self, cfg: MagicConfig, world: World, device="cuda",
                 aug_features=None):
        self.cfg = cfg
        self.world = world
        self.device = resolve_device(device)
        self.tables = Tables.from_world(world.tables, self.device,
                                        aug_features=aug_features)
        self.compute_dtype = getattr(torch, cfg.train.compute_dtype)
        seed = cfg.train.seed
        self.model = DualScaleVLNBert(cfg.model, device=self.device)
        init_params(self.model, seed)
        self.kdl = cfg.distill.train_kdl and cfg.teacher_model is not None
        self.icod = self.kdl and cfg.distill.train_teacher
        self.teacher_model = None
        if self.kdl:
            self.teacher_model = DualScaleVLNBert(cfg.teacher_model,
                                                  device=self.device)
            init_params(self.teacher_model, seed + 1)
            # a frozen teacher records no graph
            self.teacher_model.requires_grad_(self.icod)
        # value head, built as the reference agent does; the A2C branch
        # trains it, except under ICoD, where JAX's step takes the
        # teacher's partition instead (trainer.py:445-464)
        self.rl = cfg.train.train_alg not in ("imitation", "dagger")
        self.critic = Critic(cfg.model.hidden_size, device=self.device)
        init_params(self.critic, seed + 7)
        self.train_critic = self.rl and not self.icod
        self.critic.requires_grad_(self.train_critic)
        self.rollout = Rollout(self.tables, cfg.env, self.model,
                               self.teacher_model)
        self.opt = make_optimizer(cfg, self.model.parameters(),
                                  names=flax_param_names(self.model))
        self.t_opt = (make_optimizer(cfg, self.teacher_model.parameters(),
                                     lr=cfg.distill.t_lr)
                      if self.icod else None)
        self.c_opt = make_optimizer(cfg, self.critic.parameters())
        self.iteration = 0
        # {role: build_rollout_zdicts(...)}: the intervention dictionaries
        # of both roles, which compute_grads and train_step default to
        self.zdicts: dict = {}
        # the 'grad' ability weights' per-ability KD gradient norms, order
        # distill.ABILITIES, EMA-updated by update_ability_grads
        self.ability_grads = np.zeros(5, np.float32)
        self._seeds = np.random.default_rng(seed)      # a rollout seed a step
        self._data_rng = np.random.default_rng(seed)   # fit()'s data order
        self.mesh = None                               # use_mesh

    # ------------------------------------------------------------------

    def _batch(self, items, aug=False, observed_parity=None):
        """The episode state and instructions of ``items``; on a mesh, of
        this rank's dp rows of them (the instructions padded as the whole
        batch pads them)."""
        c = self.cfg
        ids, masks = pad_instructions(items, c.env.max_instr_len)
        if self.mesh is not None:
            rows = self.mesh.rows(len(items))
            items, ids, masks = items[rows], ids[rows], masks[rows]
        state0 = episodes_from_items(
            self.tables, items, c.model.hidden_size,
            observed_parity=(c.env.observed_graph_parity
                             if observed_parity is None else observed_parity),
            teacher_size=(c.teacher_model.hidden_size if self.kdl else None),
            aug=aug and self.tables.aug_features is not None)
        to = lambda a: torch.from_numpy(a).to(self.device)
        return state0, to(ids), to(masks)

    def _run(self, state0, txt_ids, txt_masks, feedback, train_ml, seed,
             zdicts, **kw):
        """A training rollout of this trainer's configuration."""
        c = self.cfg
        return self.rollout.run(
            state0, txt_ids, txt_masks, feedback, seed=seed,
            train_ml=train_ml, deterministic=False,
            distill=c.distill if self.kdl else None,
            remat=c.train.remat_policy if c.train.remat else False,
            zdicts=zdicts, ability_grads=self.ability_grads, **kw)

    def _loss_for_rollout(self, state0, txt_ids, txt_masks, feedback,
                          train_ml, seed, zdicts=None):
        """(student loss, teacher loss, metrics) of one rollout."""
        c = self.cfg
        aux = self._run(state0, txt_ids, txt_masks, feedback, train_ml, seed,
                        zdicts)
        bs = self._global_bs(state0)
        ml = aux["ml_loss"] * train_ml / bs
        metrics = {"ml_loss": ml, "gmap_overflow": aux["gmap_overflow"]}
        t_total = torch.zeros((), device=self.device)
        if not self.kdl:
            return ml, t_total, metrics
        kd = total_kd_loss(aux["kd_losses"]) / bs
        total = c.distill.alpha * kd + (1 - c.distill.alpha) * ml
        metrics["kdl_loss"] = kd
        if c.distill.train_teacher:
            t_ml = aux["t_ml_loss"] * train_ml / bs
            t_kd = total_kd_loss(aux["t_kd_losses"]) * train_ml
            t_total = c.distill.t_alpha * t_kd + (1 - c.distill.t_alpha) * t_ml
            metrics["t_loss"] = t_total
        return total, t_total, metrics

    def _loss_for_fused_rollouts(self, state0, txt_ids, txt_masks, seed,
                                 zdicts=None):
        """The DAgger step's two rollouts as one (``Rollout.run``'s
        ``fused_split``): the batch doubled, rows [0, B) teacher-forced and
        rows [B, 2B) following ``dagger_sample``, each half's sums weighted
        as the two separate rollouts weight theirs; metrics named ``il/``
        and ``dagger/`` as theirs (JAX ``_loss_for_fused_rollouts``)."""
        c = self.cfg
        d = c.distill
        dup = lambda x: None if x is None else torch.cat([x, x])
        state2 = dataclasses.replace(state0, **{
            f.name: dup(getattr(state0, f.name))
            for f in dataclasses.fields(state0)})
        # on a mesh both halves of the batch axis split over dp
        with self._active(blocks=2):
            aux = self._run(state2, dup(txt_ids), dup(txt_masks),
                            f"teacher+{c.train.dagger_sample}", 1.0, seed,
                            zdicts, fused_split=state0.batch_size)
        bs = self._global_bs(state0)
        w = (c.train.ml_weight, 1.0)
        ml = [aux["ml_loss_vec"][i] * w[i] / bs for i in (0, 1)]
        metrics = {"il/ml_loss": ml[0], "dagger/ml_loss": ml[1],
                   "il/gmap_overflow": aux["gmap_overflow_tf"],
                   "dagger/gmap_overflow": aux["gmap_overflow_dg"]}
        t_total = torch.zeros((), device=self.device)
        if not self.kdl:
            return ml[0] + ml[1], t_total, metrics
        kd = [total_kd_loss(aux[f"kd_losses_{h}"]) / bs for h in ("tf", "dg")]
        total = sum(d.alpha * kd[i] + (1 - d.alpha) * ml[i] for i in (0, 1))
        metrics["il/kdl_loss"], metrics["dagger/kdl_loss"] = kd
        if d.train_teacher:
            t_ml = [aux["t_ml_loss_vec"][i] * w[i] / bs for i in (0, 1)]
            t_kd = [total_kd_loss(aux[f"t_kd_losses_{h}"]) * w[i]
                    for i, h in enumerate(("tf", "dg"))]
            t_half = [d.t_alpha * t_kd[i] + (1 - d.t_alpha) * t_ml[i]
                      for i in (0, 1)]
            metrics["il/t_loss"], metrics["dagger/t_loss"] = t_half
            t_total = t_half[0] + t_half[1]
        return total, t_total, metrics

    def _loss_for_rl(self, state0, txt_ids, txt_masks, seed, zdicts=None):
        """The A2C rollout's loss, (policy + value - entropy_loss_weight *
        entropy) / B, on sampled feedback, no teacher (JAX ``trainer.py``
        404-425)."""
        c = self.cfg
        aux = self.rollout.run(
            state0, txt_ids, txt_masks, "sample", seed=seed,
            deterministic=False, train_rl=True, critic=self.critic,
            gamma=c.train.gamma, zdicts=zdicts)
        rl = (aux["rl_loss"] - c.train.entropy_loss_weight
              * aux["rl_entropy"]) / self._global_bs(state0)
        return rl, torch.zeros((), device=self.device), {"rl/loss": rl}

    def _rollouts(self):
        """(kind, metric prefix, feedback, loss weight, sub-seed) of each
        rollout of a step: kind ``one`` (a rollout), ``fused`` (the DAgger
        step's two as one) or ``rl`` (the A2C rollout)."""
        t = self.cfg.train
        if t.train_alg == "imitation":
            return [("one", "il", "teacher", 1.0, 0)]
        first = ([("one", "il", "teacher", t.ml_weight, 0)]
                 if t.ml_weight != 0 else [])
        if t.train_alg != "dagger":
            return first + [("rl", "rl", "sample", None, 1)]
        if t.fuse_rollouts and first:
            return [("fused", "", None, None, 0)]
        return first + [("one", "dagger", t.dagger_sample, 1.0, 1)]

    def _global_bs(self, state0) -> int:
        """The batch the losses are normalised by: the global one on a
        mesh, where each rank's losses are its share."""
        return state0.batch_size * (self.mesh.dp if self.mesh else 1)

    def _active(self, blocks: int = 1):
        """The mesh's active region (``parallel.mesh``), or none."""
        return (self.mesh.active(blocks) if self.mesh is not None
                else nullcontext())

    def _trained_params(self) -> list:
        """The parameters a step trains: the student's, the teacher's
        under ICoD, the critic's under A2C."""
        params = list(self.model.parameters())
        if self.icod:
            params += list(self.teacher_model.parameters())
        elif self.train_critic:
            params += list(self.critic.parameters())
        return params

    def autocast(self):
        """The forwards' autocast context: bf16 under
        ``compute_dtype="bfloat16"``, else none.  Autocast's cache is off:
        with it on, a weight is cast once for the whole region, every use
        reads that one cast, and autograd sums the uses' gradients there,
        in bf16, before converting once; off, each use casts anew and the
        gradients sum in f32 at the master, as JAX's f32 gradients do
        (flax converts inside each call).  The price is one cast per use."""
        if self.compute_dtype == torch.bfloat16:
            return torch.autocast(self.device.type, dtype=torch.bfloat16,
                                  cache_enabled=False)
        return nullcontext()

    @contextmanager
    def _bf16_weights(self):
        """``grads_dtype="bfloat16"`` (JAX ``trainer.py:350-366``, which
        casts ``params`` and ``t_params``): the student's and the teacher's
        f32 masters are replaced for the step by bf16 copies that are
        leaves of their own, so every use's gradient, across the step's
        rollouts, sums into the copy's bf16 ``.grad``; on exit the masters
        return and take those sums as f32.  A frozen teacher's copies
        record no gradient.  Each model's ``bf16_weights`` is set for the
        step, so that its learned ability weights come out in bf16.  Under
        f32 compute each op converts its bf16 operands to f32 where it
        reads them (``_PromoteBf16``), as flax promotes them; under
        autocast on the CPU the layer norms do, which CPU autocast leaves
        to the input's dtype (f32); CUDA autocast casts a layer norm's
        operands to f32 itself, so there no op is intercepted."""
        models = [self.model] + ([self.teacher_model] if self.kdl else [])
        copies, swaps = {}, []
        for m in models:
            for mod in m.modules():
                for name, p in mod._parameters.items():
                    if p is None or p.dtype != torch.float32:
                        continue
                    if id(p) not in copies:
                        copies[id(p)] = (p, p.detach().to(torch.bfloat16)
                                         .requires_grad_(p.requires_grad))
                    swaps.append((mod, name, p))
                    mod._parameters[name] = copies[id(p)][1]
        if self.compute_dtype == torch.float32:
            promote = _PromoteBf16()
        elif self.device.type == "cpu":
            promote = _PromoteBf16(_LAYER_NORMS)
        else:
            promote = nullcontext()
        for m in models:
            m.bf16_weights = True
        try:
            with promote:
                yield
        finally:
            for m in models:
                m.bf16_weights = False
            for mod, name, p in swaps:
                mod._parameters[name] = p
            for p, low in copies.values():
                if low.grad is not None:
                    p.grad = low.grad.float()

    def _accumulate_grads(self, items, seed: int, zdicts=None,
                          aug=False) -> dict:
        """Each rollout's losses, backpropagated into ``.grad`` as soon as
        they are built (ICoD: the student's and the teacher's loss in one
        backward); returns the metrics as tensors and the objective, the sum
        of the student's and the teacher's losses."""
        state0, ids, masks = self._batch(items, aug)
        metrics = {}
        loss = objective = torch.zeros((), device=self.device)
        weights = (self._bf16_weights()
                   if self.cfg.train.grads_dtype == "bfloat16"
                   else nullcontext())
        with weights, self._active():
            for kind, prefix, feedback, weight, sub in self._rollouts():
                with self.autocast():
                    if kind == "fused":
                        total, t_total, m = self._loss_for_fused_rollouts(
                            state0, ids, masks, seed * 2 + sub, zdicts)
                    elif kind == "rl":
                        total, t_total, m = self._loss_for_rl(
                            state0, ids, masks, seed * 2 + sub, zdicts)
                    else:
                        total, t_total, m = self._loss_for_rollout(
                            state0, ids, masks, feedback, weight,
                            seed * 2 + sub, zdicts)
                        m = {f"{prefix}/{k}": v for k, v in m.items()}
                (total + t_total).backward()
                loss = loss + total.detach()
                objective = objective + (total + t_total).detach()
                metrics.update({k: v.detach() for k, v in m.items()})
        metrics["loss"] = loss
        if self.mesh is not None:
            # each rank's gradients and losses are its share of the
            # global batch's
            reduce_gradients(self._trained_params(), self.mesh)
            metrics["objective"] = objective
            metrics = reduce_metrics(metrics, self.mesh)
            objective = metrics.pop("objective")
        return metrics, objective

    def _zero_grad(self):
        for opt in (self.opt, self.t_opt, self.c_opt):
            if opt is not None:
                opt.zero_grad()

    def compute_grads(self, items, seed: int = 0, zdicts=None, aug=False):
        """Gradients of one batch with no optimizer update: ``(objective,
        grads)``, the objective being the student's loss plus, under ICoD,
        the teacher's (what the gradients are of), ``grads`` a dict of
        ``{"params": ...}`` and ``"t_params"`` under ICoD or else
        ``"critic_params"`` under A2C (JAX's partitions), each ``{flax
        name: tensor}`` in the flax layout (``utils.weights.
        flax_named_grads``; whole leaves on a mesh, summed over dp).
        ``seed`` is explicit, so both sides of a comparison draw alike.
        ``zdicts`` defaults to ``self.zdicts``; ``aug`` reads the aug
        feature table."""
        self._zero_grad()
        _, objective = self._accumulate_grads(
            items, seed, self.zdicts if zdicts is None else zdicts, aug)
        grads = {"params": flax_named_grads(self.model)}
        if self.icod:
            grads["t_params"] = flax_named_grads(self.teacher_model)
        elif self.train_critic:
            grads["critic_params"] = flax_named_grads(self.critic)
        self._zero_grad()
        return objective, grads

    def train_step(self, items, zdicts=None, aug=False) -> dict:
        """One optimizer step on ``items``; returns the metrics as floats
        (one device-to-host copy): per rollout ``il/`` or ``dagger/``
        ``ml_loss``, ``gmap_overflow`` and, under distillation,
        ``kdl_loss`` and (ICoD) ``t_loss``; ``rl/loss`` under A2C;
        ``loss`` (the student's) and ``grad_norm`` (the student's, before
        clipping).  ``zdicts`` defaults to ``self.zdicts``; ``aug`` reads
        the aug feature table."""
        self._zero_grad()
        metrics, _ = self._accumulate_grads(
            items, int(self._seeds.integers(2 ** 62)),
            self.zdicts if zdicts is None else zdicts, aug)
        metrics["grad_norm"] = self.opt.step()
        if self.icod:
            self.t_opt.step()
        elif self.train_critic:
            self.c_opt.step()
        self._zero_grad()
        self.iteration += 1
        names = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in names]).tolist()
        return dict(zip(names, vals))

    def fit(self, items, iters, log_every=100, rng=None, callback=None,
            aug_items=None, speaker=None, speaker_tok=None, aug_times=1):
        """Host loop: shuffle, minibatch, step (JAX ``fit``).  With
        ``aug_items``, every ``aug_times + 1``-th batch is a train batch
        and the others aug batches (read with ``aug=True``), each list
        cycled through its own permutations, all drawn from one data-order
        rng that persists across calls.  With a ``speaker`` (and its
        ``speaker_tok``) an aug batch is back-translated first, its noise
        drawn from ``cfg.train.seed + it`` (``it`` counting from 0 in each
        call, as JAX's), and each item re-encoded with the navigator's
        ``HashTokenizer`` (the self-train path, agent.py:737-752).  Each
        history entry carries ``aug``, 1.0 for an aug batch."""
        r = rng if rng is not None else self._data_rng
        bs = self.cfg.train.batch_size

        def cycler(data):
            order, pos = r.permutation(len(data)), 0
            while True:
                if pos + bs > len(order):
                    order, pos = r.permutation(len(data)), 0
                yield [data[i] for i in order[pos : pos + bs]]
                pos += bs

        train_c = cycler(items)
        aug_c = cycler(aug_items) if aug_items else None
        history = []
        for it in range(iters):
            use_aug = bool(aug_c is not None and aug_times
                           and it % (aug_times + 1) != 0)
            batch = next(aug_c) if use_aug else next(train_c)
            if use_aug and speaker is not None and speaker_tok is not None:
                batch, _ = speaker.back_translate(
                    batch, speaker_tok, rng=self.cfg.train.seed + it)
                tok = HashTokenizer(self.cfg.model.vocab_size)
                for b in batch:
                    b["instr_encoding"] = np.asarray(
                        tok.encode(b["instruction"]), np.int32)
            m = (self.train_step(batch, aug=True) if use_aug
                 else self.train_step(batch))
            m["aug"] = float(use_aug)
            history.append(m)
            if callback and (it + 1) % log_every == 0:
                callback(it + 1, m)
        return history

    # ----- checkpoints (agent_base.py:298-359 semantics) -----

    def save(self, path: str, save_optimizer: bool = False):
        """The reference ``.pt`` container of the student at ``path``
        (epoch = ``iteration``), the teacher's beside it as
        ``teacher_<file>`` when it co-trains, and with ``save_optimizer``
        the student's optimizer state under ``<path>.opt``."""
        save_reference_checkpoint(self.model, path, epoch=self.iteration)
        if self.icod:
            d, f = os.path.split(path)
            save_reference_checkpoint(self.teacher_model,
                                      os.path.join(d, "teacher_" + f),
                                      epoch=self.iteration)
        if save_optimizer:
            CheckpointManager(path + ".opt").save("opt_state",
                                                  self.opt.state_dict())

    def load(self, path: str, resume_optimizer: bool = False,
             teacher_path: str | None = None):
        """Load the student from a reference ``.pt`` file (names absent
        from it keep their values) and take its epoch as ``iteration``;
        with ``teacher_path`` the teacher too, without its KD heads unless
        it co-trains; with ``resume_optimizer`` the optimizer state that
        ``save(save_optimizer=True)`` wrote.  Returns ``(epoch, missing,
        unexpected)`` of the student's load."""
        self._refuse_on_mesh("load")
        epoch, missing, unexpected = restore_reference_checkpoint(
            self.model, path)
        self.iteration = epoch
        if teacher_path and self.teacher_model is not None:
            restore_reference_checkpoint(
                self.teacher_model, teacher_path,
                drop_kd_heads=not self.cfg.distill.train_teacher)
        if resume_optimizer:
            mgr = CheckpointManager(path + ".opt")
            if mgr.has("opt_state"):
                self.opt.load_state_dict(mgr.restore("opt_state"))
        return epoch, missing, unexpected

    def load_pretrained(self, path: str, role: str = "student"):
        """Load a pretraining checkpoint's trunk (``model_step_N.pt`` of
        either package) into the student or the teacher
        (``--bert_ckpt_file``, main_nav.py:536-556): the ``bert.`` prefix is
        stripped and the task heads dropped.  Parameters the file lacks
        keep their init values.  Returns ``(missing, unexpected)``."""
        model = {"student": self.model,
                 "teacher": self.teacher_model}.get(role, False)
        if model is False:
            raise ValueError(f"role {role!r}: use 'student' or 'teacher'")
        if model is None:
            raise ValueError("this trainer has no teacher")
        self._refuse_on_mesh("load_pretrained")
        _, missing, unexpected = restore_reference_checkpoint(
            model, path, key_map=pretrain_to_nav_key_map)
        return missing, unexpected

    def _state(self) -> dict:
        """The train state by name: each model's parameters and each
        optimizer's state (``None`` where the trainer has no such model or
        optimizer), ``iteration``, the rollout-seed generator and the
        ability-gradient norms."""
        teacher, t_opt = self.teacher_model, self.t_opt
        # whole leaves on a mesh
        return {"params": full_state_dict(self.model),
                "opt_state": self.opt.state_dict(),
                "critic_params": full_state_dict(self.critic),
                "critic_opt_state": self.c_opt.state_dict(),
                "t_params": (None if teacher is None
                             else full_state_dict(teacher)),
                "t_opt_state": None if t_opt is None else t_opt.state_dict(),
                "iteration": self.iteration,
                "seeds": self._seeds.bit_generator.state,
                "ability_grads": torch.from_numpy(self.ability_grads.copy())}

    def save_state(self, ckpt_dir: str, name: str = "train_state") -> str:
        """The whole resumable train state under ``name`` in ``ckpt_dir``:
        the parameters of every model, every optimizer, ``iteration``, the
        rollout-seed generator and the ability-gradient norms."""
        return CheckpointManager(ckpt_dir).save(name, self._state())

    def load_state(self, ckpt_dir: str, name: str = "train_state") -> bool:
        """Restore what ``save_state`` wrote; False if it is absent.  The
        data order resumes from ``seed + iteration`` (trainer.py:672)."""
        mgr = CheckpointManager(ckpt_dir)
        if not mgr.has(name):
            return False
        self._refuse_on_mesh("load_state")
        state = mgr.restore(name, map_location=self.device)
        for key, mine in (("t_params", self.teacher_model),
                          ("t_opt_state", self.t_opt)):
            if (state[key] is None) != (mine is None):
                raise ValueError(f"train state {key}: the trainer has "
                                 f"{'no' if mine is None else 'a'} "
                                 "matching model or optimizer")
        self.model.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt_state"])
        self.critic.load_state_dict(state["critic_params"])
        self.c_opt.load_state_dict(state["critic_opt_state"])
        self.ability_grads = state["ability_grads"].cpu().numpy().astype(
            np.float32)
        if self.teacher_model is not None:
            self.teacher_model.load_state_dict(state["t_params"])
        if self.t_opt is not None:
            self.t_opt.load_state_dict(state["t_opt_state"])
        self.iteration = int(state["iteration"])
        self._seeds.bit_generator.state = state["seeds"]
        self._data_rng = np.random.default_rng(self.cfg.train.seed
                                               + self.iteration)
        return True

    # ----- the 'grad' adaptive ability weights -----

    def update_ability_grads(self, items, ema: float = ABILITY_EMA):
        """The per-ability KD gradient magnitudes that the ``grad`` ability
        weights read (JAX ``update_ability_grads``): for each ability of
        ``distill.ABILITIES`` one teacher-forced, deterministic rollout
        with that ability's KD losses alone (no adaptive weights, no
        teacher training), the global norm of the student's gradient of
        their total / B, EMA-combined (``ema`` of the old) into
        ``ability_grads``, which it returns.  The rollouts keep the einsum
        attention path (``need_maps``).  Without distillation it returns
        them unchanged."""
        from .distill import ABILITIES

        if not self.kdl:
            return self.ability_grads
        state0, ids, masks = self._batch(items, observed_parity=False)
        params = list(self.model.parameters())
        norms = []
        # only the student's gradient is taken: the teacher records no graph
        self.teacher_model.requires_grad_(False)
        try:
            for a in ABILITIES:
                norms.append(self._ability_grad_norm(a, state0, ids, masks,
                                                     params))
        finally:
            self.teacher_model.requires_grad_(self.icod)
        new = torch.stack(norms).float().cpu().numpy()
        self.ability_grads = (ema * self.ability_grads
                              + (1 - ema) * new).astype(np.float32)
        return self.ability_grads

    def _ability_grad_norm(self, ability, state0, ids, masks, params):
        """The global norm of the student's gradient of ``ability``'s KD
        losses / B over one teacher-forced, deterministic rollout."""
        d = dataclasses.replace(self.cfg.distill, ability_types=(ability,),
                                adaptive_ability_weight=False,
                                train_teacher=False)
        with self.autocast(), self._active():
            aux = self.rollout.run(state0, ids, masks, "teacher",
                                   train_ml=1.0, deterministic=True,
                                   distill=d)
            loss = total_kd_loss(aux["kd_losses"]) / self._global_bs(state0)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        if self.mesh is not None:
            all_reduce_tensors(grads, self.mesh.dp_group)
        return global_norm(grads, params)

    # ----- a device mesh -----

    def use_mesh(self, mesh):
        """Train over a dp x mp mesh (``parallel.make_mesh``; JAX
        ``use_mesh``, the reference's DDP default, main_nav.py:681 +
        agent_base.py:114-116): the student, the teacher, the critic and
        their optimizer states are sharded in place
        (``parallel.shard_params``: Megatron splits over mp, the state
        already loaded kept, so call it after any load).  Every rank then
        takes the global ``items`` of a step, rolls out its dp rows with
        the draws of the global batch, normalises each loss by the global
        batch and sums the gradients and metrics over dp, so a step
        equals one process's on the same batch, and every rank returns
        its metrics.  The global batch size must divide by dp."""
        dp = mesh.shape.get("dp", 1)
        if self.cfg.train.batch_size % dp != 0:
            raise ValueError(
                f"global batch_size {self.cfg.train.batch_size} not "
                f"divisible by dp={dp}; the CLI scales batch_size by dp "
                f"(per-device batch x devices, DDP semantics)")
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device}, the trainer on "
                             f"{self.device}")
        self.mesh = mesh
        for model in (self.model, self.teacher_model, self.critic):
            shard_params(model, mesh)
        for opt in (self.opt, self.t_opt, self.c_opt):
            shard_params(opt, mesh)
        return self

    def _refuse_on_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise ValueError(f"{what} loads whole leaves: call it before "
                             "use_mesh")


_LAYER_NORMS = (torch.nn.functional.layer_norm, torch.layer_norm)


class _PromoteBf16(torch.overrides.TorchFunctionMode):
    """Every bf16 tensor an op (of ``only``, if given) reads is converted
    to f32 at the op: f32 compute from bf16 weight copies, one conversion
    per use, as flax's ``promote_dtype`` (``Trainer._bf16_weights``)."""

    def __init__(self, only=None):
        super().__init__()
        self.only = only

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.only is not None and func not in self.only:
            return func(*args, **(kwargs or {}))
        up = lambda x: (x.float() if isinstance(x, torch.Tensor)
                        and x.dtype == torch.bfloat16 else x)
        args = [up(x) if not isinstance(x, (list, tuple))
                else type(x)(up(y) for y in x) for x in args]
        kwargs = {k: up(v) for k, v in (kwargs or {}).items()}
        return func(*args, **kwargs)
