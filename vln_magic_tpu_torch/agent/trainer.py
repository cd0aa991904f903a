"""Training: imitation / DAgger fine-tuning with MAKD distillation and ICoD.

Port of ``vln_magic_tpu/agent/trainer.py`` for ``train_alg`` ``imitation``
and ``dagger``.  A DAgger step runs two rollouts (teacher-forced at
``ml_weight``, then on-policy with ``dagger_sample`` at 1.0); with
distillation each rollout runs the MAGIC teacher beside the student and
adds the MAKD losses (MKTD sample weights, MKRW or learned ability
weights); with ``train_teacher`` (ICoD) the teacher trains on its own CE
and the reverse losses, with its own optimizer at ``t_lr``.

The reference takes one ``jax.grad`` of ``total + t_total`` over both
parameter partitions.  Here each rollout's loss is backpropagated as soon
as it is built (the rollouts' losses add up, so the gradients accumulated
in ``.grad`` are those of the sum, with one rollout's activations alive at
a time); then each optimizer clips its own gradients and steps once.
Parameters are f32 masters; with ``compute_dtype="bfloat16"`` the forward
runs under ``torch.autocast``, as flax's ``dtype=bf16`` modules compute
from f32 params.  ``accum_steps`` > 1 applies each optimizer every k steps
to the mean gradient (``Optimizer``, optax's ``MultiSteps``).

Checkpoints (agent_base.py:298-359): ``save``/``load`` write and read the
reference ``.pt`` container, which the JAX package reads and writes too;
``load_pretrained`` takes a pretraining trunk (``model_step_N.pt``) into
the student or the teacher; ``save_state``/``load_state`` keep the whole
train state in the port's own format (``utils.checkpoint``).
"""

from __future__ import annotations

import math
import os
from contextlib import nullcontext

import numpy as np
import torch

from ..config import MagicConfig
from ..env.world import World
from ..models.vlnbert import Critic, DualScaleVLNBert
from ..utils.checkpoint import (CheckpointManager, pretrain_to_nav_key_map,
                                restore_reference_checkpoint,
                                save_reference_checkpoint)
from ..utils.device import resolve_device
from ..utils.weights import flax_named_grads, init_params
from .distill import total_kd_loss
from .navigator import episodes_from_items, pad_instructions
from .rollout import Rollout, Tables

OPTIMIZERS = ("adamw", "adam", "sgd")


def _todo(what: str):
    return NotImplementedError(f"{what} is not ported to vln_magic_tpu_torch "
                               "yet (see ROADMAP.md)")


def refuse_unported_training(cfg: MagicConfig) -> None:
    """Raise ``NotImplementedError`` for a training configuration this port
    does not run yet."""
    t, d = cfg.train, cfg.distill
    checks = [
        (t.fuse_rollouts, "TrainConfig.fuse_rollouts (the fused dual "
                          "rollout)"),
        (t.train_alg not in ("imitation", "dagger"),
         f"train_alg={t.train_alg!r} (the A2C branch)"),
        (t.optim.lower() not in OPTIMIZERS, f"optim={t.optim!r}"),
        (t.fix_lang_embedding or t.fix_local_branch or t.fix_pano_embedding,
         "the fix_* parameter freezing"),
        (t.grads_dtype != "float32", f"grads_dtype={t.grads_dtype!r}"),
        (t.remat and t.remat_policy != "full",
         f"remat_policy={t.remat_policy!r}"),
        (cfg.model.fusion == "local", "fusion='local' in training"),
        (d.train_kdl and d.adaptive_ability_weight
         and d.adaptive_ability_weight_type not in ("RW", "learned_weight"),
         f"adaptive_ability_weight_type={d.adaptive_ability_weight_type!r}"),
    ]
    for bad, what in checks:
        if bad:
            raise _todo(what)


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


# ----- optimizers: clip_by_global_norm, then adamw / adam / sgd -----

def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), <kind>(schedule))``
    over ``params``' ``.grad`` (a missing gradient counts as zeros, as a
    leaf off the loss's path has zero gradient in JAX).  ``adamw``/``adam``:
    b1 0.9, b2 0.999, eps 1e-8 and no eps_root, bias-corrected; ``adamw``
    adds the decoupled weight decay to the update before the learning
    rate; ``sgd``: no momentum.

    ``accum_steps`` k > 1 is ``optax.MultiSteps(chain, every_k_schedule=k)``:
    each step folds its gradients into their running mean (Welford's
    update, as optax's); the k-th clips that mean and applies the update,
    and the others change no parameter.  The count, and so the schedule,
    advances only on an applying step."""

    def __init__(self, params, kind: str, schedule, grad_clip: float,
                 weight_decay: float = 0.0, accum_steps: int = 1):
        if kind not in OPTIMIZERS:
            raise _todo(f"optim={kind!r}")
        self.params = list(params)
        self.kind, self.schedule = kind, schedule
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.accum_steps = max(int(accum_steps), 1)
        self.count = 0
        self.mini_step = 0
        if kind != "sgd":
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        if self.accum_steps > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]

    def grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One step from the accumulated ``.grad``; returns their global
        norm before clipping (this step's, under accumulation too)."""
        grads = self.grads()
        norm = global_norm(grads)
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
            self._apply(grads, global_norm(grads))
        else:
            self._apply(grads, norm)
        return norm

    def _apply(self, grads, norm):
        """The update from ``grads`` (global norm ``norm``), clipped, at the
        current count."""
        scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        if self.kind == "sgd":
            torch._foreach_add_(self.params, grads, alpha=-lr)
        else:
            b1, b2, eps = 0.9, 0.999, 1e-8
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
            t = self.count + 1
            denom = torch._foreach_sqrt(torch._foreach_div(self.nu,
                                                           1 - b2 ** t))
            torch._foreach_add_(denom, eps)
            update = torch._foreach_div(
                torch._foreach_div(self.mu, 1 - b1 ** t), denom)
            if self.kind == "adamw" and self.weight_decay:
                torch._foreach_add_(update, self.params,
                                    alpha=self.weight_decay)
            torch._foreach_add_(self.params, update, alpha=-lr)
        self.count += 1

    def _buffers(self) -> list[str]:
        """The per-parameter state this optimizer keeps."""
        return [n for n in ("mu", "nu", "acc") if hasattr(self, n)]

    def state_dict(self) -> dict:
        """The moments, the running mean, the count and the mini-step (the
        parameters are the model's)."""
        state = {"count": self.count, "mini_step": self.mini_step}
        for name in self._buffers():
            state[name] = [t.detach().clone() for t in getattr(self, name)]
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
            if [t.shape for t in state[name]] != [t.shape for t in mine]:
                raise ValueError(f"optimizer state {name}: shapes do not "
                                 "match the parameters")
            setattr(self, name, [t.to(m.device, m.dtype).clone()
                                 for t, m in zip(state[name], mine)])


def make_optimizer(cfg, params, lr=None) -> Optimizer:
    """The trainer's optimizer over ``params``: ``cfg.train.optim`` at the
    lr schedule (or the constant ``lr``), behind ``clip_by_global_norm``."""
    t = cfg.train
    sched = make_lr_schedule(cfg) if lr is None else (lambda step: lr)
    return Optimizer(params, t.optim.lower(), sched, t.grad_clip,
                     t.weight_decay, t.accum_steps)


class Trainer:
    """Owns the student (and the teacher under distillation), the critic,
    the optimizers, and the train step.  ``device`` defaults to ``"cuda"``
    and raises without a GPU unless it is ``"cpu"``.  Weights are random
    from ``cfg.train.seed`` (teacher ``seed + 1``, critic ``seed + 7``);
    ``utils.weights.load_trainer_params`` loads a JAX trainer's."""

    def __init__(self, cfg: MagicConfig, world: World, device="cuda"):
        refuse_unported_training(cfg)
        self.cfg = cfg
        self.world = world
        self.device = resolve_device(device)
        self.tables = Tables.from_world(world.tables, self.device)
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
        # value head, built as the reference agent does; only the A2C
        # branch (not ported) trains it
        self.critic = Critic(cfg.model.hidden_size, device=self.device)
        init_params(self.critic, seed + 7)
        self.rollout = Rollout(self.tables, cfg.env, self.model,
                               self.teacher_model)
        self.opt = make_optimizer(cfg, self.model.parameters())
        self.t_opt = (make_optimizer(cfg, self.teacher_model.parameters(),
                                     lr=cfg.distill.t_lr)
                      if self.icod else None)
        self.iteration = 0
        # {role: build_rollout_zdicts(...)}: the intervention dictionaries
        # of both roles, which compute_grads and train_step default to
        self.zdicts: dict = {}
        self._seeds = np.random.default_rng(seed)      # a rollout seed a step
        self._data_rng = np.random.default_rng(seed)   # fit()'s data order

    # ------------------------------------------------------------------

    def _batch(self, items):
        c = self.cfg
        ids, masks = pad_instructions(items, c.env.max_instr_len)
        state0 = episodes_from_items(
            self.tables, items, c.model.hidden_size,
            observed_parity=c.env.observed_graph_parity,
            teacher_size=(c.teacher_model.hidden_size if self.kdl else None))
        to = lambda a: torch.from_numpy(a).to(self.device)
        return state0, to(ids), to(masks)

    def _loss_for_rollout(self, state0, txt_ids, txt_masks, feedback,
                          train_ml, seed, zdicts=None):
        """(student loss, teacher loss, metrics) of one rollout."""
        c = self.cfg
        aux = self.rollout.run(
            state0, txt_ids, txt_masks, feedback, seed=seed,
            train_ml=train_ml, deterministic=False,
            distill=c.distill if self.kdl else None, remat=c.train.remat,
            zdicts=zdicts)
        bs = state0.batch_size
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

    def _rollouts(self):
        """(metric prefix, feedback, loss weight, sub-seed) of each rollout
        of a step."""
        t = self.cfg.train
        if t.train_alg == "imitation":
            return [("il", "teacher", 1.0, 0)]
        first = [("il", "teacher", t.ml_weight, 0)] if t.ml_weight != 0 else []
        return first + [("dagger", t.dagger_sample, 1.0, 1)]

    def autocast(self):
        """The forwards' autocast context: bf16 under
        ``compute_dtype="bfloat16"``, else none."""
        if self.compute_dtype == torch.bfloat16:
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return nullcontext()

    def _accumulate_grads(self, items, seed: int, zdicts=None) -> dict:
        """Both rollouts' losses, each backpropagated into ``.grad`` as soon
        as it is built (ICoD: the student's and the teacher's loss in one
        backward); returns the metrics as tensors and the objective, the sum
        of the student's and the teacher's losses."""
        state0, ids, masks = self._batch(items)
        metrics = {}
        loss = objective = torch.zeros((), device=self.device)
        for prefix, feedback, weight, sub in self._rollouts():
            with self.autocast():
                total, t_total, m = self._loss_for_rollout(
                    state0, ids, masks, feedback, weight, seed * 2 + sub,
                    zdicts)
            (total + t_total).backward()
            loss = loss + total.detach()
            objective = objective + (total + t_total).detach()
            metrics.update({f"{prefix}/{k}": v.detach() for k, v in m.items()})
        metrics["loss"] = loss
        return metrics, objective

    def _zero_grad(self):
        self.opt.zero_grad()
        if self.t_opt is not None:      # a frozen teacher takes no gradient
            self.t_opt.zero_grad()

    def compute_grads(self, items, seed: int = 0, zdicts=None):
        """Gradients of one batch with no optimizer update: ``(objective,
        grads)``, the objective being the student's loss plus, under ICoD,
        the teacher's (what the gradients are of), ``grads`` a dict of ``{"params": ...}`` (and
        ``"t_params"`` under ICoD), each ``{flax name: tensor}`` in the flax
        layout (``utils.weights.flax_named_grads``).  ``seed`` is explicit,
        so both sides of a comparison draw alike.  ``zdicts`` defaults to
        ``self.zdicts``."""
        self._zero_grad()
        _, objective = self._accumulate_grads(
            items, seed, self.zdicts if zdicts is None else zdicts)
        grads = {"params": flax_named_grads(self.model)}
        if self.icod:
            grads["t_params"] = flax_named_grads(self.teacher_model)
        self._zero_grad()
        return objective, grads

    def train_step(self, items, zdicts=None) -> dict:
        """One optimizer step on ``items``; returns the metrics as floats
        (one device-to-host copy): per rollout ``il/`` or ``dagger/``
        ``ml_loss``, ``gmap_overflow`` and, under distillation,
        ``kdl_loss`` and (ICoD) ``t_loss``; ``loss`` (the student's) and
        ``grad_norm`` (the student's, before clipping).  ``zdicts``
        defaults to ``self.zdicts``."""
        self._zero_grad()
        metrics, _ = self._accumulate_grads(
            items, int(self._seeds.integers(2 ** 62)),
            self.zdicts if zdicts is None else zdicts)
        metrics["grad_norm"] = self.opt.step()
        if self.icod:
            self.t_opt.step()
        self._zero_grad()
        self.iteration += 1
        names = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in names]).tolist()
        return dict(zip(names, vals))

    def fit(self, items, iters, log_every=100, rng=None, callback=None,
            aug_items=None, speaker=None):
        """Host loop: shuffle, minibatch, step.  The data-order rng
        persists across calls.  Each history entry carries ``aug`` (1.0 for
        an aug batch, as JAX's ``fit``): 0.0, since aug batches are not
        ported."""
        if aug_items or speaker is not None:
            raise _todo("training on aug or speaker batches")
        r = rng if rng is not None else self._data_rng
        bs = self.cfg.train.batch_size
        order, pos = r.permutation(len(items)), 0
        history = []
        for it in range(iters):
            if pos + bs > len(order):
                order, pos = r.permutation(len(items)), 0
            m = self.train_step([items[i] for i in order[pos : pos + bs]])
            m["aug"] = 0.0
            pos += bs
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
        _, missing, unexpected = restore_reference_checkpoint(
            model, path, key_map=pretrain_to_nav_key_map)
        return missing, unexpected

    def _state(self) -> dict:
        """The train state by name: each model's parameters and each
        optimizer's state (``None`` where the trainer has no such model or
        optimizer), ``iteration`` and the rollout-seed generator."""
        teacher, t_opt = self.teacher_model, self.t_opt
        return {"params": self.model.state_dict(),
                "opt_state": self.opt.state_dict(),
                "critic_params": self.critic.state_dict(),
                "t_params": None if teacher is None else teacher.state_dict(),
                "t_opt_state": None if t_opt is None else t_opt.state_dict(),
                "iteration": self.iteration,
                "seeds": self._seeds.bit_generator.state}

    def save_state(self, ckpt_dir: str, name: str = "train_state") -> str:
        """The whole resumable train state under ``name`` in ``ckpt_dir``:
        the parameters of every model, both optimizers, ``iteration`` and
        the rollout-seed generator."""
        return CheckpointManager(ckpt_dir).save(name, self._state())

    def load_state(self, ckpt_dir: str, name: str = "train_state") -> bool:
        """Restore what ``save_state`` wrote; False if it is absent.  The
        data order resumes from ``seed + iteration`` (trainer.py:672)."""
        mgr = CheckpointManager(ckpt_dir)
        if not mgr.has(name):
            return False
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
        if self.teacher_model is not None:
            self.teacher_model.load_state_dict(state["t_params"])
        if self.t_opt is not None:
            self.t_opt.load_state_dict(state["t_opt_state"])
        self.iteration = int(state["iteration"])
        self._seeds.bit_generator.state = state["seeds"]
        self._data_rng = np.random.default_rng(self.cfg.train.seed
                                               + self.iteration)
        return True

    # ----- not ported yet -----

    def use_mesh(self, mesh):
        raise _todo("training on a device mesh")

    def update_ability_grads(self, items, ema=0.5):
        raise _todo("the 'grad' ability weights (update_ability_grads)")
