"""Pretraining loop: task-sampled MLM/MRC/SAP/CFP (and OG) steps with
in-step teacher -> student distillation.

Port of ``vln_magic_tpu/pretrain/trainer.py`` (the loop the reference
release omitted, pretrain_src/train_r2r_magic.py:398-410, and its
validators, :440-587): sample a task, run the student's forward with
dropout, the task loss, the teacher's deterministic forward and the KD
penalty, ``(1 - alpha) * task + alpha * kd``, then one clipped optimizer
step (``agent.trainer.Optimizer``, with ``accum_steps`` as optax's
``MultiSteps``).

Everything runs in f32, with no autocast (TF32 is off on the card,
``utils.device``), as JAX's pretraining does.  The teacher runs under
``torch.no_grad()`` (JAX's ``stop_gradient``) and deterministic, so a
teacher built with ``use_pallas_attention`` takes the packed kernel in
every step; so does the student in ``validate``.  The student's training
forward never does: dropout is on, and the kernel has no backward.

On a mesh (``use_mesh``) every rank builds the global batch, runs the
models on its dp rows (dropout drawn at the global batch), gathers the
head outputs over dp and takes the task losses, which span the batch (the
masked-token means, CFP's InfoNCE), on the global batch; the gradients are
summed over dp.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..agent.losses import kd_loss, mse_loss
from ..agent.trainer import make_optimizer
from ..parallel.sharding import (gather_from_dp, reduce_gradients,
                                 shard_params, shard_pytree_batch)
from ..config import MagicConfig
from ..env.synthetic import make_synthetic_instructions
from ..utils.device import resolve_device
from ..utils.weights import init_params
from .loader import ItemSampler, MetaLoader, PrefetchLoader, batch_to_device
from .model import (GlocalTextPathCMTPretrain, cfp_loss, mlm_loss, mrc_loss,
                    sap_loss)
from .tasks import PathDataBuilder

# the student's projection head of each CFP embedding onto the teacher's
# width (the checkpoint-contract heads, agent_base.py:330)
CFP_KD_HEADS = {"txt": "txt_emb_w", "vp": "vp_txt_w", "gmap": "gmap_txt_w"}


def _accuracy(logits, labels, valid=None):
    """Share of argmax hits among the ``valid`` positions (at least 1)."""
    hit = logits.argmax(-1) == labels.clamp(min=0)
    if valid is None:
        valid = labels != -100
    return (hit & valid).sum() / valid.sum().clamp(min=1)


class PretrainTrainer:
    """The student (``cfg.model``) and, under ``train_kdl`` with a
    ``teacher_model``, the teacher; the data builder; the optimizer.
    Weights are random from ``cfg.train.seed`` (the teacher's from
    ``seed + 1``); ``utils.weights.load_flax_params`` loads a JAX
    trainer's.  ``device`` defaults to ``"cuda"`` and raises without a GPU
    unless it is ``"cpu"``."""

    def __init__(self, cfg: MagicConfig, world, image_prob_size: int = 1000,
                 builder_kwargs=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.world = world
        seed = cfg.train.seed
        self.kdl = cfg.distill.train_kdl and cfg.teacher_model is not None
        bk = dict(angle_feat_size=cfg.model.angle_feat_size,
                  image_prob_size=image_prob_size,
                  vocab_size=cfg.model.vocab_size,
                  max_txt=cfg.env.max_instr_len)
        bk.update(builder_kwargs or {})
        self.builder = PathDataBuilder(world, **bk)
        # JAX builds this batch to trace its init; building it here too
        # leaves the builder's generator where JAX's is, so both trainers
        # draw the same batches from then on
        self._dummy_batch()
        obj_dim = (self.builder.obj_db.dim if self.builder.obj_db is not None
                   else world.tables.feat_dim)
        self.model = GlocalTextPathCMTPretrain(cfg.model, image_prob_size,
                                               obj_dim, self.device)
        init_params(self.model, seed)
        self.teacher = None
        if self.kdl:
            self.teacher = GlocalTextPathCMTPretrain(
                cfg.teacher_model, image_prob_size, obj_dim, self.device)
            init_params(self.teacher, seed + 1)
            self.teacher.requires_grad_(False)
        self.opt = make_optimizer(cfg, self.model.parameters())
        self.accum_steps = self.opt.accum_steps
        self.iteration = 0
        self._seeds = np.random.default_rng(seed)   # a dropout seed a step
        self._sampler = None
        self._loader = None
        self.mesh = None                            # use_mesh

    def _dummy_batch(self):
        items = make_synthetic_instructions(
            self.world, 2, np.random.default_rng(0),
            vocab_size=self.cfg.model.vocab_size, min_path=2, max_path=3)
        self.builder.mrc_batch(items)
        self.builder.og_batch(items)

    # ----- per-task losses -----

    def _head(self, task, batch, model, generator):
        """The head output of ``task`` (a tensor or a dict of tensors),
        for cfp under distillation with the student's KD projections
        (``kd_<key>``).  On a mesh the models see this rank's dp rows and
        the outputs are gathered over dp: the parameters act on local rows
        only, and everything after is a function of the global batch."""
        kw = {"deterministic": generator is None, "generator": generator}
        mesh = self.mesh
        if mesh is not None:
            batch = shard_pytree_batch(batch, mesh)
        with (mesh.active() if mesh is not None else nullcontext()):
            out = getattr(model, task)(batch, **kw)
            if task == "cfp" and model is self.model and self.kdl \
                    and self.cfg.model.kd_heads:
                out.update({f"kd_{k}": model.bert_kd_project(head, out[k])
                            for k, head in CFP_KD_HEADS.items()})
        if mesh is None:
            return out
        if isinstance(out, dict):
            return {k: gather_from_dp(v, mesh) for k, v in out.items()}
        return gather_from_dp(out, mesh)

    def _task_loss(self, task, batch, model=None, generator=None):
        """(task loss, the head output, accuracies) of ``task`` on
        ``batch``; deterministic when ``generator`` is None, else dropout
        with masks from it."""
        model = model or self.model
        if task not in ("mlm", "mrc", "sap", "og", "cfp"):
            raise ValueError(task)
        out = self._head(task, batch, model, generator)
        if task == "mlm":
            logits = out
            loss, valid = mlm_loss(logits, batch["mlm_labels"])
            return loss, logits, {
                "mlm_acc": _accuracy(logits, batch["mlm_labels"], valid)}
        if task == "mrc":
            logits = out
            m = batch["mrc_view_mask"]
            loss = mrc_loss(logits, batch["mrc_targets"], m)
            hit = logits.argmax(-1) == batch["mrc_targets"].argmax(-1)
            return loss, logits, {
                "mrc_acc": (hit * m).sum() / m.sum().clamp(min=1)}
        if task == "sap":
            outs = out
            g_lbl, l_lbl = batch["sap_global_label"], batch["sap_local_label"]
            loss = (sap_loss(outs["global_logits"], g_lbl)
                    + sap_loss(outs["local_logits"], l_lbl)
                    + sap_loss(outs["fused_logits"], g_lbl))
            return loss, outs["fused_logits"], {
                "sap_gacc": _accuracy(outs["global_logits"], g_lbl),
                "sap_lacc": _accuracy(outs["local_logits"], l_lbl),
                "sap_facc": _accuracy(outs["fused_logits"], g_lbl)}
        if task == "og":
            logits = out
            return sap_loss(logits, batch["og_labels"]), logits, {
                "og_acc": _accuracy(logits, batch["og_labels"])}
        embeds = out
        loss = cfp_loss(embeds, self.cfg.model.cfp_temperature)
        sim = embeds["txt"] @ embeds["fused"].t()
        hit = sim.argmax(-1) == torch.arange(sim.shape[0], device=sim.device)
        return loss, embeds, {"cfp_acc": hit.float().mean()}

    def _kd_penalty(self, task, s_out, t_out):
        """In-step KD (the pretrain kdl block): ``kd_loss`` of the head
        outputs for mlm/mrc/sap/og; for cfp the student's embeddings
        projected to the teacher's width by its KD heads, under
        ``mse_loss`` (0 without KD heads).  ``t_out`` is the teacher's,
        computed without grad; the student's cfp projections come with its
        output (``_head``)."""
        if task == "cfp":
            if not self.cfg.model.kd_heads:
                return torch.zeros((), device=self.device)
            return sum(mse_loss(s_out[f"kd_{k}"], t_out[k], loss_type="mean")
                       for k in CFP_KD_HEADS)
        return kd_loss(s_out, t_out, temperature=self.cfg.distill.temperature,
                       loss_type="mean")

    def _objective(self, task, batch, generator):
        """(the step's objective, its metrics as tensors)."""
        loss, s_out, metrics = self._task_loss(task, batch,
                                               generator=generator)
        if self.kdl:
            with torch.no_grad():
                _, t_out, _ = self._task_loss(task, batch, model=self.teacher)
            kd = self._kd_penalty(task, s_out, t_out)
            metrics["kd"] = kd
            alpha = self.cfg.distill.alpha
            loss = (1 - alpha) * loss + alpha * kd
        metrics["loss"] = loss
        return loss, metrics

    def _on_device(self, batch):
        if all(isinstance(v, torch.Tensor) for v in batch.values()):
            return {k: v.to(self.device) for k, v in batch.items()}
        return batch_to_device(batch, self.device)

    def train_step(self, task, batch) -> dict:
        """One optimizer step (a mini-step under ``accum_steps``) of
        ``task`` on ``batch`` (numpy arrays or tensors); returns the
        metrics as floats from one device-to-host copy: the task's
        accuracies, ``kd`` under distillation, and ``loss``."""
        batch = self._on_device(batch)
        gen = torch.Generator(device=self.device).manual_seed(
            int(self._seeds.integers(2 ** 62)))
        self.opt.zero_grad()
        loss, metrics = self._objective(task, batch, gen)
        loss.backward()
        if self.mesh is not None:
            reduce_gradients(self.model.parameters(), self.mesh)
        self.opt.step()
        self.opt.zero_grad()
        self.iteration += 1
        names = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in names])
        return dict(zip(names, vals.tolist()))

    def fit(self, items, iters, task_ratios=None, batch_size=None,
            callback=None, prefetch: int = 2):
        """``iters`` steps on tasks drawn by a ``MetaLoader`` over batches
        of ``items``, each batch built and copied to the device one step
        ahead (``PrefetchLoader``).  The sampler and loader persist across
        calls.  The default task set is mlm/mrc/sap/cfp (and og when the
        builder has an object store); explicit ``task_ratios`` name the
        exact set.  Returns one metrics dict a step, with its ``task``."""
        bs = batch_size or self.cfg.train.batch_size
        if self._sampler is None:
            self._sampler = ItemSampler(items, bs, self.cfg.train.seed)
            sampler = self._sampler

            def task_batches(task):
                make = getattr(self.builder, f"{task}_batch")
                return lambda: self._fill(task, make(sampler.next_batch()))

            names = ["mlm", "mrc", "sap", "cfp"]
            if self.builder.obj_db is not None:
                names.append("og")      # REVERIE adds object grounding
            if task_ratios is None:
                ratios = {n: 1 for n in names}
            else:
                ratios = {n: r for n, r in task_ratios.items() if r > 0}
                unknown = set(ratios) - set(names)
                if unknown:
                    raise ValueError(f"unknown pretrain tasks: {unknown}")
            self._loader = MetaLoader({n: task_batches(n) for n in ratios},
                                      ratios=ratios, seed=self.cfg.train.seed,
                                      accum_steps=self.accum_steps)
        self._sampler.items = items
        stream = PrefetchLoader(self._loader, self.device, depth=prefetch)
        history = []
        for i, (task, batch) in zip(range(iters), stream):
            m = self.train_step(task, batch)
            m["task"] = task
            history.append(m)
            if callback:
                callback(i, task, m)
        return history

    def _fill(self, task, batch):
        """Every task's batch carries ``mlm_labels`` (all ignored outside
        mlm), as JAX's do."""
        if task != "mlm" and "mlm_labels" not in batch:
            batch["mlm_labels"] = np.full_like(batch["txt_ids"], -100)
        return batch

    # ----- validation (train_r2r_magic.py:440-587) -----

    @torch.no_grad()
    def validate(self, items, batch_size=None, num_batches=4):
        """The student's deterministic accuracies on ``num_batches``
        batches of each task (mlm, mrc, sap, cfp; og with an object store),
        averaged over the batches."""
        bs = batch_size or self.cfg.train.batch_size
        sampler = ItemSampler(items, bs, 1234)
        tasks = ("mlm", "mrc", "sap", "cfp") + (
            ("og",) if self.builder.obj_db is not None else ())
        out = {}
        for task in tasks:
            rows = []
            for _ in range(num_batches):
                batch = getattr(self.builder, f"{task}_batch")(
                    sampler.next_batch())
                batch = self._on_device(self._fill(task, batch))
                _, _, metrics = self._task_loss(task, batch)
                names = sorted(metrics)
                rows.append(torch.stack([metrics[k].float() for k in names]))
            means = np.mean(np.asarray(torch.stack(rows).tolist()), axis=0)
            out.update(zip(names, map(float, means)))
        return out

    def use_mesh(self, mesh):
        """Pretrain over a dp x mp mesh (JAX ``use_mesh``, the DDP
        equivalent, SURVEY §2.4): the student, the teacher and the
        optimizer state sharded in place (``parallel.shard_params``; call
        it after any restore), every batch split over dp (``_head``).
        ``train_step``, ``fit`` and ``validate`` then equal one process's
        on the same global batches.  The global batch size must divide by
        dp."""
        dp = mesh.shape.get("dp", 1)
        if self.cfg.train.batch_size % dp != 0:
            raise ValueError(
                f"global batch_size {self.cfg.train.batch_size} not "
                f"divisible by dp={dp}")
        self.mesh = mesh
        shard_params(self.model, mesh)
        shard_params(self.teacher, mesh)
        shard_params(self.opt, mesh)
        return self
