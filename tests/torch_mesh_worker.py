"""One rank of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_cuda.py``): run as ``python
tests/torch_mesh_worker.py <case> <rank> <world> <port> <out_dir>
[<device>]`` with the repo on ``PYTHONPATH``.  It imports torch and the
port only, starts a gloo group (on the CPU, or every rank on the one card
``cuda``: NCCL refuses two ranks on one device), runs the case's checks
on one thread and writes ``<out_dir>/<case>_rank<r>.pt``.

The configuration is tests/test_multichip.py's: a MAGIC-S-like student
(hidden 64, 2 heads) and teacher (hidden 128, 2 heads) with the KD heads,
ICoD, default dropout on, batch 8 on a 12-node world."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from vln_magic_tpu_torch.agent.navigator import Navigator
from vln_magic_tpu_torch.agent.trainer import Trainer
from vln_magic_tpu_torch.config import (DistillConfig, EnvConfig,
                                        MagicConfig, ModelConfig,
                                        TrainConfig)
from vln_magic_tpu_torch.env import make_synthetic_world
from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

BATCH = 8


def model_config(h, heads, kd=False, tgt=64):
    return ModelConfig(
        vocab_size=512, hidden_size=h, num_attention_heads=heads,
        num_l_layers=2, num_pano_layers=1, num_x_layers=1,
        image_feat_size=32, max_position_embeddings=64, kd_heads=kd,
        kd_target_size=tgt)


DEVICE = "cpu"      # the ranks' device (the command line's)


def setup(optim="sgd", batch_size=BATCH, heads=2):
    """tests/test_multichip.py's configuration; ``heads`` 3 gives
    attentions whose heads do not divide by mp 2 (their Q/K/V split and
    gathered whole)."""
    cfg = MagicConfig(
        model=model_config(64 if heads == 2 else 48, heads, kd=True,
                           tgt=128 if heads == 2 else 96),
        teacher_model=model_config(128 if heads == 2 else 96, heads,
                                   kd=True, tgt=64 if heads == 2 else 48),
        env=EnvConfig(max_action_len=3, max_gmap_len=16, max_instr_len=32),
        train=TrainConfig(batch_size=batch_size, lr=1e-3,
                          train_alg="imitation", optim=optim),
        distill=DistillConfig(train_kdl=True, train_teacher=True))
    world = make_synthetic_world(num_scans=1, nodes_per_scan=12, feat_dim=32,
                                 seed=0)
    items = make_synthetic_instructions(
        world, BATCH, np.random.default_rng(0), vocab_size=512,
        min_path=2, max_path=3)
    return cfg, world, items


def full_params(model):
    from vln_magic_tpu_torch.parallel import full_state_dict

    return {k: v.clone() for k, v in full_state_dict(model).items()}


def train_steps(mesh, n_steps=2):
    """Two sgd steps: (metrics, student, teacher), whole leaves."""
    cfg, world, items = setup()
    tr = Trainer(cfg, world, device=DEVICE)
    if mesh is not None:
        tr.use_mesh(mesh)
    metrics = [tr.train_step(items) for _ in range(n_steps)]
    return tr, metrics, full_params(tr.model), full_params(tr.teacher_model)


def adamw_grads(mesh, heads=2):
    """``compute_grads`` under adamw: (objective, grads by partition)."""
    cfg, world, items = setup(optim="adamw", heads=heads)
    tr = Trainer(cfg, world, device=DEVICE)
    if mesh is not None:
        tr.use_mesh(mesh)
    loss, grads = tr.compute_grads(items, seed=11)
    return float(loss), {part: {k: v.clone() for k, v in g.items()}
                         for part, g in grads.items()}


def evaluate(mesh, state=None):
    """A greedy decode of the items: (avg metrics, trajectories)."""
    cfg, world, items = setup()
    nav = Navigator(cfg, world, seed=3, device=DEVICE)
    if mesh is not None:
        nav.use_mesh(mesh)
    if state is not None:       # after use_mesh: the state is this rank's
        nav.model.load_state_dict(state)
    (avg, _), preds = nav.evaluate(items)
    return avg, [p["trajectory"] for p in preds]


def pretrain_fit(mesh):
    """Three ``PretrainTrainer.fit`` steps over mlm and sap: (history,
    whole student leaves)."""
    from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer

    cfg, world, items = setup()
    pt = PretrainTrainer(cfg, world, image_prob_size=16, device=DEVICE,
                         builder_kwargs=dict(max_steps=3, max_gmap=12))
    if mesh is not None:
        pt.use_mesh(mesh)
    hist = pt.fit(items, 3, task_ratios={"mlm": 1, "sap": 1})
    return hist, full_params(pt.model)


def indivisible(mesh) -> list[str]:
    """The error of each ``use_mesh`` on a global batch of 7."""
    from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer

    cfg, world, _ = setup(batch_size=7)
    errors = []
    for make in (lambda: Trainer(cfg, world, device=DEVICE),
                 lambda: Navigator(cfg, world, device=DEVICE),
                 lambda: PretrainTrainer(cfg, world, image_prob_size=16,
                                         device=DEVICE, builder_kwargs=dict(
                                             max_steps=3, max_gmap=12))):
        try:
            make().use_mesh(mesh)
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    return errors


def run_case(case, rank, world, port, out_dir, device="cpu"):
    from vln_magic_tpu_torch.parallel import init_distributed, make_mesh
    from vln_magic_tpu_torch.utils.debug import check_params_in_sync

    global DEVICE
    DEVICE = device
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank if device == "cpu" else 0),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    init_distributed(device, backend="gloo")
    mesh_kw = {"device": init_device(device), "backend": "gloo"}
    out = {}
    try:
        if case == "dp2":
            mesh = make_mesh(mp=1, **mesh_kw)
            tr, out["metrics"], out["params"], out["t_params"] = \
                train_steps(mesh)
            out["in_sync"] = check_params_in_sync(tr.model)
            if rank == 1:       # one rank drifts: the check sees it
                with torch.no_grad():
                    next(tr.model.parameters()).add_(1.0)
            out["drifted_in_sync"] = check_params_in_sync(tr.model)
            out["avg"], out["traj"] = evaluate(mesh)
            out["hist"], out["pt_params"] = pretrain_fit(mesh)
        elif case == "mp2":
            mesh = make_mesh(mp=2, **mesh_kw)
            tr, out["metrics"], out["params"], out["t_params"] = \
                train_steps(mesh)
            out["shapes"] = {k: tuple(v.shape)
                             for k, v in tr.model.state_dict().items()}
            out["in_sync"] = check_params_in_sync(tr.model)
            # the student after the steps, as a reference .pt (rank 0
            # writes whole leaves) and decoded on the mesh
            tr.save(os.path.join(out_dir, "mp2_student.pt"))
            out["avg"], out["traj"] = evaluate(mesh, tr.model.state_dict())
            out["hist"], out["pt_params"] = pretrain_fit(mesh)
            out["odd_loss"], out["odd_grads"] = adamw_grads(mesh, heads=3)
            out["indivisible"] = indivisible(make_mesh(mp=1, **mesh_kw))
        elif case == "dp2mp2":
            mesh = make_mesh(mp=2, **mesh_kw)
            out["loss"], out["grads"] = adamw_grads(mesh)
        else:
            raise ValueError(case)
        torch.save(host(out), os.path.join(out_dir, f"{case}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def init_device(device):
    return torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")


def host(tree):
    """``tree``'s tensors on the CPU (results cross processes as files)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host(v) for v in tree)
    return tree


if __name__ == "__main__":
    case, rank, world, port, out_dir = sys.argv[1:6]
    run_case(case, int(rank), int(world), port, out_dir,
             *(sys.argv[6:7] or ["cpu"]))
