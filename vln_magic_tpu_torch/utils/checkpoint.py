"""Checkpoints: the reference ``.pt`` container, and torch-native
save/resume.

Port of ``vln_magic_tpu/utils/checkpoint.py``.  The reference persists
navigator checkpoints as ``{'vln_bert': {'epoch': int, 'state_dict':
{name: tensor}}}`` (reference: map_nav_src/r2r/agent_base.py:298-359) and
pretraining checkpoints as ``model_step_{N}.pt`` (pretrain_src/utils/
save.py:29-74).  Both packages write that container with dot-joined flax
names and flax layouts (Dense kernels ``[in, out]``), so it is the format
that crosses between them: ``save_reference_checkpoint`` here is read by
JAX's ``load_torch_checkpoint``, and JAX's ``save_torch_checkpoint`` is
read by ``load_reference_checkpoint`` here.  A load strips the reference's
``module.`` prefix (agent_base.py:336-339), applies a ``key_map`` and can
drop the KD heads, as a teacher load does (agent_base.py:326-332).

``CheckpointManager`` keeps the port's own checkpoints (``torch.save`` of
state dicts and plain Python values) under names, with the latest/best
names of the reference (main_nav.py:486-541).  A JAX orbax directory is not
readable here.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from .weights import export_flax_params, load_flax_params

KD_HEAD_NAMES = (
    # the 7 projection heads + 5 ability weights dropped when loading a
    # teacher for co-training (agent_base.py:326-332)
    "txt_emb_w", "vp_txt_w", "gmap_txt_w", "local_cross_w", "global_cross_w",
    "kdl_img_w", "kdl_avg_img_w", "kdl_txt_weight", "kdl_img_weight",
    "kdl_local_weight", "kdl_global_weight", "kdl_predict_weight",
)
# the pretraining model's task heads, which a navigator does not have
PRETRAIN_HEADS = ("mlm_head", "mrc_head", "cfp_txt_pool", "cfp_gmap_pool",
                  "cfp_vp_pool", "cfp_fused_pool", "og_obj_proj",
                  "og_loc_proj", "og_state_proj")


# ----- the reference .pt container -----

def save_reference_checkpoint(model: nn.Module, path: str, epoch: int = 0,
                              optimizer_state=None) -> None:
    """Write ``model``'s parameters in the reference navigator container:
    ``{"vln_bert": {"epoch", "state_dict": {flax name: f32 tensor in the
    flax layout}}}``, plus ``"optimizer"`` when given."""
    state_dict = {k: torch.from_numpy(v)
                  for k, v in export_flax_params(model).items()}
    states = {"vln_bert": {"epoch": int(epoch), "state_dict": state_dict}}
    if optimizer_state is not None:
        states["vln_bert"]["optimizer"] = optimizer_state
    torch.save(states, path)


def load_reference_checkpoint(
        path: str, key_map: Optional[Callable[[str], str | None]] = None,
        drop_kd_heads: bool = False) -> tuple[dict[str, np.ndarray], int]:
    """Read a reference-format checkpoint as ``(flat, epoch)``: ``flat``
    maps flax names to arrays, for ``utils.weights.load_flax_params``.

    ``key_map(name) -> new_name | None`` adapts external naming (None drops
    the entry); ``drop_kd_heads`` drops the KD heads, as a teacher load
    does."""
    states = torch.load(path, map_location="cpu", weights_only=True)
    blob = states.get("vln_bert", states)
    state_dict = blob.get("state_dict", blob)
    epoch = int(blob.get("epoch", 0))
    flat = {}
    for name, tensor in state_dict.items():
        if name.startswith("module."):      # DDP prefix (agent_base.py:336)
            name = name[len("module."):]
        if key_map is not None:
            name = key_map(name)
            if name is None:
                continue
        if drop_kd_heads and any(h in name for h in KD_HEAD_NAMES):
            continue
        flat[name] = tensor.detach().numpy()
    return flat, epoch


def restore_reference_checkpoint(model: nn.Module, path: str, key_map=None,
                                 drop_kd_heads: bool = False):
    """Load a reference-format checkpoint into ``model`` in place, with
    JAX's template semantics: a parameter absent from the file keeps its
    value, a name the model lacks is skipped, a shape mismatch raises.
    Returns ``(epoch, missing, unexpected)``."""
    flat, epoch = load_reference_checkpoint(path, key_map, drop_kd_heads)
    missing, unexpected = load_flax_params(model, flat, strict=False)
    return epoch, missing, unexpected


def pretrain_to_nav_key_map(name: str) -> str | None:
    """Adapt pretraining checkpoint names to the navigator's: the shared
    trunk lives under ``bert.`` in the pretraining model (the reference's
    checkpoint remap prefix, train_r2r_magic.py:193-206); task heads are
    dropped.  The ``key_map`` of a ``--bert_ckpt_file`` load
    (parser.py:44)."""
    if any(f".{d}." in name or name.startswith(f"params.{d}.")
           for d in PRETRAIN_HEADS):
        return None
    return name.replace("params.bert.", "params.")


# ----- the port's own checkpoints -----

class CheckpointManager:
    """Named checkpoints in one directory, each one file written with
    ``torch.save``: state dicts, optimizer states and plain Python values
    (ints, strings, dicts, lists).  ``restore`` reads with
    ``weights_only=True``."""

    def __init__(self, ckpt_dir: str):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.dir, name)

    def save(self, name: str, tree) -> str:
        """Write ``tree`` under ``name`` (replacing it whole: a crash
        mid-write leaves the previous file)."""
        path = self._path(name)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, name: str, map_location="cpu"):
        path = self._path(name)
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory: an orbax checkpoint of the JAX "
                "package, which this package cannot read (it reads the "
                "files its own CheckpointManager writes; weights cross "
                "packages as the reference .pt container)")
        return torch.load(path, map_location=map_location, weights_only=True)

    def save_latest(self, tree):
        return self.save("latest", tree)

    def save_best(self, env_name: str, tree):
        return self.save(f"best_{env_name}", tree)

    def has(self, name: str) -> bool:
        return os.path.exists(self._path(name))
