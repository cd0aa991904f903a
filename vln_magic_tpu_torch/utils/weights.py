"""Carry flax parameters into the torch model.

The module tree of ``models.vlnbert.DualScaleVLNBert`` dot-joins to the flax
param paths, so a flat ``{"params.<path>.<leaf>": array}`` dict maps onto it
one to one: Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in],
LayerNorm ``scale`` -> ``weight``, Embed ``embedding`` -> ``weight``,
``bias`` -> ``bias``, and a parameter that a module holds directly (the
learned ability weights ``kdl_*_weight``) -> the parameter of that name.
``models.vlnbert.Critic`` names its layers ``Dense_0``/``Dense_1``, as flax
does.  ``utils.checkpoint`` reads and writes the same names in the reference
``.pt`` container.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..models.vlnbert import KD_WEIGHT_INIT


def _flax_names(model: nn.Module) -> dict[str, tuple[torch.Tensor, bool]]:
    """flax flat name -> (torch parameter, whether the array is transposed)."""
    names = {}
    for mod_name, mod in model.named_modules():
        prefix = f"params.{mod_name}" if mod_name else "params"
        if isinstance(mod, nn.Linear):
            names[f"{prefix}.kernel"] = (mod.weight, True)
            if mod.bias is not None:
                names[f"{prefix}.bias"] = (mod.bias, False)
        elif isinstance(mod, nn.LayerNorm):
            names[f"{prefix}.scale"] = (mod.weight, False)
            names[f"{prefix}.bias"] = (mod.bias, False)
        elif isinstance(mod, nn.Embedding):
            names[f"{prefix}.embedding"] = (mod.weight, False)
        else:
            for p_name, param in mod.named_parameters(recurse=False):
                names[f"{prefix}.{p_name}"] = (param, False)
    return names


def load_flax_params(model: nn.Module, flat: dict, strict: bool = True):
    """Copy ``flat`` (flax flat names -> arrays) into ``model`` in place.

    ``strict`` (the default) raises ``KeyError`` on a missing or unmatched
    name, so a partial load never passes silently.  ``strict=False`` is
    JAX's template load (``unflatten_params`` with a template): a parameter
    absent from ``flat`` keeps its value, a name the model lacks is not
    loaded, and both are returned as ``(missing, unexpected)``, sorted.  A
    shape mismatch raises ``ValueError`` either way."""
    names = _flax_names(model)
    missing = sorted(set(names) - set(flat))
    unmatched = sorted(set(flat) - set(names))
    if strict and (missing or unmatched):
        raise KeyError(f"flax params do not match the model: missing "
                       f"{missing[:5]} ({len(missing)}), unmatched "
                       f"{unmatched[:5]} ({len(unmatched)})")
    with torch.no_grad():
        for name, (param, transpose) in names.items():
            if name not in flat:
                continue
            arr = np.array(flat[name], dtype=np.float32)    # a writable copy
            if transpose:
                arr = arr.T
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr.copy(order="C")))
    return missing, unmatched


def export_flax_params(model: nn.Module) -> dict[str, np.ndarray]:
    """``model``'s parameters as flat flax names in the flax layouts (Dense
    kernels [in, out]), f32 numpy: the inverse of ``load_flax_params``,
    which loads them back bit for bit (a bf16 model's values are exact in
    f32).  The arrays are copies, which later updates leave as they are.
    Serving bundles and int8 quantization (``utils.quantize``) work on this
    layout, as JAX's do."""
    out = {}
    for name, (param, transpose) in _flax_names(model).items():
        # a copy: an f32 CPU parameter's numpy view would follow its
        # updates
        x = param.detach().to("cpu", torch.float32, copy=True)
        out[name] = (x.t() if transpose else x).contiguous().numpy()
    return out


def flax_named_grads(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s gradients under their flax names, in the flax layout
    (Linear gradients transposed to [in, out]); zeros where there is no
    gradient, as JAX gives for a parameter off the loss's path."""
    out = {}
    for name, (param, transpose) in _flax_names(model).items():
        g = param.grad if param.grad is not None else torch.zeros_like(param)
        out[name] = g.detach().t() if transpose else g.detach()
    return out


def load_trainer_params(trainer, params: dict, t_params: dict | None = None,
                        critic_params: dict | None = None) -> None:
    """Load a JAX ``Trainer``'s three parameter trees, each a flat dict
    (``utils.checkpoint.flatten_params`` of ``params``, ``t_params`` and
    ``critic_params``), into ``agent.trainer.Trainer`` ``trainer``: the
    student, the teacher and the critic.  Each load raises on a missing or
    unmatched name, and a tree given for a model the trainer lacks (or
    missing for one it has) raises ``ValueError``."""
    for what, model, flat in (("params", trainer.model, params),
                              ("t_params", trainer.teacher_model, t_params),
                              ("critic_params", trainer.critic,
                               critic_params)):
        if (model is None) != (flat is None):
            raise ValueError(f"{what}: the trainer has "
                             f"{'no' if model is None else 'a'} model for it")
        if model is not None:
            load_flax_params(model, flat)


def init_params(model: nn.Module, seed: int, std: float = 0.02) -> None:
    """Random BERT-style weights from ``seed`` (a ``torch.Generator`` on the
    CPU, so the values do not depend on the device): normal(0, ``std``)
    matrices and embeddings, zero biases, unit LayerNorm scales, and the
    learned ability weights at their initial 0.5413."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, (param, transpose) in sorted(_flax_names(model).items()):
            if param.dim() == 0:        # a learned ability weight
                val = torch.tensor(KD_WEIGHT_INIT)
            elif name.endswith(".scale"):
                val = torch.ones(param.shape)
            elif name.endswith(".bias"):
                val = torch.zeros(param.shape)
            else:
                val = torch.randn(param.shape, generator=gen) * std
            param.copy_(val)
