"""flax's default initialisers, for the modules whose weights the port
draws itself in flax's distributions (``models.mega``, ``models.luna``,
``models.lra``): Dense kernels lecun-normal (a normal truncated at 2
standard deviations, of variance 1 / fan_in), biases zeros, Embed
tables normal of variance 1 / width, LayerNorm scales ones and offsets
zeros.  Values come from a seeded numpy ``Generator``, whose streams do
not change between torch versions (the golden long-context fixture holds
values computed on weights drawn here)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

# the standard deviation of a unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def _copy(w: torch.Tensor, values: np.ndarray) -> None:
    with torch.no_grad():
        w.copy_(torch.from_numpy(values.astype(np.float32)))


def lecun_normal_(w: torch.Tensor, fan_in: int, rng: np.random.Generator):
    x = rng.standard_normal(tuple(w.shape))
    bad = np.abs(x) > 2.0
    while bad.any():                    # redraw past the truncation
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    _copy(w, x * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


def normal_(w: torch.Tensor, std: float, rng: np.random.Generator):
    _copy(w, rng.standard_normal(tuple(w.shape)) * std)


def uniform_(w: torch.Tensor, rng: np.random.Generator):
    """uniform(0, 1)."""
    _copy(w, rng.random(tuple(w.shape)))


def flax_default_init(model: nn.Module, rng: np.random.Generator) -> None:
    """flax's defaults on every Linear, Embedding and LayerNorm of
    ``model``, in module order (other parameters are left to the
    caller)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, rng)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                normal_(mod.weight, math.sqrt(1.0 / mod.embedding_dim), rng)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
