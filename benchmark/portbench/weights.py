"""Random weights for a configuration, drawn on the device from the seed.

One normal draw on a ``torch.Generator`` on the device for every weight
at once, shaped per leaf in a few large operations: matrices and
embeddings N(0, 0.02) (BERT's initializer range), biases and LayerNorm
offsets N(0, 0.02), LayerNorm scales 1 + N(0, 0.1) (so a mistake in
either shows), the learned ability weights 0.5413 + N(0, 0.02).  The
values are rounded to the type the model is served in; the program and the
reference receive the same rounded values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw(shapes: dict[str, tuple], dtype: str, seed: int,
         device) -> dict[str, torch.Tensor]:
    """flax name -> weight on ``device`` in f32, holding values exact in
    ``dtype``, drawn from ``seed``: the weights ``shapes`` names (the
    configuration's reference module's ``param_shapes``), in order of
    name."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.empty(len(names), device="cpu")
    shift = torch.empty(len(names), device="cpu")
    for i, n in enumerate(names):
        if n.endswith(".scale"):
            scale[i], shift[i] = 0.1, 1.0
        elif not shapes[n]:
            scale[i], shift[i] = 0.02, 0.5413
        else:
            scale[i], shift[i] = 0.02, 0.0
    counts = torch.tensor(sizes, device=device)
    flat = (flat * scale.to(device).repeat_interleave(counts)
            + shift.to(device).repeat_interleave(counts))
    flat = flat.to(DTYPES[dtype]).float()
    return {n: x.reshape(shapes[n])
            for n, x in zip(names, torch.split(flat, sizes))}


def to_host(weights: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The weights as numpy arrays (one copy off the device), the form the
    program's loader (``load_flax_params``) reads."""
    names = list(weights)
    flat = torch.cat([weights[n].reshape(-1) for n in names]).cpu().numpy()
    out, at = {}, 0
    for n in names:
        size = weights[n].numel()
        out[n] = flat[at:at + size].reshape(weights[n].shape)
        at += size
    return out
