"""LRA-style long-sequence classification.

Port of ``vln_magic_tpu/models/lra.py``, the counterpart of the
reference's Long Range Arena suite (reference: map_nav_src/fairseq/tasks/
long_range_arena.py:38; models/lra/*.py; SURVEY §5.7): one classifier head
over interchangeable long-context trunks,

  ``mega``  chunked EMA-gated attention, linear in length (models/mega.py)
  ``luna``  nested pack/unpack attention, O(N * proj_len) (models/luna.py)
  ``dense`` plain quadratic multi-head attention (the baseline; the
            einsum path of ``models.layers.MultiHeadAttention``, as JAX's
            ``use_pallas=False``: no kernel launches)

sharing the embedding, the masked mean-pool and the classify head.
``lra_train_step`` is the task's training step.  Parameter names are the
flax ones, so ``utils.weights`` carries JAX's weights over.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from ._init import flax_default_init, normal_
from .layers import FeedForward, MultiHeadAttention, mask_to_bias
from .luna import LunaEncoderLayer
from .mega import MegaEncoder


class _DenseTrunk(nn.Module):
    """Pre-LN dense layers: ``attn_i`` over ``norm1_i`` queries and
    ``normk_i`` keys, ``ffn_i`` after ``norm2_i``."""

    def __init__(self, hidden_size, num_layers, num_heads, dropout):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"attn_{i}", MultiHeadAttention(
                hidden_size, num_heads, dropout=dropout))
            self.add_module(f"norm1_{i}", nn.LayerNorm(hidden_size, eps=1e-6))
            self.add_module(f"normk_{i}", nn.LayerNorm(hidden_size, eps=1e-6))
            self.add_module(f"ffn_{i}",
                            FeedForward(hidden_size, hidden_size * 4))
            self.add_module(f"norm2_{i}", nn.LayerNorm(hidden_size, eps=1e-6))

    def forward(self, x, mask, deterministic=True, generator=None):
        bias = mask_to_bias(mask, x.dtype)
        for i in range(self.num_layers):
            mod = lambda name: getattr(self, f"{name}_{i}")
            a, _ = mod("attn")(mod("norm1")(x), mod("normk")(x), bias,
                               deterministic=deterministic,
                               generator=generator)
            x = x + a
            x = x + mod("ffn")(mod("norm2")(x))
        return x


class LRAClassifier(nn.Module):
    """Embed -> long-context trunk -> masked mean-pool -> classify.
    Weights in JAX's distributions from ``seed``; ``device`` defaults to
    ``"cuda"``."""

    def __init__(self, vocab_size: int, num_classes: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 num_heads: int = 4, encoder: str = "mega",
                 chunk_size: int = 64, proj_len: int = 16,
                 dropout: float = 0.0, seed: int = 0, device="cuda"):
        super().__init__()
        self.encoder, self.num_layers = encoder, num_layers
        self.embed = nn.Embedding(vocab_size, hidden_size)
        if encoder == "mega":
            self.trunk = MegaEncoder(hidden_size, num_layers,
                                     chunk_size=chunk_size, dropout=dropout,
                                     device=None)
        elif encoder == "luna":
            self.proj_tokens = nn.Parameter(torch.zeros(proj_len,
                                                        hidden_size))
            for i in range(num_layers):
                self.add_module(f"trunk_{i}", LunaEncoderLayer(
                    hidden_size, num_heads, hidden_size * 4, dropout))
        elif encoder == "dense":
            self.trunk = _DenseTrunk(hidden_size, num_layers, num_heads,
                                     dropout)
        else:
            raise ValueError(encoder)
        self.pool_proj = nn.Linear(hidden_size, hidden_size)
        self.classifier = nn.Linear(hidden_size, num_classes)
        rng = np.random.default_rng(seed)
        flax_default_init(self, rng)
        if encoder == "mega":
            self.trunk.init_weights(rng)
        elif encoder == "luna":
            normal_(self.proj_tokens, 0.02, rng)
        self.to(resolve_device(device))

    def forward(self, token_ids, mask=None, deterministic=True,
                generator=None):
        if mask is None:
            mask = torch.ones_like(token_ids, dtype=torch.bool)
        x = self.embed(token_ids)
        if self.encoder == "mega":
            x = self.trunk(x, mask, deterministic=deterministic,
                           generator=generator)
        elif self.encoder == "luna":
            p = self.proj_tokens[None].expand(x.shape[0], -1, -1)
            for i in range(self.num_layers):
                x, p = getattr(self, f"trunk_{i}")(x, p, mask, deterministic,
                                                   generator)
        else:
            x = self.trunk(x, mask, deterministic, generator)
        denom = mask.sum(-1, keepdim=True).clamp(min=1)
        pooled = (x * mask[..., None]).sum(1) / denom
        return self.classifier(torch.tanh(self.pool_proj(pooled)))


def lra_train_step(model: LRAClassifier, optimizer):
    """The LRA task's training step (JAX's, on ``model`` in place):
    ``step(tokens, mask, labels, generator=None) -> (loss, acc)``, the
    mean CE and accuracy as tensors, after one ``optimizer`` step
    (``torch.optim``) on the CE's gradient, the forward with dropout on
    and its masks from ``generator``."""

    def step(tokens, mask, labels, generator=None):
        optimizer.zero_grad(set_to_none=True)
        logits = model(tokens, mask, deterministic=False,
                       generator=generator)
        logp = F.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(-1, labels[:, None].long())[:, 0].mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        loss.backward()
        optimizer.step()
        return loss.detach(), acc

    return step
