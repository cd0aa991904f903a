"""TransSpeaker — transformer encoder-decoder speaker for back-translation.

Port of ``vln_magic_tpu/models/speaker.py`` (the reconstruction of the
reference's ``Transpeaker``, map_nav_src/r2r/transpeaker.py:34-39:
feature_size 768+128, hidden 512, word emb 256, target vocab ~992, 3
layers / 4 heads, parser.py:117-119), on the port's transformer blocks.

Encoder: per-step [chosen-candidate ; panorama] features -> hidden, the 36
views pooled by a max after ``pano_proj``.  Decoder: causal self-attention
and cross-attention over the encoder states.  Every attention is
``MultiHeadAttention`` on its einsum path (JAX builds them with
``use_pallas=False``), so the speaker launches no attention kernel.

Submodule names dot-join to JAX's flat flax names (``params.encoder.
attn_0.query.kernel``, ``params.decoder.word_emb.embedding``), so
``utils.weights.load_flax_params`` and ``export_flax_params`` carry the
weights in both directions.

Decoding keeps JAX's fixed length: at each position the decoder runs over
all ``[B, max_len]`` tokens (finished rows emit EOS) and the logits of that
position are read.  ``greedy_decode`` and ``beam_decode`` are functions of
the model and tensors; sampling draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import (NEG_INF, AddNorm, FeedForward, MultiHeadAttention,
                     dropout, mask_to_bias)


class SpeakerEncoder(nn.Module):
    def __init__(self, feat_size: int, hidden_size: int = 512,
                 num_layers: int = 3, num_heads: int = 4,
                 dropout: float = 0.2):
        super().__init__()
        h = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.pano_proj = nn.Linear(feat_size, h)
        self.cand_proj = nn.Linear(feat_size, h)
        self.in_norm = nn.LayerNorm(h, eps=1e-6)     # flax's default epsilon
        self.pos = nn.Embedding(128, h)
        for i in range(num_layers):
            setattr(self, f"attn_{i}", MultiHeadAttention(
                h, num_heads, dropout=dropout))
            setattr(self, f"attn_norm_{i}", AddNorm(h, dropout=dropout))
            setattr(self, f"ffn_{i}", FeedForward(h, h * 4))
            setattr(self, f"ffn_norm_{i}", AddNorm(h, dropout=dropout))

    def forward(self, cand_feats, pano_feats, step_masks, deterministic=True,
                generator=None):
        """cand_feats: [B, T, Dc] chosen-candidate feature per path step;
        pano_feats: [B, T, V, Dp] panorama views per step; step_masks
        [B, T] bool."""
        drop = {"deterministic": deterministic, "generator": generator}
        pano_ctx = self.pano_proj(pano_feats).amax(dim=2)   # view pooling
        x = self.in_norm(self.cand_proj(cand_feats) + pano_ctx)
        x = dropout(x, self.dropout, **drop)
        x = x + self.pos(torch.arange(x.shape[1], device=x.device))[None]
        bias = mask_to_bias(step_masks, x.dtype)
        for i in range(self.num_layers):
            a, _ = getattr(self, f"attn_{i}")(x, x, bias, **drop)
            x = getattr(self, f"attn_norm_{i}")(x, a, **drop)
            f = getattr(self, f"ffn_{i}")(x)
            x = getattr(self, f"ffn_norm_{i}")(x, f, **drop)
        return x


class SpeakerDecoder(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 512,
                 word_size: int = 256, num_layers: int = 3,
                 num_heads: int = 4, dropout: float = 0.2):
        super().__init__()
        h = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.word_emb = nn.Embedding(vocab_size, word_size)
        self.word_proj = nn.Linear(word_size, h)
        self.pos = nn.Embedding(256, h)
        for i in range(num_layers):
            for kind in ("self", "cross"):
                setattr(self, f"{kind}_{i}", MultiHeadAttention(
                    h, num_heads, dropout=dropout))
                setattr(self, f"{kind}_norm_{i}", AddNorm(h, dropout=dropout))
            setattr(self, f"ffn_{i}", FeedForward(h, h * 4))
            setattr(self, f"ffn_norm_{i}", AddNorm(h, dropout=dropout))
        self.projection = nn.Linear(h, vocab_size)

    def forward(self, tokens, enc_out, enc_masks, deterministic=True,
                generator=None, position=None):
        """Logits [B, L, V] of ``tokens`` [B, L]; with ``position``, only
        those of that position, [B, V] (the causal mask makes them the same
        numbers)."""
        drop = {"deterministic": deterministic, "generator": generator}
        L = tokens.shape[1]
        dev = tokens.device
        x = self.word_proj(self.word_emb(tokens))
        x = x + self.pos(torch.arange(L, device=dev))[None]
        x = dropout(x, self.dropout, **drop)
        causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
        causal_bias = torch.zeros(L, L, dtype=x.dtype, device=dev) \
            .masked_fill(~causal, NEG_INF)[None, None]
        enc_bias = mask_to_bias(enc_masks, x.dtype)
        for i in range(self.num_layers):
            a, _ = getattr(self, f"self_{i}")(x, x, causal_bias, **drop)
            x = getattr(self, f"self_norm_{i}")(x, a, **drop)
            c, _ = getattr(self, f"cross_{i}")(x, enc_out, enc_bias, **drop)
            x = getattr(self, f"cross_norm_{i}")(x, c, **drop)
            f = getattr(self, f"ffn_{i}")(x)
            x = getattr(self, f"ffn_norm_{i}")(x, f, **drop)
        if position is not None:
            x = x[:, position]
        return self.projection(x)


class TransSpeaker(nn.Module):
    """model(cand_feats, pano_feats, step_masks, tokens) -> logits (the
    reference call shape, transpeaker.py:232).  ``feat_size`` is the
    feature width plus the 128 angle features.  ``deterministic=None``
    (the default) applies dropout in ``train()`` mode only."""

    def __init__(self, feat_size: int, vocab_size: int = 992,
                 hidden_size: int = 512, word_size: int = 256,
                 num_layers: int = 3, num_heads: int = 4,
                 dropout: float = 0.2):
        super().__init__()
        self.encoder = SpeakerEncoder(feat_size, hidden_size, num_layers,
                                      num_heads, dropout)
        self.decoder = SpeakerDecoder(vocab_size, hidden_size, word_size,
                                      num_layers, num_heads, dropout)

    def _det(self, deterministic):
        return (not self.training) if deterministic is None else deterministic

    def forward(self, cand_feats, pano_feats, step_masks, tokens,
                deterministic=None, generator=None):
        det = self._det(deterministic)
        enc = self.encoder(cand_feats, pano_feats, step_masks, det, generator)
        return self.decoder(tokens, enc, step_masks, det, generator)

    def encode(self, cand_feats, pano_feats, step_masks, deterministic=True,
               generator=None):
        return self.encoder(cand_feats, pano_feats, step_masks,
                            self._det(deterministic), generator)

    def decode_step(self, tokens, enc_out, enc_masks, position=None):
        return self.decoder(tokens, enc_out, enc_masks, True,
                            position=position)


def _gumbel(shape, generator, device):
    """Standard Gumbel noise, as ``jax.random.categorical`` draws it
    (uniform on [tiny, 1))."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device) \
        .clamp_(min=tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def greedy_decode(model: TransSpeaker, cand_feats, pano_feats, step_masks,
                  max_len: int, bos: int, eos: int, generator=None,
                  sample: bool = False, temperature: float = 1.0):
    """Fixed-length greedy or sampled decoding (infer_batch,
    transpeaker.py:252): [B, max_len] tokens, BOS first, EOS after a row
    ends.  ``sample`` draws each token by the Gumbel-max trick from
    ``generator`` (on the tensors' device) at ``temperature``, clamped at
    1e-6, as ``jax.random.categorical`` does."""
    b = cand_feats.shape[0]
    dev = cand_feats.device
    enc = model.encode(cand_feats, pano_feats, step_masks, True)
    tokens = torch.full((b, max_len), eos, dtype=torch.long, device=dev)
    tokens[:, 0] = bos
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_len - 1):
        logit = model.decode_step(tokens, enc, step_masks, position=i).float()
        if sample:
            scaled = logit / max(float(temperature), 1e-6)
            nxt = (scaled + _gumbel(scaled.shape, generator, dev)).argmax(-1)
        else:
            nxt = logit.argmax(-1)
        nxt = torch.where(done, eos, nxt)
        done = done | (nxt == eos)
        tokens[:, i + 1] = nxt
    return tokens


@torch.no_grad()
def beam_decode(model: TransSpeaker, cand_feats, pano_feats, step_masks,
                max_len: int, bos: int, eos: int, beam: int = 4,
                length_penalty: float = 1.0):
    """Batched beam search (the fairseq sequence_generator's role,
    reference: map_nav_src/fairseq/sequence_generator.py, reduced to the
    speaker), fixed length: beams fold into the batch axis; finished beams
    hold their score and emit EOS.  The top ``beam`` candidates are taken
    by a stable descending sort, so equal scores (``-1e9`` plus small
    log-probabilities round alike in f32) keep the lower index first, as
    ``jax.lax.top_k`` does.

    Returns (tokens [B, beam, L] sorted best-first, scores [B, beam])."""
    b = cand_feats.shape[0]
    dev = cand_feats.device
    enc = model.encode(cand_feats, pano_feats, step_masks, True)
    le, de = enc.shape[1], enc.shape[2]
    enc_b = enc[:, None].expand(b, beam, le, de).reshape(b * beam, le, de)
    masks_b = step_masks[:, None].expand(b, beam, le).reshape(b * beam, le)

    tokens = torch.full((b, beam, max_len), eos, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = bos
    # only beam 0 is live at first, so that identical beams don't multiply
    scores = torch.full((b, beam), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    eos_only = None
    for i in range(max_len - 1):
        logits = model.decode_step(tokens.reshape(b * beam, max_len), enc_b,
                                   masks_b, position=i).float()
        logp = torch.log_softmax(logits, dim=-1).reshape(b, beam, -1)
        v = logp.shape[-1]
        if eos_only is None:
            # finished beams extend only with EOS, at no cost
            eos_only = torch.full((v,), NEG_INF, device=dev)
            eos_only[eos] = 0.0
        logp = torch.where(done[..., None], eos_only, logp)
        flat = (scores[..., None] + logp).reshape(b, beam * v)
        top_s, top_i = torch.sort(flat, dim=1, descending=True, stable=True)
        top_s, top_i = top_s[:, :beam], top_i[:, :beam]
        src = top_i // v
        tok = top_i % v
        tokens = torch.gather(tokens, 1,
                              src[..., None].expand(b, beam, max_len))
        done = torch.gather(done, 1, src)
        tokens[:, :, i + 1] = torch.where(done, eos, tok)
        done = done | (tok == eos)
        scores = top_s
    if length_penalty != 1.0:
        lengths = (tokens != eos).sum(-1).float()
        scores = scores / lengths ** length_penalty
    order = torch.argsort(-scores, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[..., None].expand(b, beam,
                                                             max_len))
    return tokens, torch.gather(scores, 1, order)
