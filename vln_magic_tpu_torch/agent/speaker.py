"""Speaker driver: vocabulary, path-feature assembly, teacher-forced
training, and back-translation inference.

Port of ``vln_magic_tpu/agent/speaker.py`` (the reference's speaker stack,
map_nav_src/r2r/transpeaker.py:14-358; speaker_utils.py:106-258 for the
tokenizer and vocabulary): path features use the 128-d speaker angle
features (parser.py:117), training is teacher-forced CE over the ground
truth instructions, and ``back_translate`` decodes new instructions for
augmented paths under feature-dropout noise (drop_env, agent.py:737-752).

``Speaker(..., device=)`` defaults to ``"cuda"`` and raises without a GPU
unless ``device="cpu"`` is passed.  Weights are random from ``seed``;
``save``/``load`` read and write JAX's container,
``{'transpeaker': {'epoch', 'state_dict', 'optimizer'}}``: the state dict
under flat flax names with Dense kernels ``[in, out]``, the optimizer as
optax's ordered leaves ``[count, mu..., nu...]``, each in flax layout and
in the order of the nested names.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch
import torch.nn as nn

from ..env.geometry import ALL_VIEW_ANGLES, get_angle_fts
from ..models.speaker import TransSpeaker, beam_decode, greedy_decode
from ..native import bleu_score
from ..utils.device import resolve_device
from ..utils.weights import _flax_names, export_flax_params, load_flax_params
from .trainer import Optimizer

SPEAKER_ANGLE_SIZE = 128
GRAD_CLIP = 40.0
WEIGHT_DECAY = 1e-4         # optax.adamw's default, on every leaf


class SpeakerTokenizer:
    """Word-level vocabulary built from training instructions
    (speaker_utils.py:216-244 build/read vocab)."""

    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self, vocab: list[str]):
        self.words = ["<PAD>", "<BOS>", "<EOS>", "<UNK>"] + vocab
        self.index = {w: i for i, w in enumerate(self.words)}

    @classmethod
    def build(cls, items, min_count: int = 1, max_size: int = 988):
        c = Counter()
        for it in items:
            c.update(w.lower().strip(".,!?") for w in
                     it["instruction"].split())
        vocab = [w for w, n in c.most_common(max_size) if n >= min_count and w]
        return cls(vocab)

    @property
    def vocab_size(self):
        return len(self.words)

    def encode(self, text: str, max_len: int = 80):
        ids = [self.index.get(w.lower().strip(".,!?"), self.UNK)
               for w in text.split()][: max_len - 2]
        return [self.BOS] + ids + [self.EOS]

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.EOS:
                break
            if i > self.UNK:
                out.append(self.words[i])
        return " ".join(out)

    def shrink(self, ids):
        """Strip BOS/EOS/PAD (speaker_utils Tokenizer.shrink semantics)."""
        out = []
        for i in ids:
            i = int(i)
            if i == self.EOS:
                break
            if i not in (self.PAD, self.BOS):
                out.append(i)
        return out


def init_speaker_params(model: nn.Module, seed: int) -> None:
    """flax's default initialisers, drawn from ``seed`` on the CPU in
    sorted name order: Dense kernels lecun-normal (a normal truncated at
    two deviations, std 1/sqrt(fan_in)), embeddings N(0, 1/features), zero
    biases, unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, (param, transpose) in sorted(_flax_names(model).items()):
            if name.endswith(".scale"):
                val = torch.ones(param.shape)
            elif name.endswith(".bias"):
                val = torch.zeros(param.shape)
            elif name.endswith(".embedding"):
                val = torch.randn(param.shape, generator=gen) \
                    / param.shape[1] ** 0.5
            else:
                # a Linear weight [out, in]; truncated normal's std
                # correction as flax's variance_scaling
                std = 1.0 / param.shape[1] ** 0.5 / .87962566103423978
                val = torch.nn.init.trunc_normal_(
                    torch.empty(param.shape), std=std, a=-2 * std,
                    b=2 * std, generator=gen)
            param.copy_(val)


def _nested_order(names) -> list[str]:
    """Flat flax names in the order of ``jax.tree_util.tree_leaves`` of
    the nested dict (keys sorted at each level)."""
    return sorted(names, key=lambda k: k.split("."))


class Speaker:
    """Owns the TransSpeaker, its optimizer (``clip_by_global_norm(40)``
    then ``adamw(lr)`` with optax's defaults), its dropout and sampling
    generator, and path-feature assembly."""

    def __init__(self, world, feat_dim: int, vocab_size: int,
                 max_steps: int = 10, max_len: int = 40, lr: float = 1e-4,
                 hidden: int = 512, layers: int = 3, heads: int = 4,
                 word_size: int = 256, seed: int = 0,
                 feat_dropout: float = 0.3, device="cuda"):
        self.device = resolve_device(device)
        self.world = world
        self.t = world.tables
        self.S = max_steps
        self.L = max_len
        self.feat_dim = feat_dim
        self.feat_dropout = feat_dropout
        # ctor contract transpeaker.py:34-39: feature_size, hidden_size
        # (--hDim), word_size (--wemb), tgt_vocab_size; --aemb,
        # --proj_hidden and --subout are legacy LSTM-speaker flags that the
        # reference parses and never passes on (accepted and ignored)
        self.model = TransSpeaker(feat_dim + SPEAKER_ANGLE_SIZE, vocab_size,
                                  hidden, word_size, layers, heads)
        init_speaker_params(self.model, seed)
        self.model.to(self.device).train()
        self.opt = Optimizer(self.model.parameters(), "adamw",
                             lambda step: lr, GRAD_CLIP, WEIGHT_DECAY)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ----- checkpointing (transpeaker.py:322-344) -----

    def _names(self) -> list[str]:
        """The parameters' flax names, in ``self.opt.params`` order."""
        by_id = {id(p): k for k, (p, _) in _flax_names(self.model).items()}
        return [by_id[id(p)] for p in self.opt.params]

    def save(self, epoch: int, path: str):
        """Snapshot in the reference container,
        ``{'transpeaker': {'epoch', 'state_dict', 'optimizer'}}``
        (transpeaker.py:322-337), ``epoch + 1`` stored, as JAX's."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        state_dict = {k: torch.from_numpy(v) for k, v in
                      export_flax_params(self.model).items()}
        transposed = dict((k, t) for k, (_, t) in
                          _flax_names(self.model).items())
        moments = {}
        for buf in ("mu", "nu"):
            for name, x in zip(self._names(), getattr(self.opt, buf)):
                x = x.detach().to("cpu", torch.float32)
                moments[buf, name] = (x.t() if transposed[name] else x) \
                    .contiguous().numpy()
        order = _nested_order(state_dict)
        leaves = ([np.asarray(self.opt.count, np.int32)]
                  + [moments["mu", k] for k in order]
                  + [moments["nu", k] for k in order])
        torch.save({"transpeaker": {"epoch": epoch + 1,
                                    "state_dict": state_dict,
                                    "optimizer": leaves}}, path)

    def load(self, path: str, load_optim: bool = False) -> int:
        """Load parameters, and with ``load_optim`` the optimizer state (the
        reference's ``loadOptim``, transpeaker.py:338-352), from ``path``.
        A name or shape that does not match raises ``ValueError``.
        Returns the stored epoch."""
        blob = torch.load(path, map_location="cpu",
                          weights_only=False)["transpeaker"]
        flat = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                              else v, np.float32)
                for k, v in blob["state_dict"].items()}
        names = _flax_names(self.model)
        missing = sorted(set(names) - set(flat))
        unexpected = sorted(set(flat) - set(names))
        if missing or unexpected:
            raise ValueError(
                f"speaker checkpoint mismatch: missing={missing[:3]} "
                f"unexpected={unexpected[:3]}")
        for k, (p, t) in names.items():
            want = tuple(p.shape[::-1] if t else p.shape)
            if flat[k].shape != want:
                raise ValueError(f"shape mismatch for {k}: ckpt "
                                 f"{flat[k].shape} vs model {want}")
        load_flax_params(self.model, flat)
        if load_optim and blob.get("optimizer") is not None:
            self._load_optimizer(blob["optimizer"], names)
        return int(blob.get("epoch", 0))

    def _load_optimizer(self, leaves, names):
        order = _nested_order(names)
        n = len(order)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"speaker optimizer state: {len(leaves)} leaves "
                             f"for {n} parameters")
        by_name = {}
        for buf, chunk in (("mu", leaves[1 : 1 + n]),
                           ("nu", leaves[1 + n :])):
            for k, x in zip(order, chunk):
                p, t = names[k]
                x = torch.as_tensor(np.array(x, np.float32))
                by_name[buf, k] = (x.t() if t else x).contiguous()
                if tuple(by_name[buf, k].shape) != tuple(p.shape):
                    raise ValueError(f"speaker optimizer state {buf} {k}: "
                                     f"shape {tuple(x.shape)}")
        state = {"count": int(np.asarray(leaves[0])), "mini_step": 0}
        for buf in ("mu", "nu"):
            state[buf] = [by_name[buf, k] for k in self._names()]
        self.opt.load_state_dict(state)

    # ----- feature assembly (from_shortest_path, transpeaker.py:159) -----

    def path_features(self, items, noise=None):
        """Host arrays (cand [B, S, Dc], pano [B, S, 36, Dc], masks [B, S])
        of each item's path: the chosen view's feature and angle a step,
        and the 36 views with their angles relative to the view's
        heading.  ``noise`` [feat_dim] scales every feature."""
        t = self.t
        B = len(items)
        dc = self.feat_dim + SPEAKER_ANGLE_SIZE
        cand = np.zeros((B, self.S, dc), np.float32)
        pano = np.zeros((B, self.S, 36, dc), np.float32)
        masks = np.zeros((B, self.S), bool)
        for b, it in enumerate(items):
            si = it["scan_idx"]
            path = list(np.asarray(it["path_idx"]))[: self.S + 1]
            heading = 0.0
            for s, (cur, nxt) in enumerate(zip(path[:-1], path[1:])):
                cands = t.cand_ids[si, cur]
                j = int(np.argmax(cands == nxt))
                view = int(t.cand_view[si, cur, j])
                ch = float(t.cand_heading[si, cur, j])
                ce = float(t.cand_elevation[si, cur, j])
                feats36 = np.asarray(t.features[si, cur], np.float32)
                if noise is not None:
                    feats36 = feats36 * noise
                ang = get_angle_fts(np.array([ch - heading]), np.array([ce]),
                                    SPEAKER_ANGLE_SIZE)[0]
                cand[b, s] = np.concatenate([feats36[view], ang])
                base_h = (view % 12) * np.pi / 6
                pano_ang = get_angle_fts(ALL_VIEW_ANGLES[:, 0] - base_h,
                                         ALL_VIEW_ANGLES[:, 1],
                                         SPEAKER_ANGLE_SIZE)
                pano[b, s] = np.concatenate([feats36, pano_ang], 1)
                masks[b, s] = True
                heading = base_h
        return cand, pano, masks

    def _tensors(self, *arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def drop_env_noise(self, rng: np.random.Generator):
        """Feature-dropout mask for back-translation noise
        (drop_env, agent.py:738)."""
        keep = (rng.random(self.feat_dim) >= self.feat_dropout)
        return (keep / (1.0 - self.feat_dropout)).astype(np.float32)

    # ----- training (teacher-forced CE, transpeaker.py:207) -----

    def encode_targets(self, items, tok: SpeakerTokenizer):
        B = len(items)
        tokens = np.full((B, self.L), tok.EOS, np.int32)
        masks = np.zeros((B, self.L), bool)
        for b, it in enumerate(items):
            ids = tok.encode(it["instruction"], self.L)
            tokens[b, : len(ids)] = ids
            masks[b, : len(ids)] = True
        return tokens, masks

    def loss(self, cand, pano, masks, tokens, tok_masks):
        """Teacher-forced CE over the valid target tokens; dropout from
        ``self.generator`` while the model is in ``train()`` mode."""
        tokens = tokens.long()
        logits = self.model(cand, pano, masks, tokens[:, :-1],
                            generator=self.generator)
        valid = tok_masks[:, 1:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        return (ce * valid).sum() / valid.sum().clamp(min=1)

    def train_step(self, items, tok: SpeakerTokenizer) -> float:
        """One optimizer step on ``items``; returns the loss."""
        cand, pano, masks = self.path_features(items)
        tokens, tok_masks = self.encode_targets(items, tok)
        loss = self.loss(*self._tensors(cand, pano, masks, tokens, tok_masks))
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.opt.zero_grad()
        return loss.item()

    # ----- inference / back-translation -----

    def infer_batch(self, items, tok: SpeakerTokenizer, noise=None,
                    sample=False, generator=None, temperature: float = 1.0):
        """[B, max_len] int32 host tokens of a greedy (or, with ``sample``,
        sampled at ``temperature`` from ``generator``, else the speaker's
        own) decode."""
        cand, pano, masks = self._tensors(*self.path_features(items, noise))
        tokens = greedy_decode(
            self.model, cand, pano, masks, self.L, tok.BOS, tok.EOS,
            self.generator if generator is None else generator, sample,
            temperature)
        return tokens.to(torch.int32).cpu().numpy()

    @staticmethod
    def sample_temperature(iteration: int, total_iters: int,
                           start: float = 1.0, end: float = 0.5) -> float:
        """EnvDrop-style sampling-temperature decay for back-translation:
        hot generations early, near-greedy late; linear in training
        progress."""
        frac = min(max(iteration / max(total_iters, 1), 0.0), 1.0)
        return start + (end - start) * frac

    def evaluate(self, items, tok: SpeakerTokenizer):
        """Corpus BLEU-4 of greedy generations against the ground truth
        instructions (``native.bleu_score``)."""
        tokens = self.infer_batch(items, tok)
        hyps = [tok.shrink(row[1:]) for row in tokens]
        refs = [tok.encode(it["instruction"], self.L)[1:-1] for it in items]
        return bleu_score(hyps, refs)

    def back_translate(self, items, tok: SpeakerTokenizer, rng=None,
                       beam: int = 0, sample: bool = False,
                       temperature: float = 1.0):
        """Replace instructions with speaker generations under feature
        dropout noise (the rollout's self-train path, agent.py:737-752),
        the noise drawn from ``np.random.default_rng(rng)`` (0 if None).
        ``beam > 1`` keeps the best beam hypothesis; ``sample=True`` draws
        at ``temperature``.  Returns (new item dicts, the noise)."""
        noise = self.drop_env_noise(np.random.default_rng(
            0 if rng is None else rng))
        if beam and beam > 1:
            cand, pano, masks = self._tensors(
                *self.path_features(items, noise=noise))
            toks, _ = beam_decode(self.model, cand, pano, masks, self.L,
                                  tok.BOS, tok.EOS, beam=beam)
            tokens = toks[:, 0].cpu().numpy()
        else:
            tokens = self.infer_batch(items, tok, noise=noise, sample=sample,
                                      temperature=temperature)
        out = []
        for it, row in zip(items, tokens):
            new = dict(it)
            new["instruction"] = tok.decode(row[1:])
            out.append(new)
        return out, noise
