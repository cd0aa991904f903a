"""Matrix-product FLOPs of the navigator's forward, from a configuration's
widths and the shapes the program runs at (2 FLOPs per multiply-add;
elementwise work, softmax and LayerNorm are not counted).

Per token of a stream of N tokens, at width d, a self-attention layer
costs 8 d^2 (Q, K, V, O) + 16 d^2 (the FFN at 4 d) and the attention
4 N d per query (scores and values).  A cross-modal layer of a visual
stream of N tokens over L instruction tokens: the cross attention (Q, O
over N: 4 N d^2; K, V over L: 4 L d^2, except in layer 0, whose K/V the
program projects once per episode; 4 N L d), the language-to-vision
attention (Q, O over L: 4 L d^2; K, V over N: 4 N d^2; 4 L N d), the
self-attention (8 N d^2 + 4 N^2 d) and the FFN (16 N d^2).
"""

from __future__ import annotations


def _self_layers(n_layers, n, d):
    return n_layers * (24 * n * d * d + 4 * n * n * d)


def _cross_layers(n_layers, n, lang, d):
    per = (4 * n * d * d + 4 * n * lang * d
           + 4 * lang * d * d + 4 * n * d * d + 4 * lang * n * d
           + 8 * n * d * d + 4 * n * n * d + 16 * n * d * d)
    return n_layers * per + (n_layers - 1) * 4 * lang * d * d


def instruction(m: dict, lang: int) -> float:
    """One instruction's encoding and its hoisted layer-0 K/V (both
    branches)."""
    d = m["hidden_size"]
    return _self_layers(m["num_l_layers"], lang, d) + 2 * 4 * lang * d * d


def step(m: dict, lang: int, gmap: int, pano: int) -> float:
    """One episode-step: the panorama (``pano`` tokens), the global branch
    over ``gmap`` tokens and the local one over ``pano`` + 2, the heads and
    the fusion."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    vp = pano + 2
    pano_f = (2 * pano * (m["image_feat_size"] + m["angle_feat_size"] + 3)
              * d + _self_layers(m["num_pano_layers"], pano, d)
              + 2 * pano * d)
    nav = (2 * gmap * 7 * d + 2 * vp * 14 * d + 2 * gmap * gmap * h
           + _cross_layers(m["num_x_layers"], gmap, lang, d)
           + _cross_layers(m["num_x_layers"], vp, lang, d)
           + (2 * d * d + 2 * d) * (gmap + vp)
           + 2 * (2 * d) ** 2 + 2 * 2 * d + 2 * 2 * d * d)
    return pano_f + nav


def counts(ref) -> tuple:
    """(instruction, step): the FLOP counts of a configuration's reference
    module (``instruction_flops``, ``step_flops``) where it gives them, else
    this file's."""
    return (getattr(ref, "instruction_flops", instruction),
            getattr(ref, "step_flops", step))
