"""RoBERTa / METER checkpoint import into the language and cross-modal
encoders.

Port of ``vln_magic_tpu/utils/hf_import.py``.  The reference initialises
its language stack from a local RoBERTa/METER checkpoint with key
remapping and the ``jump_init_txt`` even-layer skip for shallower students
(reference: pretrain_src/train_r2r_magic.py:183-254).  The maps take
HuggingFace ``roberta``-style and METER state dicts already in memory
(tensors or arrays) to flax names and layouts (Linear ``[out, in]`` ->
kernel ``[in, out]``), and the loads write them into a model through
``utils.weights``'s flax names, so the port and the JAX package map a
checkpoint alike.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .weights import _flax_names


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def roberta_to_lang_encoder(hf_state: dict, num_layers: int,
                            jump_init: bool = False,
                            prefix: str = "lang_encoder") -> dict:
    """Map a HF roberta state dict -> flat {our_name: array}.

    ``jump_init``: take every second source layer (0, 2, 4, ...) so a
    6-layer student inherits from a 12-layer encoder
    (train_r2r_magic.py jump_init_txt).
    """
    sd = {k.removeprefix("roberta."): _np(v) for k, v in hf_state.items()}
    out = {}

    def emb(src, dst):
        if src in sd:
            out[f"{prefix}.{dst}.embedding"] = sd[src]

    emb("embeddings.word_embeddings.weight", "word_embeddings")
    emb("embeddings.position_embeddings.weight", "position_embeddings")
    emb("embeddings.token_type_embeddings.weight", "token_type_embeddings")
    if "embeddings.LayerNorm.weight" in sd:
        out[f"{prefix}.emb_norm.scale"] = sd["embeddings.LayerNorm.weight"]
        out[f"{prefix}.emb_norm.bias"] = sd["embeddings.LayerNorm.bias"]

    for i in range(num_layers):
        src_i = 2 * i if jump_init else i
        s = f"encoder.layer.{src_i}"
        d = f"{prefix}.layer_{i}"
        if f"{s}.attention.self.query.weight" not in sd:
            break
        for name in ("query", "key", "value"):
            out[f"{d}.attention.{name}.kernel"] = _t(
                sd[f"{s}.attention.self.{name}.weight"])
            out[f"{d}.attention.{name}.bias"] = sd[
                f"{s}.attention.self.{name}.bias"]
        out[f"{d}.attention.out.kernel"] = _t(
            sd[f"{s}.attention.output.dense.weight"])
        out[f"{d}.attention.out.bias"] = sd[f"{s}.attention.output.dense.bias"]
        out[f"{d}.attention_norm.LayerNorm_0.scale"] = sd[
            f"{s}.attention.output.LayerNorm.weight"]
        out[f"{d}.attention_norm.LayerNorm_0.bias"] = sd[
            f"{s}.attention.output.LayerNorm.bias"]
        out[f"{d}.ffn.intermediate.kernel"] = _t(
            sd[f"{s}.intermediate.dense.weight"])
        out[f"{d}.ffn.intermediate.bias"] = sd[f"{s}.intermediate.dense.bias"]
        out[f"{d}.ffn.output.kernel"] = _t(sd[f"{s}.output.dense.weight"])
        out[f"{d}.ffn.output.bias"] = sd[f"{s}.output.dense.bias"]
        out[f"{d}.ffn_norm.LayerNorm_0.scale"] = sd[
            f"{s}.output.LayerNorm.weight"]
        out[f"{d}.ffn_norm.LayerNorm_0.bias"] = sd[f"{s}.output.LayerNorm.bias"]
    return out


def _cross_layer_map(sd: dict, src: str, dst: str) -> dict:
    """Map one METER ``BertCrossLayer`` (cross_modal_image_layers.N) onto our
    ``CrossModalLayer`` (``models.layers``): METER ``attention`` is the
    visual self-attention, ``crossattention`` the vision-queries-language
    attention, ``intermediate``/``output`` the FFN."""
    out = {}
    pairs = (("crossattention", "crossattention", "crossattention_norm"),
             ("attention", "self_attention", "self_norm"))
    for meter_attn, ours_attn, ours_norm in pairs:
        if f"{src}.{meter_attn}.self.query.weight" not in sd:
            continue
        for name in ("query", "key", "value"):
            out[f"{dst}.{ours_attn}.{name}.kernel"] = _t(
                sd[f"{src}.{meter_attn}.self.{name}.weight"])
            out[f"{dst}.{ours_attn}.{name}.bias"] = sd[
                f"{src}.{meter_attn}.self.{name}.bias"]
        out[f"{dst}.{ours_attn}.out.kernel"] = _t(
            sd[f"{src}.{meter_attn}.output.dense.weight"])
        out[f"{dst}.{ours_attn}.out.bias"] = sd[
            f"{src}.{meter_attn}.output.dense.bias"]
        out[f"{dst}.{ours_norm}.LayerNorm_0.scale"] = sd[
            f"{src}.{meter_attn}.output.LayerNorm.weight"]
        out[f"{dst}.{ours_norm}.LayerNorm_0.bias"] = sd[
            f"{src}.{meter_attn}.output.LayerNorm.bias"]
    if f"{src}.intermediate.dense.weight" in sd:
        out[f"{dst}.ffn.intermediate.kernel"] = _t(
            sd[f"{src}.intermediate.dense.weight"])
        out[f"{dst}.ffn.intermediate.bias"] = sd[f"{src}.intermediate.dense.bias"]
        out[f"{dst}.ffn.output.kernel"] = _t(sd[f"{src}.output.dense.weight"])
        out[f"{dst}.ffn.output.bias"] = sd[f"{src}.output.dense.bias"]
        out[f"{dst}.ffn_norm.LayerNorm_0.scale"] = sd[
            f"{src}.output.LayerNorm.weight"]
        out[f"{dst}.ffn_norm.LayerNorm_0.bias"] = sd[f"{src}.output.LayerNorm.bias"]
    return out


def meter_to_params(meter_state: dict, num_l_layers: int, num_x_layers: int,
                    jump_init: bool = False) -> dict:
    """Map a METER checkpoint (``meter_clip16_224_roberta_pretrain.ckpt``
    state_dict) onto the flat relative names of our model: the
    ``text_transformer`` stack -> lang_encoder (with ``jump_init_txt``
    even-layer skip for shallower students) and each
    ``cross_modal_image_layers.N`` -> BOTH ``local_encoder.layer_N`` and
    ``global_encoder.layer_N``, exactly the reference's remap prefixes
    (train_r2r_magic.py:190-254: bert.lang_encoder,
    bert.{local,global}_encoder.encoder.crossattention)."""
    sd = {k: _np(v) for k, v in meter_state.items()}
    txt = {k.removeprefix("text_transformer."): v for k, v in sd.items()
           if k.startswith("text_transformer.")}
    out = roberta_to_lang_encoder(txt, num_l_layers, jump_init)
    for i in range(num_x_layers):
        src = f"cross_modal_image_layers.{i}"
        for enc in ("local_encoder", "global_encoder"):
            out.update(_cross_layer_map(sd, src, f"{enc}.layer_{i}"))
        # METER's text-side cross layers are text-queries-image — our
        # lang2visn attention (use_lang2visn_attn, model config:27)
        tsrc = f"cross_modal_text_layers.{i}"
        if f"{tsrc}.crossattention.self.query.weight" in sd:
            for enc in ("local_encoder", "global_encoder"):
                dst = f"{enc}.layer_{i}"
                for name in ("query", "key", "value"):
                    out[f"{dst}.lang2visn_attention.{name}.kernel"] = _t(
                        sd[f"{tsrc}.crossattention.self.{name}.weight"])
                    out[f"{dst}.lang2visn_attention.{name}.bias"] = sd[
                        f"{tsrc}.crossattention.self.{name}.bias"]
                out[f"{dst}.lang2visn_attention.out.kernel"] = _t(
                    sd[f"{tsrc}.crossattention.output.dense.weight"])
                out[f"{dst}.lang2visn_attention.out.bias"] = sd[
                    f"{tsrc}.crossattention.output.dense.bias"]
                out[f"{dst}.lang2visn_norm.LayerNorm_0.scale"] = sd[
                    f"{tsrc}.crossattention.output.LayerNorm.weight"]
                out[f"{dst}.lang2visn_norm.LayerNorm_0.bias"] = sd[
                    f"{tsrc}.crossattention.output.LayerNorm.bias"]
    return out


def merge_mapped_weights(model: nn.Module, mapped: dict):
    """Copy ``{relative flax name: array}`` into ``model`` in place.  The
    root may be ``params.`` (the navigator) or ``params.bert.`` (the
    pretraining model, the reference's ``bert.`` trunk prefix); both are
    probed with exact names, so same-suffix submodules never mis-link.  A
    shape mismatch skips the entry.  Returns (loaded flax names, skipped
    names)."""
    names = _flax_names(model)
    loaded, skipped = [], []
    with torch.no_grad():
        for name, arr in mapped.items():
            for full in (f"params.{name}", f"params.bert.{name}"):
                if full in names:
                    param, transpose = names[full]
                    val = torch.from_numpy(np.array(arr, np.float32))
                    if transpose:
                        val = val.t()
                    if tuple(val.shape) == tuple(param.shape):
                        param.copy_(val)
                        loaded.append(full)
                    else:
                        skipped.append(full)
                    break
            else:
                skipped.append(name)
    return loaded, skipped


def load_roberta_weights(model: nn.Module, hf_state: dict, num_layers: int,
                         jump_init: bool = False):
    """Load mapped RoBERTa weights into ``model`` in place; returns the
    loaded flax names."""
    mapped = roberta_to_lang_encoder(hf_state, num_layers, jump_init)
    loaded, _ = merge_mapped_weights(model, mapped)
    return loaded


def load_meter_weights(model: nn.Module, meter_state: dict,
                       num_l_layers: int, num_x_layers: int,
                       jump_init: bool = False):
    """Load a METER checkpoint into ``model`` in place: the language stack
    and both cross-modal encoders' attention and FFN weights (the
    reference's init_pretrained='meter' path, train_r2r_magic.py:183-254).
    Returns (loaded flax names, skipped names)."""
    mapped = meter_to_params(meter_state, num_l_layers, num_x_layers,
                             jump_init)
    return merge_mapped_weights(model, mapped)
