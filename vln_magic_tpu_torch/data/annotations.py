"""R2R / RxR annotation loading.

Mirrors the reference's annotation pipeline (reference:
map_nav_src/r2r/data_utils.py:105-192): R2R items carry several instructions
each and are split into one item per instruction with ``instr_id =
f"{path_id}_{j}"``; RxR (jsonl) is filtered to English and keeps
``instruction_id``.  ``--for_debug`` truncation (50 items) is preserved.
Multiprocess JSON loading is unnecessary here — parsing is not the
bottleneck once features live in device tables.  A copy of
``vln_magic_tpu/data/annotations.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_instr_datasets(anno_dir: str, dataset: str, splits, tokenizer=None,
                        for_debug: bool = False, langs=("en",)):
    """``langs``: language-tag prefixes to keep for RxR.  The reference
    hard-filters to English (data_utils.py:163-178); passing e.g.
    ("en", "hi", "te") keeps the multilingual splits (RxR ships an XLM-R
    encoding per instruction, so no re-tokenization is needed), and
    ``langs=None`` keeps everything."""
    data = []
    for split in splits:
        if dataset == "r2r":
            path = os.path.join(anno_dir, f"R2R_{split}_enc.json")
            if not os.path.exists(path):
                path = os.path.join(anno_dir, f"R2R_{split}.json")
            with open(path) as f:
                items = json.load(f)
        elif dataset == "rxr":
            path = os.path.join(anno_dir, f"RxR_{split}_guide_enc_xlmr.jsonl")
            items = []
            with open(path) as f:
                for line in f:
                    if line.strip():
                        item = json.loads(line)
                        lang = item.get("language", "en")
                        if langs is None or any(l in lang for l in langs):
                            items.append(item)
        else:
            raise ValueError(dataset)
        data.append((split, items))
    if for_debug:
        data = [(s, items[:50]) for s, items in data]
    return data


def construct_instrs(anno_dir: str, dataset: str, splits, tokenizer=None,
                     max_instr_len: int = 200, for_debug: bool = False,
                     langs=("en",)):
    """One flat item per instruction, reference schema."""
    out = []
    for split, items in load_instr_datasets(anno_dir, dataset, splits,
                                            for_debug=for_debug, langs=langs):
        for item in items:
            if dataset == "r2r":
                for j, instr in enumerate(item["instructions"]):
                    enc = item.get("instr_encodings", [None] * 10)[j] \
                        if "instr_encodings" in item else None
                    if enc is None and tokenizer is not None:
                        enc = tokenizer.encode(instr)
                    new = {
                        "instr_id": f"{item['path_id']}_{j}",
                        "path_id": item["path_id"],
                        "scan": item["scan"],
                        "path": item["path"],
                        "heading": item.get("heading", 0.0),
                        "instruction": instr,
                        "instr_encoding": np.asarray(enc[:max_instr_len],
                                                     dtype=np.int32),
                    }
                    out.append(new)
            else:  # rxr
                enc = item.get("instr_encoding")
                if enc is None and tokenizer is not None:
                    enc = tokenizer.encode(item["instruction"])
                out.append({
                    "instr_id": str(item["instruction_id"]),
                    "path_id": item.get("path_id", item["instruction_id"]),
                    "scan": item["scan"],
                    "path": item["path"],
                    "heading": item.get("heading", 0.0),
                    "instruction": item["instruction"],
                    "language": item.get("language", "en"),
                    "instr_encoding": np.asarray(enc[:max_instr_len],
                                                 dtype=np.int32),
                })
    return out


def attach_path_indices(items, world):
    """Resolve viewpoint-id paths to node indices against a built world."""
    out = []
    for it in items:
        si = world.scan_index.get(it["scan"])
        if si is None:
            continue
        it = dict(it)
        it["scan_idx"] = si
        it["path_idx"] = world.encode_path(it["scan"], it["path"])
        out.append(it)
    return out
