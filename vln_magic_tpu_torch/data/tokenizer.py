"""Tokenizer access: RoBERTa/BERT from a local directory when available
(the reference loads a local RoBERTa tokenizer dir, readme.md:29,
main_nav.py:44), with a deterministic hash tokenizer fallback so the whole
framework runs without downloaded assets.  A copy of
``vln_magic_tpu/data/tokenizer.py``; ``transformers`` is imported only when
a tokenizer directory exists.
"""

from __future__ import annotations

import os

import numpy as np


class HashTokenizer:
    """Deterministic word-hash tokenizer (RoBERTa-like special ids:
    bos=0, pad=1, eos=2)."""

    bos_token_id = 0
    pad_token_id = 1
    eos_token_id = 2
    mask_token_id = 3

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def encode(self, text: str):
        import zlib

        ids = [4 + (zlib.crc32(w.lower().encode()) % (self.vocab_size - 8))
               for w in text.split()]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(self, text):
        return {"input_ids": self.encode(text)}


def get_tokenizer(name_or_path: str | None = None, vocab_size: int = 50265):
    if name_or_path and os.path.exists(name_or_path):
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name_or_path)
    return HashTokenizer(vocab_size)
