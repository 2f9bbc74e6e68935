"""Tokenization for the port's harnesses: a local BPE ``tokenizer.json`` or
the deterministic hash tokenizer.

``SimpleTokenizer`` is a copy of the JAX package's
(``sparse_matrix_fine_tuning_tpu/data/tokenizer.py``), which keeps every
harness runnable end to end with no download.  The JAX ``get_tokenizer``
loads a local HF tokenizer through ``transformers``, which the port may not
import: here a directory with a ``tokenizer.json`` whose model is BPE gives
``data/hf_tokenizer.BPETokenizer``, pure Python with the JAX wrapper's
interface.  Any other directory that holds tokenizer files (WordPiece,
Unigram, a ``tokenizer.model`` or the slow tokenizers' vocabulary files
alone) is refused with ``NotImplementedError`` (ROADMAP.md queue A item 13)
where the JAX function would fall back to the hash tokenizer: a real
tokenizer's text is never hashed.  Any other name or directory gives the
hash tokenizer, as the JAX function does when no local HF tokenizer loads.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional, Sequence

import numpy as np

from sparse_matrix_fine_tuning_torch.data.hf_tokenizer import BPETokenizer, unsupported

_WORD_RE = re.compile(r"\w+|[^\w\s]")


class SimpleTokenizer:
    """Deterministic hash tokenizer (RoBERTa-style special ids:
    bos=0, pad=1, eos=2)."""

    bos_token_id = 0
    pad_token_id = 1
    eos_token_id = 2
    unk_token_id = 3
    _n_special = 4

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size
        self._id_to_word: dict[int, str] = {}

    def _tok(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.lower().encode()).digest()[:4], "little")
        tid = self._n_special + h % (self.vocab_size - self._n_special)
        self._id_to_word.setdefault(tid, word.lower())
        return tid

    def tokenize_ids(self, text: str) -> list[int]:
        return [self._tok(w) for w in _WORD_RE.findall(text)]

    def encode_ids(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self.tokenize_ids(text)
        return ([self.bos_token_id] + ids) if add_bos else ids

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: int = 128):
        ids = [self.bos_token_id] + self.tokenize_ids(text) + [self.eos_token_id]
        if text_pair is not None:
            ids += [self.eos_token_id] + self.tokenize_ids(text_pair) + [self.eos_token_id]
        ids = ids[:max_length]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return ids + [self.pad_token_id] * pad, mask + [0] * pad

    def encode_batch(self, texts: Sequence[str],
                     pairs: Optional[Sequence[str]] = None,
                     max_length: int = 128):
        out_ids, out_mask = [], []
        for i, t in enumerate(texts):
            p = pairs[i] if pairs is not None else None
            ids, mask = self.encode(t, p, max_length)
            out_ids.append(ids)
            out_mask.append(mask)
        return np.asarray(out_ids, np.int32), np.asarray(out_mask, np.int32)

    def decode(self, ids) -> str:
        # invertible for words seen during encoding (sufficient for smoke
        # evals); unknown ids render as placeholders
        words = []
        for i in ids:
            i = int(i)
            if i in (self.bos_token_id, self.pad_token_id, self.eos_token_id):
                continue
            words.append(self._id_to_word.get(i, f"<{i}>"))
        return " ".join(words)

    @property
    def eos_token(self) -> str:
        return "</s>"


# the files from which HF's AutoTokenizer builds a tokenizer
TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json", "vocab.json",
                   "merges.txt", "vocab.txt", "spiece.model", "sentencepiece.bpe.model")


def get_tokenizer(model_name_or_path: Optional[str] = None, vocab_size: int = 50265):
    """``BPETokenizer`` for a directory whose ``tokenizer.json`` holds a BPE
    model; ``SimpleTokenizer(vocab_size)`` for a name, None or a checkpoint
    directory without tokenizer files (where the JAX function's
    ``AutoTokenizer`` fails and falls back).  Any other directory with
    ``TOKENIZER_FILES`` is refused: its text is never hashed in place of its
    real tokenizer."""
    if model_name_or_path and os.path.isdir(model_name_or_path):
        found = [f for f in TOKENIZER_FILES
                 if os.path.exists(os.path.join(model_name_or_path, f))]
        if "tokenizer.json" in found:
            return BPETokenizer(model_name_or_path)
        if found:
            raise unsupported(f"the HF tokenizer in {model_name_or_path!r} "
                              f"({', '.join(found)}) has no tokenizer.json")
    return SimpleTokenizer(vocab_size=vocab_size)
