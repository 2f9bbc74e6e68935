"""A local HF ``tokenizer.json`` with a BPE model, in pure Python.

The JAX package loads a checkpoint's tokenizer with ``transformers``'
``AutoTokenizer`` (``HFTokenizerWrapper``); the port may not import
``transformers``, ``tokenizers``, ``regex`` or ``sentencepiece``, and the
card's machine has none of them.  ``BPETokenizer`` reads the same files and
gives the wrapper's interface (``encode_batch``, ``encode_ids``, ``decode``,
``pad_token_id``, ``bos_token_id``, ``eos_token_id``, ``vocab_size``) with
the ids, masks and text that ``transformers`` gives, for the pipelines of
the families the port loads:

  * byte-level BPE (GPT-2, GPT-Neo, GPT-NeoX, Backpack, RoBERTa, Qwen2):
    the ``ByteLevel`` pre-tokenizer and decoder, ``Split`` with a regex,
    ``NFC``, and the ``RobertaProcessing``, ``ByteLevel`` and
    ``TemplateProcessing`` post-processors;
  * SentencePiece-style BPE with ``byte_fallback`` (Llama, Mistral,
    TinyLlama, Gemma): the ``Prepend`` + ``Replace`` normalizer or the
    ``Metaspace`` pre-tokenizer, and the ``Replace``, ``ByteFallback``,
    ``Fuse``, ``Strip`` and ``Metaspace`` decoders;
  * added tokens, split out of the raw text before the model.

What ``transformers``' classes do on top of ``tokenizer.json`` is followed
for their names in ``tokenizer_config.json`` (or, where it names none,
``config.json``'s ``model_type``): the special tokens' defaults, Llama's,
Gemma's and GPT-NeoX's post-processor rebuilt from ``add_bos_token`` /
``add_eos_token``, and ``add_prefix_space`` set on a ``ByteLevel``
pre-tokenizer.  ``special_tokens_map.json`` overrides the config's special
tokens, as in ``transformers``.  A directory whose model is another one
(WordPiece, Unigram) or whose pipeline holds a component not listed here is
refused with ``NotImplementedError``.

The split regexes' ``\\p{L}``, ``\\p{N}`` (any Unicode category) and ``\\s``
are Oniguruma's, which ``tokenizers`` runs: they are
rebuilt for Python's ``re`` as explicit classes from ``unicodedata``
(``\\s`` is Unicode White_Space, where ``re`` also counts U+001C-U+001F).
Code points assigned in one Unicode version and not in the other (Python's
``unicodedata.unidata_version`` against Oniguruma's tables) may part.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

ITEM_13 = ("ROADMAP.md queue A item 13, 'The Llama model, training part' (a local tokenizer: "
           "WordPiece, Unigram and tokenizer.model)")


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {ITEM_13}")


# -- Oniguruma's Unicode classes for Python's re -----------------------------

_WHITE_SPACE = "\\t\\n\\x0b\\x0c\\r \\x85\\xa0\\u1680\\u2000-\\u200a\\u2028\\u2029\\u202f\\u205f\\u3000"


@lru_cache(maxsize=None)
def _category_ranges() -> dict:
    """General category (two letters) -> [(first, last)] code point ranges."""
    ranges: dict[str, list] = {}
    last_cat, start = None, 0
    for cp in range(sys.maxunicode + 2):
        cat = unicodedata.category(chr(cp)) if cp <= sys.maxunicode else None
        if cat != last_cat:
            if last_cat is not None:
                ranges.setdefault(last_cat, []).append((start, cp - 1))
            last_cat, start = cat, cp
    return ranges


@lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """The inside of a ``[...]`` class of the categories starting ``name``
    (``L``, ``N``, ``Lu``, ...)."""
    spans = sorted(r for cat, rs in _category_ranges().items() if cat.startswith(name)
                   for r in rs)
    if not spans:
        raise unsupported(f"the Unicode class \\p{{{name}}} of a tokenizer's regex")
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in spans)


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern as a Python ``re`` pattern with the same classes."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP" and pattern[i + 2:i + 3] == "{":
                end = pattern.index("}", i)
                body, negated = _class_body(pattern[i + 3:end]), nxt == "P"
                i = end + 1
            elif nxt in "sS":
                body, negated = _WHITE_SPACE, nxt == "S"
                i += 2
            elif nxt in "dDwW":  # Python's classes differ from Oniguruma's
                raise unsupported(f"\\{nxt} in the regex {pattern!r}")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class and negated:
                raise unsupported(f"a negated class inside [...] in the regex {pattern!r}")
            out.append(body if in_class else f"[{'^' if negated else ''}{body}]")
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


@lru_cache(maxsize=None)
def compile_regex(pattern: str) -> re.Pattern:
    return re.compile(translate_regex(pattern))


GPT2_SPLIT = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


@lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character map of the byte-level BPEs."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) \
        + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_whitespace(ch: str) -> bool:
    return re.fullmatch(f"[{_WHITE_SPACE}]", ch) is not None


# -- the pipeline: pieces of text with a flag for "starts the input" -----------

class Piece:
    """A split of the input: its text, whether it starts at the input's
    first character, and the added token's id where it is one."""

    __slots__ = ("text", "first", "token")

    def __init__(self, text: str, first: bool, token: Optional[int] = None):
        self.text, self.first, self.token = text, first, token


def _replace(spec: dict, text: str) -> str:
    pat = spec["pattern"]
    if "String" in pat:
        return text.replace(pat["String"], spec["content"])
    return compile_regex(pat["Regex"]).sub(lambda _: spec["content"], text)


def normalize(spec: Optional[dict], text: str) -> str:
    if spec is None:
        return text
    kind = spec["type"]
    if kind == "Sequence":
        for sub in spec["normalizers"]:
            text = normalize(sub, text)
        return text
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return unicodedata.normalize(kind, text)
    if kind == "Prepend":
        return spec["prepend"] + text if text else text
    if kind == "Replace":
        return _replace(spec, text)
    raise unsupported(f"the {kind} normalizer")


def _split_spans(text: str, spans: list, behavior: str) -> list:
    """Cut ``text`` at the match ``spans`` [(start, end)] by a tokenizers
    ``SplitDelimiterBehavior`` ("Isolated" or "MergedWithNext"): [(start,
    end)] of the pieces."""
    cuts, prev = [], 0
    for a, b in spans:
        if prev < a:
            cuts.append(((prev, a), False))
        cuts.append(((a, b), True))
        prev = b
    if prev < len(text):
        cuts.append(((prev, len(text)), False))
    if behavior == "Isolated":
        return [span for span, _ in cuts]
    if behavior != "MergedWithNext":
        raise unsupported(f"the split behavior {behavior}")
    out, previous = [], False  # a delimiter joins the piece after it
    for span, m in reversed(cuts):
        if m and not previous and out:
            out[-1] = (span[0], out[-1][1])
        else:
            out.append(span)
        previous = m
    return out[::-1]


def _split(piece: Piece, spans: list, behavior: str) -> list:
    return [Piece(piece.text[a:b], piece.first and a == 0)
            for a, b in _split_spans(piece.text, spans, behavior) if b > a]


def _match_spans(regex: re.Pattern, text: str) -> list:
    return [m.span() for m in regex.finditer(text) if m.end() > m.start()]


def pre_tokenize(spec: Optional[dict], pieces: list) -> list:
    if spec is None:
        return pieces
    kind = spec["type"]
    if kind == "Sequence":
        for sub in spec["pretokenizers"]:
            pieces = pre_tokenize(sub, pieces)
        return pieces
    out = []
    for p in pieces:
        if kind == "ByteLevel":
            text = p.text
            if spec.get("add_prefix_space") and not text.startswith(" "):
                text = " " + text
            q = Piece(text, p.first)
            parts = _split(q, _match_spans(compile_regex(GPT2_SPLIT), text), "Isolated") \
                if spec.get("use_regex", True) else [q]
            table = bytes_to_unicode()
            out += [Piece("".join(table[b] for b in s.text.encode("utf-8")), s.first)
                    for s in parts]
        elif kind == "Split":
            if spec.get("invert"):
                raise unsupported("an inverted Split pre-tokenizer")
            pat = spec["pattern"]
            regex = compile_regex(pat["Regex"]) if "Regex" in pat else re.compile(
                re.escape(pat["String"]))
            out += _split(p, _match_spans(regex, p.text), spec["behavior"])
        elif kind == "Metaspace":
            rep = spec["replacement"]
            text = p.text.replace(" ", rep)
            scheme = spec.get("prepend_scheme", "always")
            if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and p.first)):
                text = rep + text
            q = Piece(text, p.first)
            out += _split(q, [m.span() for m in re.finditer(re.escape(rep), text)],
                          "MergedWithNext") if spec.get("split", True) else [q]
        else:
            raise unsupported(f"the {kind} pre-tokenizer")
    return out


# -- the BPE model -----------------------------------------------------------

class BPE:
    """tokenizers' ``BPE`` model without dropout: characters (or their
    ``<0xNN>`` byte tokens, or ``unk``), then the ranked merges, lowest rank
    first, leftmost first among equals."""

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0, 0.0):
            raise unsupported("BPE dropout")
        if spec.get("continuing_subword_prefix") or spec.get("end_of_word_suffix"):
            raise unsupported("a BPE with a subword prefix or an end-of-word suffix")
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.ranks: dict[tuple, tuple] = {}
        for rank, merge in enumerate(spec["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge  # old and new formats
            self.ranks[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.cache: dict[str, list] = {}

    def _symbols(self, word: str) -> list:
        ids, unk = [], None
        for s in word:
            if s in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[s])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in s.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    ids += [self.vocab[c] for c in codes]
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            ids.append(unk)
        return ids

    def tokenize(self, word: str) -> list:
        if word in self.cache:
            return self.cache[word]
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = self._symbols(word)
            ranks = self.ranks
            while len(ids) > 1:
                best = None
                for i in range(len(ids) - 1):
                    r = ranks.get((ids[i], ids[i + 1]))
                    if r is not None and (best is None or r[0] < best[0]):
                        best, at = r, i
                if best is None:
                    break
                ids[at:at + 2] = [best[1]]
        self.cache[word] = ids
        return ids


# -- post-processing ---------------------------------------------------------

def _template(items: list, special: dict, a: list, b: Optional[list]) -> list:
    out = []
    for item in items:
        if "SpecialToken" in item:
            out += special[item["SpecialToken"]["id"]]["ids"]
        else:
            out += a if item["Sequence"]["id"] == "A" else (b or [])
    return out


def post_process(spec: Optional[dict], a: list, b: Optional[list]) -> list:
    if spec is None:
        return a + (b or [])
    kind = spec["type"]
    if kind == "Sequence":  # ByteLevel only trims offsets: at most one other adds tokens
        subs = [sub for sub in spec["processors"] if sub["type"] != "ByteLevel"]
        if len(subs) > 1:
            raise unsupported("a post-processor Sequence of more than one that adds tokens")
        return post_process(subs[0] if subs else None, a, b)
    if kind == "ByteLevel":
        return a + (b or [])
    if kind == "RobertaProcessing":
        cls, sep = spec["cls"][1], spec["sep"][1]
        return [cls] + a + [sep] + ([] if b is None else [sep] + b + [sep])
    if kind == "TemplateProcessing":
        return _template(spec["pair" if b is not None else "single"], spec["special_tokens"], a, b)
    raise unsupported(f"the {kind} post-processor")


def added_count(spec: Optional[dict], pair: bool) -> int:
    return len(post_process(spec, [], [] if pair else None))


# -- decoding ----------------------------------------------------------------

def _byte_fallback(tokens: list) -> list:
    out, pending = [], []

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                pending.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def decode_chain(spec: Optional[dict], tokens: list) -> list:
    kind = spec["type"]
    if kind == "Sequence":
        for sub in spec["decoders"]:
            tokens = decode_chain(sub, tokens)
        return tokens
    if kind == "ByteLevel":
        table = {c: b for b, c in bytes_to_unicode().items()}
        raw = bytearray()
        for t in tokens:
            if all(c in table for c in t):
                raw += bytes(table[c] for c in t)
            else:
                raw += t.encode("utf-8")
        return [raw.decode("utf-8", errors="replace")]
    if kind == "Replace":
        return [_replace(spec, t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback(tokens)
    if kind == "Fuse":
        return ["".join(tokens)]
    if kind == "Strip":
        ch, start, stop = spec["content"], spec["start"], spec["stop"]
        out = []
        for t in tokens:
            i, j = 0, len(t)
            while i < min(start, j) and t[i] == ch:
                i += 1
            k = 0
            while k < stop and j > i and t[j - 1] == ch:
                j, k = j - 1, k + 1
            out.append(t[i:j])
        return out
    if kind == "Metaspace":
        rep = spec["replacement"]
        lead = spec.get("prepend_scheme", "always") != "never"
        return ["".join("" if c == rep and i == 0 and lead else (" " if c == rep else c)
                        for c in t) for i, t in enumerate(tokens)]
    raise unsupported(f"the {kind} decoder")


def clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


# -- the transformers classes over tokenizer.json ------------------------------

SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                "mask_token")
# class name -> (special token defaults, add_bos_token, add_eos_token or None where the
# class keeps tokenizer.json's post-processor, add_prefix_space default)
CLASSES = {
    "PreTrainedTokenizerFast": ({}, None, None, False),
    "LlamaTokenizerFast": ({"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"},
                           True, False, None),
    "GemmaTokenizerFast": ({"bos_token": "<bos>", "eos_token": "<eos>", "unk_token": "<unk>",
                            "pad_token": "<pad>"}, True, False, False),
    "GPT2TokenizerFast": (dict.fromkeys(("bos_token", "eos_token", "unk_token"),
                                        "<|endoftext|>"), None, None, False),
    "GPTNeoXTokenizerFast": (dict.fromkeys(("bos_token", "eos_token", "unk_token"),
                                           "<|endoftext|>"), False, False, False),
    "RobertaTokenizerFast": ({"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                              "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>",
                              "mask_token": "<mask>"}, None, None, False),
    "Qwen2TokenizerFast": ({"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                            "pad_token": "<|endoftext|>"}, None, None, False),
}
# config.json model_type -> class, where tokenizer_config.json names none
MODEL_TYPES = {"llama": "LlamaTokenizerFast", "mistral": "LlamaTokenizerFast",
               "gemma": "GemmaTokenizerFast", "gpt2": "GPT2TokenizerFast",
               "gpt_neo": "GPT2TokenizerFast", "gpt_neox": "GPTNeoXTokenizerFast",
               "roberta": "RobertaTokenizerFast", "qwen2": "Qwen2TokenizerFast"}


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(token) -> Optional[str]:
    return token.get("content") if isinstance(token, dict) else token


def class_name(config: dict, model_config: dict) -> str:
    """The transformers class AutoTokenizer builds: tokenizer_config.json's
    ``tokenizer_class`` (its fast variant), else by config.json's model_type."""
    name = config.get("tokenizer_class")
    if name is None:
        name = MODEL_TYPES.get(model_config.get("model_type"), "PreTrainedTokenizerFast")
    if not name.endswith("Fast"):
        name += "Fast"
    if name not in CLASSES:
        raise unsupported(f"the tokenizer class {name}")
    return name


class BPETokenizer:
    """A ``tokenizer.json`` BPE tokenizer with the JAX ``HFTokenizerWrapper``'s
    interface; see the module's docstring."""

    def __init__(self, path: str):
        spec = _read_json(os.path.join(path, "tokenizer.json"))
        model = spec.get("model") or {}
        if model.get("type", "BPE" if "merges" in model else None) != "BPE":
            raise unsupported(f"the {model.get('type', 'unknown')} model of {path}/tokenizer.json "
                              "(only BPE is read)")
        config = _read_json(os.path.join(path, "tokenizer_config.json"))
        cls = class_name(config, _read_json(os.path.join(path, "config.json")))
        defaults, add_bos, add_eos, prefix_space = CLASSES[cls]
        if prefix_space is None and config.get("add_prefix_space") is not None:
            raise unsupported(f"{cls} with add_prefix_space (transformers rebuilds it from "
                              "tokenizer.model)")
        self.model = BPE(model)
        self.normalizer = spec.get("normalizer")
        self.pre_tokenizer = spec.get("pre_tokenizer")
        self.decoder = spec.get("decoder")
        pre = self.pre_tokenizer
        space = config.get("add_prefix_space", prefix_space)
        if pre is not None and "add_prefix_space" in pre and space is not None:
            self.pre_tokenizer = {**pre, "add_prefix_space": space}
        self.clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        self.padding_side = config.get("padding_side", "left" if cls in (
            "LlamaTokenizerFast", "GemmaTokenizerFast") else "right")
        self.truncation_side = config.get("truncation_side", "right")

        # added tokens: tokenizer.json's, then the config's, then the special
        # tokens not yet among them (transformers' PreTrainedTokenizerFast)
        self.added: dict[str, dict] = {}
        for tok in spec.get("added_tokens", []):
            self.added[tok["content"]] = dict(tok)
        for _, tok in sorted(config.get("added_tokens_decoder", {}).items(),
                             key=lambda kv: int(kv[0])):
            self._add(dict(tok))
        special = dict(defaults)
        special.update({k: config[k] for k in SPECIAL_KEYS if k in config})
        special_map = _read_json(os.path.join(path, "special_tokens_map.json"))
        special.update({k: special_map[k] for k in SPECIAL_KEYS if k in special_map})
        extra = special_map.get("additional_special_tokens",
                                config.get("additional_special_tokens", []))
        self.special = {k: _content(v) for k, v in special.items() if _content(v) is not None}
        for tok in [*self.special.values(), *map(_content, extra)]:
            if tok not in self.added:
                self._add({"content": tok, "special": True})
        self.id_to_added = {t["id"]: t for t in self.added.values()}
        self.special_ids = {t["id"] for t in self.added.values() if t.get("special")}
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self._by_text: dict[tuple, dict] = {}  # (normalized, text it matches) -> added token
        self._added_regex = {flag: self._matcher(flag) for flag in (False, True)}

        self.post_processor = spec.get("post_processor")
        if add_bos is not None:  # Llama, Gemma, GPT-NeoX: update_post_processor()
            add_bos = config.get("add_bos_token", add_bos)
            add_eos = config.get("add_eos_token", add_eos)
            single, specials = [], {}
            for flag, key in ((add_bos, "bos_token"), (add_eos, "eos_token")):
                if flag and key not in self.special:
                    raise ValueError(f"add_{key[:3]}_token = True but {key} = None")
                if flag:
                    specials[self.special[key]] = {"id": self.special[key],
                                                   "ids": [self.token_id(self.special[key])]}
            bos = [{"SpecialToken": {"id": self.special.get("bos_token")}}] if add_bos else []
            eos = [{"SpecialToken": {"id": self.special.get("eos_token")}}] if add_eos else []
            single = bos + [{"Sequence": {"id": "A"}}] + eos
            pair = single + bos + [{"Sequence": {"id": "B"}}] + eos
            self.post_processor = {"type": "TemplateProcessing", "single": single, "pair": pair,
                                   "special_tokens": specials}
        self.vocab_size = len(self.model.vocab)
        pad = self.special.get("pad_token")
        self.pad_token = pad
        self.pad_token_id = self.token_id(pad) if pad is not None else 0
        self.bos_token_id = self.token_id(self.special["bos_token"]) \
            if "bos_token" in self.special else None
        self.eos_token_id = self.token_id(self.special["eos_token"]) \
            if "eos_token" in self.special else None
        self.eos_token = self.special.get("eos_token")

    def _add(self, tok: dict) -> None:
        """tokenizers' ``AddedVocabulary.add_tokens``: an existing token is
        updated; a new one takes its id in the model's vocabulary, else the
        next free id."""
        content = tok["content"]
        if not content:
            return
        tok = {"single_word": False, "lstrip": False, "rstrip": False,
               "normalized": not tok.get("special", False), "special": False, **tok}
        if content in self.added:
            tok["id"] = self.added[content]["id"]
        elif content in self.model.vocab:
            tok["id"] = self.model.vocab[content]
        else:
            ids = [t["id"] for t in self.added.values()]
            size = len(self.model.vocab)
            tok["id"] = max(ids) + 1 if ids and (max(ids) >= size or size == 0) else size
        self.added[content] = tok

    def _matcher(self, normalized: bool) -> Optional[re.Pattern]:
        toks = [t for t in self.added.values() if bool(t.get("normalized")) == normalized]
        if not toks:
            return None
        texts = []
        for t in toks:
            text = normalize(self.normalizer, t["content"]) if normalized else t["content"]
            self._by_text.setdefault((normalized, text), t)
            texts.append(text)
        return re.compile("|".join(re.escape(t) for t in sorted(set(texts), key=len,
                                                                   reverse=True)))

    def token_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]["id"]
        if token in self.model.vocab:
            return self.model.vocab[token]
        unk = self.special.get("unk_token")
        return self.token_id(unk) if unk is not None and unk != token else None

    def _extract(self, piece: Piece, normalized: bool) -> list:
        """Split the added tokens of one kind out of a piece."""
        regex = self._added_regex[normalized]
        if regex is None or piece.token is not None:
            return [piece]
        text, out, prev = piece.text, [], 0
        for m in regex.finditer(text):
            tok = self._by_text[(normalized, m.group())]
            start, stop = m.span()
            if tok.get("single_word"):
                before = text[start - 1] if start else ""
                after = text[stop] if stop < len(text) else ""
                if (before and (before.isalnum() or before == "_")) or \
                        (after and (after.isalnum() or after == "_")):
                    continue
            if tok.get("lstrip"):
                while start > prev and _is_whitespace(text[start - 1]):
                    start -= 1
            if tok.get("rstrip"):
                while stop < len(text) and _is_whitespace(text[stop]):
                    stop += 1
            if start > prev:
                out.append(Piece(text[prev:start], piece.first and prev == 0))
            out.append(Piece(text[start:stop], piece.first and start == 0, tok["id"]))
            prev = stop
        if prev < len(text):
            out.append(Piece(text[prev:], piece.first and prev == 0))
        return out

    def tokenize_ids(self, text: str) -> list:
        """The ids of ``text`` without the post-processor's special tokens."""
        pieces = self._extract(Piece(text, True), False)
        normed = []
        for p in pieces:
            if p.token is None:
                p = Piece(normalize(self.normalizer, p.text), p.first)
                normed += self._extract(p, True)
            else:
                normed.append(p)
        ids = []
        for p in normed:
            if p.token is not None:
                ids.append(p.token)
            elif p.text:
                for word in pre_tokenize(self.pre_tokenizer, [p]):
                    ids += self.model.tokenize(word.text)
        return ids

    def _truncate(self, a: list, b: Optional[list], max_length: int):
        """tokenizers' ``truncate_encodings``, strategy longest_first."""
        cut = (lambda s, n: s[:n]) if self.truncation_side == "right" else \
            (lambda s, n: s[len(s) - n:] if n < len(s) else s)
        if b is None:
            return cut(a, max_length), None
        if len(a) + len(b) <= max_length:
            return a, b
        n1, n2 = len(a), len(b)
        swap = n1 > n2
        if swap:
            n1, n2 = n2, n1
        n2 = n1 if n1 > max_length else max(n1, max_length - n1)
        if n1 + n2 > max_length:
            n1 = max_length // 2
            n2 = n1 + max_length % 2
        if swap:
            n1, n2 = n2, n1
        return cut(a, n1), cut(b, n2)

    def encode(self, text: str, pair: Optional[str] = None, *, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> list:
        a = self.tokenize_ids(text)
        b = self.tokenize_ids(pair) if pair is not None else None
        if max_length is not None:
            extra = added_count(self.post_processor, b is not None) if add_special_tokens else 0
            if max_length >= extra:  # else tokenizers leaves both as they are
                a, b = self._truncate(a, b, max_length - extra)
        return post_process(self.post_processor, a, b) if add_special_tokens else a + (b or [])

    def encode_batch(self, texts: Sequence[str], pairs: Optional[Sequence[str]] = None,
                     max_length: int = 128):
        """Padded to ``max_length`` with the longest-first truncation; (ids,
        attention mask) int32 arrays, as ``padding="max_length",
        truncation=True``."""
        if self.pad_token is None:
            raise ValueError("Asking to pad but the tokenizer does not have a padding token.")
        out_ids, out_mask = [], []
        for i, t in enumerate(texts):
            ids = self.encode(t, pairs[i] if pairs is not None else None, max_length=max_length)
            pad = [self.pad_token_id] * (max_length - len(ids))
            mask = [1] * len(ids)
            if self.padding_side == "right":
                ids, mask = ids + pad, mask + [0] * len(pad)
            else:
                ids, mask = pad + ids, [0] * len(pad) + mask
            out_ids.append(ids)
            out_mask.append(mask)
        return np.asarray(out_ids, np.int32), np.asarray(out_mask, np.int32)

    def encode_ids(self, text: str, add_bos: bool = True) -> list:
        """``tok(text, add_special_tokens=add_bos)["input_ids"]``: the whole
        post-processor (RoBERTa's template adds ``</s>`` as well)."""
        return self.encode(text, add_special_tokens=add_bos)

    def decode(self, ids) -> str:
        """``decode(ids, skip_special_tokens=True)``; unknown ids are dropped."""
        tokens = []
        for i in ids:
            i = int(i)
            if i in self.special_ids:
                continue
            tok = self.id_to_added[i]["content"] if i in self.id_to_added else \
                self.id_to_token.get(i)
            if tok is not None:
                tokens.append(tok)
        text = "".join(decode_chain(self.decoder, tokens)) if self.decoder else " ".join(tokens)
        return clean_up_tokenization(text) if self.clean_up else text


# -- a byte-fallback BPE learned from text, written as an HF directory ----------

LLAMA_SPECIALS = ("<unk>", "<s>", "</s>")


def learn_merges(texts: Sequence[str], n_merges: int) -> list:
    """BPE merges over the Llama-normalized words of ``texts`` ("▁" for each
    space, one before the text; a word runs from one "▁" to the next): the
    most frequent adjacent pair first, ties to the smaller pair."""
    words: dict[tuple, int] = {}
    for text in texts:
        for w in re.findall("▁[^▁]*|[^▁]+", "▁" + text.replace(" ", "▁")):
            words[tuple(w)] = words.get(tuple(w), 0) + 1
    merges = []
    for _ in range(n_merges):
        pairs: dict[tuple, int] = {}
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] = pairs.get(pair, 0) + n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        if pairs[best] < 2:
            break
        merges.append(best)
        merged = {}
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        words = merged
    return merges


def write_byte_fallback_bpe(path: str, texts: Sequence[str], vocab_size: int = 32000,
                            n_merges: int = 400) -> dict:
    """Write a Llama-2-style ``tokenizer.json`` and ``tokenizer_config.json``
    into ``path``, with no tokenizer package: ``<unk>``, ``<s>``, ``</s>``,
    the 256 ``<0xNN>`` byte tokens, the characters of ``texts`` and the
    tokens of up to ``n_merges`` merges learned from them, padded with
    ``<unused_N>`` entries (which no merge reaches) to exactly
    ``vocab_size``.  Returns the tokenizer.json object."""
    merges = learn_merges(texts, n_merges)
    vocab = {t: i for i, t in enumerate([*LLAMA_SPECIALS, *(f"<0x{b:02X}>" for b in range(256))])}
    chars = sorted({c for text in texts for c in "▁" + text.replace(" ", "▁")})
    for tok in [*chars, *(a + b for a, b in merges)]:
        vocab.setdefault(tok, len(vocab))
    if len(vocab) > vocab_size:
        raise ValueError(f"{len(vocab)} tokens do not fit a vocabulary of {vocab_size}")
    while len(vocab) < vocab_size:
        vocab[f"<unused_{len(vocab)}>"] = len(vocab)
    bos = {"SpecialToken": {"id": "<s>", "type_id": 0}}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(LLAMA_SPECIALS)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    config = {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
              "unk_token": "<unk>", "pad_token": None, "add_bos_token": True,
              "add_eos_token": False, "clean_up_tokenization_spaces": False, "legacy": True,
              "padding_side": "right"}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f)
    return spec
