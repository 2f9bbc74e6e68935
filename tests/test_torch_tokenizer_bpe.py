"""The port's local BPE tokenizer (``data/hf_tokenizer.py`` through
``data/tokenizer.get_tokenizer``) against the JAX ``get_tokenizer``, which
loads the same directory with ``transformers``' ``AutoTokenizer``.

Each ``tokenizer.json`` is built here with ``tokenizers``, trained on a
small corpus: Llama-2 style (``Prepend`` + ``Replace`` normalizer, byte
fallback, ``Replace``/``ByteFallback``/``Fuse``/``Strip`` decoder), the
``Metaspace`` pre-tokenizer (prepend scheme "first" and "always"), GPT-2
byte-level, RoBERTa (its template, a ``<mask>`` that strips left) and a
Qwen2-style ``Split`` regex under ``NFC``, and Llama-3's (``ignore_merges``,
a post-processor ``Sequence``).  The 256 ``<0xNN>`` tokens are
written into the byte-fallback vocabularies by hand: a ``BpeTrainer`` given
them as its ``initial_alphabet`` does not add them, and "é!" then encodes
to ``<unk>`` and decodes to nothing.

Ids, attention masks and decodes are compared exactly over fixed texts,
texts drawn by hypothesis (non-ASCII, whitespace runs, special tokens in
the text) and pairs longer than ``max_length``.
"""

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors
from tokenizers import trainers

from sparse_matrix_fine_tuning_torch.data import tokenizer as ttok
from sparse_matrix_fine_tuning_torch.data.hf_tokenizer import BPETokenizer
from sparse_matrix_fine_tuning_tpu.data import tokenizer as jtok

CORPUS = [
    "Hello world, this is a test of the tokenizer.",
    "The quick brown fox jumps over the lazy dog!  Twice.",
    "naïve café — déjà vu; Ünïcödé façade",
    "日本語のテキストと中文的文本",
    "I'm sure it's 1234 or 56,789.\nNew line\ttab",
    "Question: what is 12 + 30? Answer: 42",
    "    indented code():\n        return x_1 ** 2",
] * 4
TEXTS = [
    "Hello world!",
    "  leading spaces and trailing  ",
    "naïve café, déjà vu — 日本語 ü",
    "Emoji 🙂 and math ∑ x² ½ Ⅻ",
    "<s>starts with a special</s> and </s>ends",
    "line one\nline two\r\n\ttabbed   gaps",
    "I'M SURE IT'S, they'll we've you'd",
    "",
    " ",
    "é!",
    "x" * 300,
]
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+"
              r"[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
BYTES = [f"<0x{i:02X}>" for i in range(256)]


def _byte_fallback_bpe(normalizer, pre_tokenizer, decoder, vocab_size=400):
    """A SentencePiece-style BPE: <unk>, <s>, </s>, the 256 byte tokens,
    then the trained merges' tokens, with byte_fallback."""
    base = Tokenizer(models.BPE(unk_token="<unk>"))
    base.normalizer, base.pre_tokenizer = normalizer, pre_tokenizer
    base.train_from_iterator(CORPUS, trainers.BpeTrainer(vocab_size=vocab_size,
                                                         special_tokens=["<unk>"]))
    learned = json.loads(base.to_str())["model"]
    vocab = {t: i for i, t in enumerate(["<unk>", "<s>", "</s>"] + BYTES)}
    for t, _ in sorted(learned["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(t, len(vocab))
    merges = [tuple(m) for m in learned["merges"]]
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>", fuse_unk=True,
                               byte_fallback=True))
    tok.normalizer, tok.pre_tokenizer, tok.decoder = normalizer, pre_tokenizer, decoder
    tok.add_special_tokens(["<unk>", "<s>", "</s>"])
    return tok


def llama2():
    tok = _byte_fallback_bpe(
        normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")]), None,
        decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
                           decoders.Strip(" ", 1, 0)]))
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", 1)])
    return tok, {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
                 "unk_token": "<unk>", "pad_token": "<unk>", "padding_side": "right",
                 "legacy": True, "clean_up_tokenization_spaces": False}


def metaspace(scheme):
    def build():
        meta = dict(replacement="▁", prepend_scheme=scheme, split=scheme == "always")
        tok = _byte_fallback_bpe(None, pre_tokenizers.Metaspace(**meta), decoders.Metaspace(**meta))
        tok.post_processor = processors.TemplateProcessing(
            single="<s> $A </s>", pair="<s> $A </s> $B </s>",
            special_tokens=[("<s>", 1), ("</s>", 2)])
        return tok, {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
                     "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "</s>"}
    return build


def _byte_level(pre_tokenizer, normalizer=None, specials=("<|endoftext|>",), size=500):
    tok = Tokenizer(models.BPE())
    tok.normalizer, tok.pre_tokenizer = normalizer, pre_tokenizer
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=size, special_tokens=list(specials),
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tok


def gpt2():
    tok = _byte_level(pre_tokenizers.ByteLevel(add_prefix_space=False))
    tok.post_processor = processors.ByteLevel(trim_offsets=True)
    return tok, {"tokenizer_class": "GPT2Tokenizer", "pad_token": "<|endoftext|>",
                 "clean_up_tokenization_spaces": True}


def roberta():
    tok = _byte_level(pre_tokenizers.ByteLevel(add_prefix_space=False),
                      specials=("<s>", "<pad>", "</s>", "<unk>"))
    tok.add_special_tokens([__import__("tokenizers").AddedToken("<mask>", lstrip=True)])
    tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
    return tok, {"tokenizer_class": "RobertaTokenizer", "add_prefix_space": False,
                 "clean_up_tokenization_spaces": False}


def qwen2():
    tok = _byte_level(pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
        normalizer=normalizers.NFC(), specials=("<|endoftext|>", "<|im_start|>", "<|im_end|>"))
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return tok, {"tokenizer_class": "Qwen2Tokenizer", "errors": "replace",
                 "clean_up_tokenization_spaces": False}


LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+"
                r"[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def llama3():
    """Llama-3 style: its split regex, a whole word in the vocabulary taken
    as it is (``ignore_merges``), the post-processor a Sequence of ByteLevel
    and a BOS template."""
    tok = _byte_level(pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
        specials=("<|begin_of_text|>", "<|end_of_text|>"))
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                      pair="<|begin_of_text|> $A <|begin_of_text|> $B",
                                      special_tokens=[("<|begin_of_text|>", 0)])])
    spec = json.loads(tok.to_str())
    spec["model"]["ignore_merges"] = True
    return Tokenizer.from_str(json.dumps(spec)), {
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<|begin_of_text|>",
        "eos_token": "<|end_of_text|>", "pad_token": "<|end_of_text|>",
        "clean_up_tokenization_spaces": True}


BUILDERS = {"llama2": llama2, "llama3": llama3, "metaspace_first": metaspace("first"),
            "metaspace_always": metaspace("always"), "gpt2": gpt2, "roberta": roberta,
            "qwen2": qwen2}


def write_dir(path, name):
    tok, config = BUILDERS[name]()
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    out = {}
    for name in BUILDERS:
        d = write_dir(tmp_path_factory.mktemp(name), name)
        out[name] = (ttok.get_tokenizer(d), jtok.get_tokenizer(d))
    return out


def check_same(port, ref, texts, max_length=24):
    assert isinstance(port, BPETokenizer) and isinstance(ref, jtok.HFTokenizerWrapper)
    for text in texts:
        for add in (True, False):
            got = port.encode_ids(text, add_bos=add)
            want = ref.encode_ids(text, add_bos=add)
            assert got == want, (text, add)
        ids = ref.encode_ids(text)
        assert port.decode(ids) == ref.decode(ids), text
        assert port.decode(ids[1:-1]) == ref.decode(ids[1:-1]), text
    if ref.tok.pad_token is not None:
        got = port.encode_batch(texts, max_length=max_length)
        want = ref.encode_batch(texts, max_length=max_length)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        rev = list(reversed(texts))
        for n in (max_length, 7, 3):
            try:
                want = ref.encode_batch(texts, rev, max_length=n)
            except ValueError:  # ragged: max_length under the template's tokens
                with pytest.raises(ValueError):
                    port.encode_batch(texts, rev, max_length=n)
                continue
            got = port.encode_batch(texts, rev, max_length=n)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_torch_bpe_tokenizer_matches_transformers(pairs, name):
    port, ref = pairs[name]
    check_same(port, ref, TEXTS + CORPUS[:7])
    assert (port.pad_token_id, port.bos_token_id, port.eos_token_id, port.vocab_size) == \
        (ref.pad_token_id, ref.bos_token_id, ref.eos_token_id, ref.vocab_size)


TEXT = st.text(st.characters(blacklist_categories=("Cs",)), max_size=40) | st.lists(
    st.sampled_from(["Hello", " ", "  ", "\n", "é", "日本", "'s", "<s>", "</s>", "<|endoftext|>",
                     "<mask>", "<|im_end|>", "12", "3.5", "▁", "🙂", "\t", "x²", "Ⅻ", "ǅ",
                     "́", " ", " ", "\x1c"]), max_size=12).map("".join)


@pytest.mark.parametrize("name", list(BUILDERS))
@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(TEXT, min_size=1, max_size=3))
def test_torch_bpe_tokenizer_matches_transformers_on_drawn_text(pairs, name, texts):
    port, ref = pairs[name]
    check_same(port, ref, texts, max_length=12)


def _same_on(path, texts=TEXTS):
    port, ref = ttok.get_tokenizer(str(path)), jtok.get_tokenizer(str(path))
    check_same(port, ref, texts)
    assert (port.pad_token_id, port.bos_token_id, port.eos_token_id, port.vocab_size) == \
        (ref.pad_token_id, ref.bos_token_id, ref.eos_token_id, ref.vocab_size)
    return port, ref


def test_torch_bpe_reads_string_merges(tmp_path):
    """Older files write each merge as "a b"; tokenizers 0.22 writes pairs."""
    path = tmp_path / "gpt2"
    write_dir(path, "gpt2")
    spec = json.loads((path / "tokenizer.json").read_text())
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    (path / "tokenizer.json").write_text(json.dumps(spec))
    _same_on(path)


def test_torch_bpe_class_from_model_type_and_special_tokens_map(tmp_path):
    """No tokenizer class in tokenizer_config.json: ``config.json``'s
    model_type picks it (GPT-2's special defaults); special_tokens_map.json
    overrides the config's pad token."""
    path = tmp_path / "gpt2"
    write_dir(path, "gpt2")
    (path / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 1024}))
    (path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    port, _ = _same_on(path, TEXTS[:4])
    assert port.bos_token_id == port.eos_token_id == 0
    (path / "special_tokens_map.json").write_text(json.dumps(
        {"pad_token": {"content": "<|endoftext|>", "lstrip": False, "rstrip": False,
                       "normalized": False, "single_word": False}}))
    port, _ = _same_on(path)
    assert port.pad_token_id == 0


def test_torch_bpe_llama_template_from_config(tmp_path):
    """LlamaTokenizerFast rebuilds the post-processor from add_bos_token and
    add_eos_token; a non-special added token (normalized) and one that
    strips right are split out of the text."""
    path = tmp_path / "llama"
    tok, config = llama2()
    from tokenizers import AddedToken
    tok.add_tokens([AddedToken("qu ick", normalized=True), AddedToken("<tool>", rstrip=True,
                                                                     normalized=False)])
    path.mkdir()
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {**config, "add_bos_token": True, "add_eos_token": True}))
    port, _ = _same_on(path, TEXTS + ["the qu ick fox", "a <tool>   call <tool>x"])
    ids = port.encode_ids("Hello")
    assert ids[0] == port.bos_token_id and ids[-1] == port.eos_token_id


def test_torch_get_tokenizer_refuses_other_models(tmp_path):
    """WordPiece (BLIP's BERT), Unigram (DeBERTa-v3) and a directory with a
    ``tokenizer.model`` alone raise NotImplementedError citing item 13,
    where the JAX function would fall back to the hash tokenizer."""
    from tokenizers import models as tmodels
    wp = tmp_path / "wordpiece"
    wp.mkdir()
    Tokenizer(tmodels.WordPiece({"[UNK]": 0, "a": 1}, unk_token="[UNK]")).save(
        str(wp / "tokenizer.json"))
    uni = tmp_path / "unigram"
    uni.mkdir()
    Tokenizer(tmodels.Unigram([("<unk>", 0.0), ("a", -1.0)], 0)).save(str(uni / "tokenizer.json"))
    spm = tmp_path / "spm"
    spm.mkdir()
    (spm / "tokenizer.model").write_bytes(b"\x00")
    for path in (wp, uni, spm):
        with pytest.raises(NotImplementedError, match="item 13"):
            ttok.get_tokenizer(str(path))


def test_torch_written_byte_fallback_bpe_matches_transformers(tmp_path):
    """``write_byte_fallback_bpe`` (the tokenizer ``chip_smoke.py`` writes
    into its TinyLlama-width directory): exactly ``vocab_size`` entries,
    transformers reads it as the port does, and decode(encode(text)) gives
    each text without special tokens back, unseen characters through the
    byte tokens (a special token in the text is skipped by the decode)."""
    from sparse_matrix_fine_tuning_torch.data.hf_tokenizer import write_byte_fallback_bpe

    spec = write_byte_fallback_bpe(str(tmp_path), CORPUS, vocab_size=3000, n_merges=200)
    assert len(spec["model"]["vocab"]) == 3000 and len(spec["model"]["merges"]) > 50
    port, ref = _same_on(tmp_path, TEXTS + CORPUS[:7])
    assert port.vocab_size == 3000 and port.pad_token_id == 0
    for text in TEXTS + CORPUS[:7]:
        ids = port.encode_ids(text)
        assert max(ids) < 3000
        assert port.decode(ids) == text or "<s>" in text
