"""The port's ``tokenizer.json`` reader against the JAX package's
``HFTokenizer`` (the ``tokenizers`` runtime) on CPU.

Four files built here with ``tokenizers``: the JAX ``train_bpe``'s
byte-level BPE; a Qwen2-style one (NFC, ``Split`` by Qwen2's regex, then
``ByteLevel(use_regex=False)``, special tokens); a Llama-2-style one
(``Prepend``/``Replace`` normalizers, ``byte_fallback`` and ``fuse_unk``,
the ``Replace``/``ByteFallback``/``Fuse``/``Strip`` decoder); and a
Metaspace one (pre-tokenizer and decoder, ``prepend_scheme="first"``,
unknown characters as ``<unk>``). On each:
``encode`` equal id for id on the synthetic reports and on strings with
``½ ² Ⅻ``, combining marks, CJK, emoji, tabs, ``\\r\\n`` and runs of
spaces; ``decode`` equal string for string on those ids and on random ids
that include specials and ids past the vocabulary; the special ids and
the vocabulary size equal. Also the committed report tokenizer
(``tests/data/report_bpe_tokenizer.json``) and the refusal of a
component the reader does not take. Tolerance: exact.
"""

import json

import numpy as np
import pytest

from medical_image_analysis_tpu.data.hf_tokenizer import (
    HFTokenizer as JaxHFTokenizer,
)
from medical_image_analysis_tpu_torch.data.datasets import (
    synthetic_annotations,
)
from medical_image_analysis_tpu_torch.data.hf_tokenizer import (
    HFTokenizer,
    translate_regex,
)

tokenizers = pytest.importorskip("tokenizers")

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                 r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

HARD = [
    "½ ² Ⅻ ⅷ 3½ x²",
    "café naïve Å (Å)",
    "肺部清晰，无胸腔积液。 心影大小正常",
    "emoji 😀👍🏽 ok 🫁",
    "tabs\there\t\tand\r\nwindows\r\n\r\nlines\n",
    "runs   of    spaces     end  ",
    "  leading and trailing  ",
    "It's THEY'RE we'll I'd you've 12345 3.14 1e-5",
    "<s> a special inside </s> text <|endoftext|>",
    "",
    " ",
    " nbsp em　ideographic",
]


def _corpus():
    ann = synthetic_annotations()
    return [s.report for split in ("train", "val", "test")
            for s in ann[split]]


def _train(tok, vocab, specials, alphabet=None, limit=None):
    from tokenizers.trainers import BpeTrainer

    kw = {"initial_alphabet": alphabet} if alphabet else {}
    if limit:
        kw["limit_alphabet"] = limit
    tok.train_from_iterator(_corpus() * 4 + HARD[:6],
                            BpeTrainer(vocab_size=vocab,
                                       special_tokens=specials, **kw))
    return tok


def _qwen_style():
    from tokenizers import (
        Regex,
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
    )

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    return _train(tok, 420, ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                  alphabet=pre_tokenizers.ByteLevel.alphabet())


def _llama_style():
    from tokenizers import (
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
    )

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    _train(tok, 300, ["<unk>", "<s>", "</s>"], limit=40)
    spec = json.loads(tok.to_str())
    # Llama-2's layout: byte tokens <0x00>..<0xFF> in the model vocabulary
    # after the specials, byte fallback, no pre-tokenizer
    old = spec["model"]["vocab"]
    vocab = {t: i for t, i in old.items() if i < 3}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for t, i in sorted(old.items(), key=lambda kv: kv[1]):
        if i >= 3:
            vocab[t] = len(vocab)
    spec["model"].update(vocab=vocab, byte_fallback=True, fuse_unk=True)
    spec["added_tokens"] = [dict(a, id=vocab[a["content"]])
                            for a in spec["added_tokens"]]
    spec["pre_tokenizer"] = None
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    return tok


def _metaspace_style():
    """The newer Llama layout: a Metaspace pre-tokenizer and decoder, and
    an alphabet cut short, so that unknown characters meet ``<unk>``."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    tok.decoder = decoders.Metaspace(prepend_scheme="first")
    return _train(tok, 300, ["<unk>", "<s>", "</s>"], limit=40)


@pytest.fixture(scope="module",
                params=["train_bpe", "qwen2", "llama2", "metaspace"])
def pair(request, tmp_path_factory):
    if request.param == "train_bpe":
        raw = JaxHFTokenizer.train_bpe(_corpus() * 4 + HARD[:6],
                                       vocab_size=400)._tok
    elif request.param == "qwen2":
        raw = _qwen_style()
    elif request.param == "llama2":
        raw = _llama_style()
    else:
        raw = _metaspace_style()
    path = str(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    raw.save(path)
    return request.param, JaxHFTokenizer.from_file(path), \
        HFTokenizer.from_file(path)


def test_specials_and_vocab(pair):
    _, want, got = pair
    for k in ("BOS", "EOS", "PAD", "UNK"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.vocab_size == want.vocab_size


def test_encode_matches(pair):
    name, want, got = pair
    for text in _corpus()[:12] + HARD:
        assert got.encode(text) == want.encode(text), (name, text)
    assert got.encode(HARD[4], max_len=5, add_bos=True, add_eos=True) == \
        want.encode(HARD[4], max_len=5, add_bos=True, add_eos=True)
    assert got.pad([5, 6], 4) == want.pad([5, 6], 4)


def test_decode_matches(pair):
    name, want, got = pair
    for text in _corpus()[:6] + HARD:
        ids = want.encode(text)
        assert got.decode(ids) == want.decode(ids), (name, text)
        assert got.decode_raw(ids) == want._tok.decode(ids), (name, text)
    rng = np.random.default_rng(0)
    v = want.vocab_size
    for _ in range(40):
        # ids past the vocabulary too, as a wider LLM emits them
        ids = rng.integers(0, v + 60, size=int(rng.integers(1, 24))).tolist()
        assert got.decode(ids) == want.decode(ids), (name, ids)
        assert got.decode_raw(ids) == want._tok.decode(ids), (name, ids)


def test_report_tokenizer_file():
    """The committed ``train_bpe`` file that the card phases serve with."""
    path = "tests/data/report_bpe_tokenizer.json"
    want, got = JaxHFTokenizer.from_file(path), HFTokenizer.from_file(path)
    assert got.vocab_size == want.vocab_size <= 4096
    for text in _corpus()[:8] + HARD[:4]:
        ids = want.encode(text)
        assert got.encode(text) == ids
        assert got.decode(ids) == want.decode(ids)


def test_letter_class_is_not_word_minus_digits():
    import re

    letters = re.compile(translate_regex(r"\p{L}+"))
    numbers = re.compile(translate_regex(r"\p{N}"))
    assert letters.fullmatch("abcÅé肺") and not letters.search("½Ⅻ²1_")
    assert all(numbers.fullmatch(c) for c in "½Ⅻ²1")
    assert re.fullmatch(r"[^\W\d_]", "½")  # what the trap would take


def test_unknown_component_refused(tmp_path):
    from tokenizers import Tokenizer, models, normalizers

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.Lowercase()
    spec = json.loads(tok.to_str())
    with pytest.raises(ValueError, match="Lowercase"):
        HFTokenizer(spec)
