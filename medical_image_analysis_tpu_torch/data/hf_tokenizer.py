"""The port's own reader of HF ``tokenizer.json`` files (no ``tokenizers``).

Counterpart of ``medical_image_analysis_tpu/data/hf_tokenizer.py``, which
wraps the ``tokenizers`` runtime. :class:`HFTokenizer` has the JAX class's
interface (``BOS``, ``EOS``, ``PAD`` = eos unless a pad token is named,
``UNK``, ``vocab_size``, ``encode`` without special tokens, ``pad``,
``decode``) and computes what the runtime computes for the components that
Llama-2's and Qwen1.5's files and the JAX ``HFTokenizer.train_bpe`` use:

- the BPE model: merges as ``"a b"`` strings or as pairs, ``unk_token``,
  ``fuse_unk``, ``byte_fallback``;
- normalizers ``NFC``, ``Prepend``, ``Replace`` and ``Sequence``;
- pre-tokenizers ``ByteLevel`` (with and without its regex), ``Split``
  (a string or a regex; ``Isolated`` or ``MergedWithNext``),
  ``Metaspace`` and ``Sequence``;
- added and special tokens, matched before the model: those not
  ``normalized`` on the raw text, then the others on each normalized piece
  (leftmost, longest first);
- decoders ``ByteLevel``, ``Replace``, ``ByteFallback``, ``Fuse``,
  ``Strip``, ``Metaspace`` and ``Sequence``. ``decode`` skips special
  tokens and ids that the file does not know, as the runtime does (a
  random LLM wider than the tokenizer emits such ids).

Any other component or option raises ``ValueError`` naming it; none is
approximated.
The regexes of the GPT-2 and Qwen2 pre-tokenizers use ``\\p{L}`` and
``\\p{N}``, which Python's ``re`` lacks: they are rewritten into classes
built from ``unicodedata`` categories (``[^\\W\\d_]`` is not ``\\p{L}``:
it also takes ``No`` and ``Nl`` characters such as ``½`` and ``Ⅻ``), and
``\\s`` into the Unicode White_Space set.

:meth:`HFTokenizer.train_bpe` trains the JAX ``train_bpe``'s byte-level BPE
in pure Python (the card's machine has no ``tokenizers``), computing what
``tokenizers``' ``BpeTrainer`` computes for its settings (:func:`train_bpe_spec`);
:meth:`HFTokenizer.save` writes the ``tokenizer.json`` that both this reader
and ``tokenizers`` read.
"""

from __future__ import annotations

import collections
import functools
import heapq
import json
import re
import sys
import unicodedata
from typing import Iterable

# Unicode White_Space, the set Oniguruma's \s takes
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                "\u202f\u205f\u3000")
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                 r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


@functools.lru_cache(maxsize=None)
def _category_class(prop: str) -> str:
    """The ranges (class contents, no brackets) of every code point whose
    general category is ``prop`` (two letters) or starts with it (one)."""
    if not re.fullmatch(r"[A-Z][a-z]?", prop):
        raise ValueError(f"tokenizer regex: unsupported property \\p{{{prop}}}")
    parts, start = [], None
    for cp in range(sys.maxunicode + 2):
        hit = cp <= sys.maxunicode and unicodedata.category(
            chr(cp)).startswith(prop)
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            parts.append(_esc(start) if cp - 1 == start
                         else f"{_esc(start)}-{_esc(cp - 1)}")
            start = None
    return "".join(parts)


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of the HF files -> a Python ``re`` pattern:
    ``\\p{X}`` and ``\\P{X}`` as category classes, ``\\s`` and ``\\S`` as
    the White_Space set; everything else as it is."""
    out, i, depth = [], 0, 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{(\w+)\}", pattern[i + 2:])
                if not m:
                    raise ValueError(f"tokenizer regex: bad escape at {i}")
                body = _category_class(m.group(1))
                i += 2 + m.end()
                if depth and e == "P":
                    raise ValueError("tokenizer regex: \\P inside a class")
                out.append(body if depth else
                           f"[{'^' if e == 'P' else ''}{body}]")
                continue
            if e in "sS":
                if depth and e == "S":
                    raise ValueError("tokenizer regex: \\S inside a class")
                out.append(_WHITE_SPACE if depth else
                           f"[{'^' if e == 'S' else ''}{_WHITE_SPACE}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not depth:
            depth = 1
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":  # a literal ] first in a class
                out.append("\\]")
                i += 1
            continue
        if c == "]" and depth:
            depth = 0
        out.append(c)
        i += 1
    return "".join(out)


def _pattern(spec: dict) -> re.Pattern:
    if "Regex" in spec:
        return re.compile(translate_regex(spec["Regex"]))
    return re.compile(re.escape(spec["String"]))


@functools.lru_cache(maxsize=None)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=None)
def _unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in _bytes_to_unicode().items()}


# normalizers -------------------------------------------------------------

def _normalizer(spec: dict | None):
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]
        return lambda s: functools.reduce(lambda acc, f: f(acc), steps, s)
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda _: content, s)
    raise ValueError(f"tokenizer.json: normalizer {kind!r} is not supported")


# pre-tokenizers: [(piece, starts the original text)] -> the same ------------

def _split(s: str, pattern: re.Pattern, behavior: str) -> list[tuple[int, int]]:
    """tokenizers' ``NormalizedString::split``: spans of ``s``, each match
    its own span (``Isolated``) or joined to the span after it
    (``MergedWithNext``, Metaspace's)."""
    spans, prev = [], 0
    for m in pattern.finditer(s):
        if m.start() != prev:
            spans.append(((prev, m.start()), False))
        spans.append(((m.start(), m.end()), True))
        prev = m.end()
    if prev != len(s):
        spans.append(((prev, len(s)), False))
    out: list[list] = []
    if behavior == "Isolated":
        out = [[a, b] for (a, b), _ in spans]
    elif behavior == "MergedWithNext":
        last = False
        for (a, b), hit in reversed(spans):
            if hit and not last and out:
                out[-1][0] = a
            else:
                out.append([a, b])
            last = hit
        out.reverse()
    else:
        raise ValueError(f"tokenizer.json: Split behavior {behavior!r} is "
                         "not supported")
    return [(a, b) for a, b in out if b > a]


def _pre_tokenizer(spec: dict | None):
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]
        return lambda pieces: functools.reduce(lambda acc, f: f(acc), steps,
                                               pieces)
    if kind == "Split":
        pat, behavior = _pattern(spec["pattern"]), spec["behavior"]
        if spec.get("invert"):
            raise ValueError("tokenizer.json: an inverted Split is not "
                             "supported")

        def split(pieces):
            return [(s[a:b], first and a == 0) for s, first in pieces
                    for a, b in _split(s, pat, behavior)]
        return split
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", True)
        pat = (re.compile(translate_regex(_GPT2_PATTERN))
               if spec.get("use_regex", True) else None)
        table = _bytes_to_unicode()

        def byte_level(pieces):
            out = []
            for s, first in pieces:
                if prefix and not s.startswith(" "):
                    s = " " + s
                spans = _split(s, pat, "Isolated") if pat else [(0, len(s))]
                for a, b in spans:
                    out.append(("".join(table[x] for x in
                                        s[a:b].encode("utf-8")),
                                first and a == 0))
            return out
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        do_split = spec.get("split", True)
        sep = re.compile(re.escape(rep))

        def metaspace(pieces):
            out = []
            for s, first in pieces:
                s = s.replace(" ", rep)
                if not s.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and first)):
                    s = rep + s
                spans = (_split(s, sep, "MergedWithNext") if do_split
                         else [(0, len(s))])
                out += [(s[a:b], first and a == 0) for a, b in spans]
            return out
        return metaspace
    raise ValueError(f"tokenizer.json: pre_tokenizer {kind!r} is not "
                     "supported")


# decoders: [token] -> [token] -------------------------------------------

def _byte_fallback(tokens: list[str]) -> list[str]:
    out, pending = [], []

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pending))
            pending.clear()

    for t in tokens:
        m = re.fullmatch(r"<0x([0-9A-Fa-f]{2})>", t)
        if m:
            pending.append(int(m.group(1), 16))
            continue
        flush()
        out.append(t)
    flush()
    return out


def _strip(token: str, content: str, start: int, stop: int) -> str:
    lo = 0
    while lo < min(start, len(token)) and token[lo] == content:
        lo += 1
    hi, n = len(token), 0
    while n < stop and hi > lo and token[hi - 1] == content:
        hi -= 1
        n += 1
    return token[lo:hi]


def _decoder(spec: dict | None):
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_decoder(d) for d in spec["decoders"]]
        return lambda toks: functools.reduce(lambda acc, f: f(acc), steps,
                                             toks)
    if kind == "ByteLevel":
        table = _unicode_to_bytes()

        def byte_level(tokens):
            data = bytearray()
            for t in tokens:
                if all(c in table for c in t):
                    data.extend(table[c] for c in t)
                else:
                    data.extend(t.encode("utf-8"))
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda toks: [pat.sub(lambda _: content, t) for t in toks]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Strip":
        c, a, b = spec["content"], spec["start"], spec["stop"]
        return lambda toks: [_strip(t, c, a, b) for t in toks]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"

        def metaspace(tokens):
            return ["".join("" if c == rep and i == 0 and scheme != "never"
                            else " " if c == rep else c for c in t)
                    for i, t in enumerate(tokens)]
        return metaspace
    raise ValueError(f"tokenizer.json: decoder {kind!r} is not supported")


# the BPE model ---------------------------------------------------------------

class _BPE:
    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise ValueError(f"tokenizer.json: model {spec.get('type')!r} "
                             "is not supported")
        if spec.get("dropout") not in (None, 0.0):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        self.vocab: dict[str, int] = spec["vocab"]
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks: dict[tuple[str, str], int] = {}
        for r, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks.setdefault((a, b), r)
        self.unk = spec.get("unk_token")
        if self.unk is not None and self.unk not in self.vocab:
            raise ValueError(f"tokenizer.json: unk_token {self.unk!r} is not "
                             "in the vocabulary")
        for opt in ("continuing_subword_prefix", "end_of_word_suffix",
                    "ignore_merges"):
            if spec.get(opt):
                raise ValueError(f"tokenizer.json: BPE {opt} is not "
                                 "supported")
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is None:
            hit = self._tokenize(word)
            if len(self._cache) < 100_000:
                self._cache[word] = hit
        return hit

    def _tokenize(self, word: str) -> list[int]:
        # symbols: [token string, id]; byte-fallback and unk symbols too
        syms: list[list] = []
        unk = self.unk
        pending = False  # an unknown run not yet added
        for s in word:
            if s in self.vocab:
                if pending:
                    syms.append([unk, self.vocab[unk]])
                    pending = False
                syms.append([s, self.vocab[s]])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in s.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    syms += [[c, self.vocab[c]] for c in codes]
                    continue
            if unk is not None:
                if pending and not self.fuse_unk:
                    syms.append([unk, self.vocab[unk]])
                pending = True
        if pending:
            syms.append([unk, self.vocab[unk]])
        while len(syms) > 1:
            best, at = None, -1
            for k in range(len(syms) - 1):
                r = self.ranks.get((syms[k][0], syms[k + 1][0]))
                if r is not None and (best is None or r < best):
                    best, at = r, k
            if best is None:
                break
            a, b = syms[at][0], syms[at + 1][0]
            merged = a + b
            if merged not in self.vocab:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} makes "
                                 f"{merged!r}, which is not in the vocabulary")
            syms[at:at + 2] = [[merged, self.vocab[merged]]]
        return [i for _, i in syms]


# training -----------------------------------------------------------------

_BYTE_LEVEL = {"type": "ByteLevel", "add_prefix_space": True,
               "trim_offsets": True, "use_regex": True}
_SPECIALS = ("<unk>", "<s>", "</s>")


def _merge_word(word: list[int], a: int, b: int, new: int) -> list:
    """Merge every (a, b) of ``word`` (token ids) into ``new``, left to
    right, in place; returns the pair count changes, ``((x, y), +-1)``, as
    ``tokenizers``' ``Word::merge`` lists them."""
    changes = []
    i = 0
    while i < len(word):
        if word[i] == a and i + 1 < len(word) and word[i + 1] == b:
            if i > 0:
                changes += [((word[i - 1], a), -1), ((word[i - 1], new), 1)]
            word[i:i + 2] = [new]
            if i < len(word) - 1:
                changes += [((b, word[i + 1]), -1), ((new, word[i + 1]), 1)]
        i += 1
    return changes


def train_bpe_spec(texts: Iterable[str], vocab_size: int) -> dict:
    """The ``tokenizer.json`` of the JAX ``HFTokenizer.train_bpe``: BPE with
    ``unk_token`` ``<unk>``, ByteLevel pre-tokenizer (``add_prefix_space``)
    and decoder, trained by ``BpeTrainer(vocab_size, special_tokens=[<unk>,
    <s>, </s>], initial_alphabet=ByteLevel.alphabet())``. As the trainer:
    words counted after pre-tokenization; the special tokens, then the
    alphabet sorted by code point; then merges of the most frequent pair,
    ties to the smaller pair of ids, each new token the next id, until the
    vocabulary holds ``vocab_size`` tokens or no pair is left."""
    pre = _pre_tokenizer(_BYTE_LEVEL)
    counts: collections.Counter = collections.Counter()
    for text in texts:
        counts.update(w for w, _ in pre([(text, True)]))
    w2id: dict[str, int] = {}
    id2w: list[str] = []

    def add(token: str) -> int:
        if token not in w2id:
            w2id[token] = len(id2w)
            id2w.append(token)
        return w2id[token]

    for t in _SPECIALS:
        add(t)
    alphabet = set(_bytes_to_unicode().values())
    for w in counts:
        alphabet.update(w)
    for c in sorted(alphabet):
        add(c)
    words = [[w2id[c] for c in w] for w in counts]
    freq = list(counts.values())
    pair_counts: collections.Counter = collections.Counter()
    where: dict = collections.defaultdict(set)
    for i, w in enumerate(words):
        for pair in zip(w, w[1:]):
            pair_counts[pair] += freq[i]
            where[pair].add(i)
    # the trainer's max-heap of (count, pair, positions): the largest count
    # first, then the smaller pair; n orders equal entries by arrival
    heap, n = [], 0
    for pair, pos in where.items():
        heap.append((-pair_counts[pair], pair, n, pos))
        n += 1
    heapq.heapify(heap)
    merges = []
    while len(w2id) < vocab_size and heap:
        neg, pair, _, pos = heapq.heappop(heap)
        count = pair_counts[pair]
        if -neg != count:  # a stale count: back in with the current one
            heapq.heappush(heap, (-count, pair, n, pos))
            n += 1
            continue
        if count < 1:
            break
        new = add(id2w[pair[0]] + id2w[pair[1]])
        merges.append(pair)
        where = collections.defaultdict(set)
        for i in pos:
            for p, change in _merge_word(words[i], pair[0], pair[1], new):
                pair_counts[p] += change * freq[i]
                if change > 0:
                    where[p].add(i)
        for p, ps in where.items():
            if pair_counts[p] > 0:
                heapq.heappush(heap, (-pair_counts[p], p, n, ps))
                n += 1
    added = [{"id": w2id[t], "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for t in _SPECIALS]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": dict(_BYTE_LEVEL), "post_processor": None,
        "decoder": dict(_BYTE_LEVEL),
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": w2id,
                  "merges": [[id2w[a], id2w[b]] for a, b in merges]},
    }


class HFTokenizer:
    """A ``tokenizer.json`` behind the framework's tokenizer interface."""

    def __init__(self, spec: dict, bos: str = "<s>", eos: str = "</s>",
                 pad: str | None = None, unk: str = "<unk>"):
        self.spec = spec
        post = (spec.get("post_processor") or {}).get("type")
        if post not in (None, "ByteLevel", "TemplateProcessing"):
            # encode never adds special tokens, so these two change no id
            raise ValueError(f"tokenizer.json: post_processor {post!r} is "
                             "not supported")
        self.model = _BPE(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decoder = _decoder(spec.get("decoder"))
        self.added = {t["content"]: t for t in spec.get("added_tokens", [])}
        for t in self.added.values():
            for flag in ("single_word", "lstrip", "rstrip"):
                if t.get(flag):
                    raise ValueError(f"tokenizer.json: added token "
                                     f"{t['content']!r} with {flag} is not "
                                     "supported")
        self.added_ids = {t["id"]: t["content"] for t in self.added.values()}
        self.special_ids = {t["id"] for t in self.added.values()
                            if t.get("special")}
        self._matchers = {
            norm: self._matcher([t for t in self.added.values()
                                 if bool(t.get("normalized", True)) == norm])
            for norm in (False, True)}
        self.BOS = self._id_or(bos, 1)
        self.EOS = self._id_or(eos, 2)
        # Llama convention: no pad token, pad = eos; an explicit pad
        # token where the file has one
        pad_id = self.token_to_id(pad) if pad else None
        self.PAD = pad_id if pad_id is not None else self.EOS
        self.UNK = self._id_or(unk, 0)

    @staticmethod
    def _matcher(tokens: list[dict]):
        if not tokens:
            return None
        ordered = sorted(tokens, key=lambda t: -len(t["content"]))
        return re.compile("|".join(re.escape(t["content"]) for t in ordered))

    def _id_or(self, token: str, default: int) -> int:
        i = self.token_to_id(token)
        return i if i is not None else default

    # construction ---------------------------------------------------------

    @classmethod
    def from_file(cls, path: str, **kw) -> "HFTokenizer":
        """Load an HF ``tokenizer.json`` (Llama-2, Qwen1.5, ...)."""
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), **kw)

    load = from_file

    @classmethod
    def train_bpe(cls, texts: Iterable[str],
                  vocab_size: int = 8192) -> "HFTokenizer":
        """A byte-level BPE trained on the corpus (:func:`train_bpe_spec`),
        as the JAX package's ``train_bpe`` trains it with ``tokenizers``."""
        return cls(train_bpe_spec(texts, vocab_size))

    def save(self, path: str) -> None:
        """Write the ``tokenizer.json`` (``tokenizers`` reads it too)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.spec, f, ensure_ascii=False)

    # interface ------------------------------------------------------------

    def token_to_id(self, token: str) -> int | None:
        if token in self.added:
            return self.added[token]["id"]
        return self.model.vocab.get(token)

    def id_to_token(self, i: int) -> str | None:
        if i in self.added_ids:
            return self.added_ids[i]
        return self.model.id_to_token.get(i)

    @property
    def vocab_size(self) -> int:
        return len(set(self.model.vocab) | set(self.added))

    def _find_added(self, s: str, normalized: bool):
        """[(start, end, token id or None)] covering ``s``."""
        matcher = self._matchers[normalized]
        out, prev = [], 0
        if matcher is not None:
            for m in matcher.finditer(s):
                tok = self.added[m.group()]
                a, b = m.start(), m.end()
                if a > prev:
                    out.append((prev, a, None))
                out.append((a, b, tok["id"]))
                prev = b
        if prev < len(s):
            out.append((prev, len(s), None))
        return out

    def _ids(self, text: str) -> list[int]:
        ids = []
        for a, b, tid in self._find_added(text, normalized=False):
            if tid is not None:
                ids.append(tid)
                continue
            piece = self.normalize(text[a:b])
            for c, d, nid in self._find_added(piece, normalized=True):
                if nid is not None:
                    ids.append(nid)
                    continue
                for word, _ in self.pre_tokenize([(piece[c:d],
                                                   a == 0 and c == 0)]):
                    if word:
                        ids += self.model.tokenize(word)
        return ids

    def encode(self, text: str, max_len: int | None = None,
               add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = self._ids(text)
        if add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids = ids + [self.EOS]
        if max_len is not None:
            ids = ids[:max_len]
        return ids

    def pad(self, ids: list[int], max_len: int) -> tuple[list[int], list[int]]:
        mask = [1] * len(ids) + [0] * (max_len - len(ids))
        return ids + [self.PAD] * (max_len - len(ids)), mask

    def decode_raw(self, ids: Iterable[int]) -> str:
        """``tokenizers``' ``decode(ids)``: special tokens and unknown ids
        skipped, the decoder chain (or a space join) over the rest."""
        tokens = []
        for i in ids:
            i = int(i)
            if i in self.special_ids:
                continue
            t = self.id_to_token(i)
            if t is not None:
                tokens.append(t)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))

    def decode(self, ids: Iterable[int]) -> str:
        keep = []
        for i in ids:
            i = int(i)
            if i == self.EOS:
                break
            if i == self.BOS or (i == self.PAD and self.PAD != self.EOS):
                continue
            keep.append(i)
        return self.decode_raw(keep).strip()
