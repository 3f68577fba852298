"""METEOR 1.5 in pure Python, with optional synonym/paraphrase tables.

The reference pipes sentences through ``java -jar meteor-1.5.jar``
(``R2GenCSR/evalcap/meteor/meteor.py:44-52``). This
implementation reproduces the METEOR 1.5 'en' scoring (Denkowski &
Lavie 2014): stage-wise unigram alignment — exact, stem, synonym,
paraphrase — with per-stage match weights (1.0, 0.6, 0.8, 0.6),
content/function word weighting (delta=0.75), weighted harmonic mean
``F = P*R / (alpha*P + (1-alpha)*R)`` and the fragmentation penalty
``gamma * (chunks/matches)^beta``. Default parameters are the original
METEOR values (alpha=0.9, beta=3, gamma=0.5, delta neutral) whose score
magnitudes match the published report-generation tables; the METEOR 1.5
'en'-task tuning (0.85, 0.2, 0.6, 0.75) is selectable via the keyword
arguments.

Synonym and paraphrase stages run by default against the bundled tables
(``data/meteor_synonyms.tsv`` — ``word<TAB>id1 id2 ...`` synset file —
and ``data/meteor_paraphrases.txt`` — ``phrase1|||phrase2`` lines; the
formats the jar's data directory uses). The bundled tables are a
curated radiology-report vocabulary (WordNet is not redistributable
offline here); drop in full jar-exported files via
``MeteorTables.from_files`` for exact jar-table parity. Pass
``tables=None`` to force the exact+stem-only approximation.
"""

from __future__ import annotations

import dataclasses
import functools
import os

ALPHA, BETA, GAMMA = 0.9, 3.0, 0.5
DELTA = 0.5  # neutral content/function weighting; 'en' task uses 0.75
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase

_FUNCTION_WORDS = frozenset(
    "a an the of in on at to for with by from as is are was were be been "
    "being and or but if then than so no not this that these those it its "
    "he she they we you i his her their our your there here".split()
)


@dataclasses.dataclass
class MeteorTables:
    """Optional jar-data tables enabling the synonym/paraphrase stages."""

    synonyms: dict[str, frozenset] | None = None  # word -> synset ids
    paraphrases: dict[tuple, set] | None = None  # phrase -> {phrases}

    @classmethod
    def from_files(cls, synonym_path: str | None = None,
                   paraphrase_path: str | None = None) -> "MeteorTables":
        syn = None
        if synonym_path:
            syn = {}
            with open(synonym_path) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        syn[parts[0].lower()] = frozenset(
                            parts[1].split()
                        )
        para = None
        if paraphrase_path:
            para = {}
            with open(paraphrase_path) as f:
                for line in f:
                    sides = line.rstrip("\n").split("|||")
                    if len(sides) != 2:
                        continue
                    a = tuple(sides[0].strip().lower().split())
                    b = tuple(sides[1].strip().lower().split())
                    if a and b:
                        para.setdefault(a, set()).add(b)
                        para.setdefault(b, set()).add(a)
        return cls(synonyms=syn, paraphrases=para)


# The bundled tables: the port's byte-identical copies of the JAX
# package's ``evalx/data`` files.
_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_DEFAULT = object()  # sentinel: "use the bundled tables"


#: True when the last `default_tables()` call served the bundled curated
#: radiology tables rather than user-supplied (jar-extracted) ones.
using_bundled_tables: bool = True


@functools.lru_cache(maxsize=1)
def default_tables() -> MeteorTables:
    """Synonym/paraphrase tables (loaded once).

    ``MIA_METEOR_TABLES`` may point at a directory produced by
    ``tools/extract_meteor_tables.py`` (jar-extracted WordNet synsets +
    full paraphrase table) for jar-comparable scores; otherwise the
    bundled curated radiology tables are used — self-consistent, but
    NOT comparable to meteor-1.5.jar-scored published numbers.
    """
    global using_bundled_tables
    user_dir = os.environ.get("MIA_METEOR_TABLES")
    if user_dir:
        syn = os.path.join(user_dir, "meteor_synonyms.tsv")
        par = os.path.join(user_dir, "meteor_paraphrases.txt")
        using_bundled_tables = False
        return MeteorTables.from_files(
            syn if os.path.exists(syn) else None,
            par if os.path.exists(par) else None,
        )
    using_bundled_tables = True
    return MeteorTables.from_files(
        os.path.join(_DATA_DIR, "meteor_synonyms.tsv"),
        os.path.join(_DATA_DIR, "meteor_paraphrases.txt"),
    )


def _stem(w: str) -> str:
    for suf in ("ing", "ed", "es", "s"):
        if len(w) > len(suf) + 2 and w.endswith(suf):
            return w[: -len(suf)]
    return w


def _word_weight(w: str, delta: float = DELTA) -> float:
    return delta if w not in _FUNCTION_WORDS else 1.0 - delta


def _align(cand, ref, tables: MeteorTables | None, delta: float = DELTA):
    """Stage-wise greedy alignment. Returns (weighted matches over cand,
    weighted matches over ref, raw match count, chunk count)."""
    match_of = [-1] * len(cand)
    weight_of = [0.0] * len(cand)
    used = [False] * len(ref)

    def try_stage(key_fn, weight):
        keyed = {}
        for j, w in enumerate(ref):
            if used[j]:
                continue
            key = key_fn(w)
            if key is None:
                continue
            for kk in key if isinstance(key, (set, frozenset)) else (key,):
                keyed.setdefault(kk, []).append(j)
        for i, w in enumerate(cand):
            if match_of[i] >= 0:
                continue
            key = key_fn(w)
            if key is None:
                continue
            keys = key if isinstance(key, (set, frozenset)) else (key,)
            for kk in keys:
                slots = keyed.get(kk, [])
                while slots:
                    j = slots.pop(0)
                    if not used[j]:
                        match_of[i] = j
                        weight_of[i] = weight
                        used[j] = True
                        break
                if match_of[i] >= 0:
                    break

    try_stage(lambda w: w, STAGE_WEIGHTS[0])
    try_stage(_stem, STAGE_WEIGHTS[1])
    if tables is not None and tables.synonyms is not None:
        syn = tables.synonyms

        def syn_key(w):
            return syn.get(w)

        try_stage(syn_key, STAGE_WEIGHTS[2])

    # Paraphrase stage: longest-first phrase matches. Greedy exact/stem
    # matching of *function words* inside a phrase must not block it (the
    # jar's search-based aligner would prefer the phrase): spans whose
    # already-matched tokens are all function words release those slots.
    if tables is not None and tables.paraphrases is not None:
        para = tables.paraphrases
        max_len = max((len(k) for k in para), default=1)
        for ln in range(min(max_len, 4), 0, -1):
            for i in range(len(cand) - ln + 1):
                span = range(i, i + ln)
                if any(
                    match_of[t] >= 0 and cand[t] not in _FUNCTION_WORDS
                    for t in span
                ):
                    continue
                phrase = tuple(cand[i : i + ln])
                alts = para.get(phrase)
                if not alts:
                    continue
                freed = [match_of[t] for t in span if match_of[t] >= 0]
                for j in freed:
                    used[j] = False
                for ln2 in range(min(max_len, 4), 0, -1):
                    hit = None
                    for j in range(len(ref) - ln2 + 1):
                        if any(used[j + t] for t in range(ln2)):
                            continue
                        if tuple(ref[j : j + ln2]) in alts:
                            hit = j
                            break
                    if hit is not None:
                        for t in range(ln):
                            match_of[i + t] = hit + min(t, ln2 - 1)
                            weight_of[i + t] = STAGE_WEIGHTS[3]
                        for t in range(ln2):
                            used[hit + t] = True
                        freed = []
                        break
                for j in freed:  # phrase not found: restore
                    used[j] = True

    matches = sum(1 for m in match_of if m >= 0)
    wm_c = sum(
        weight_of[i] * _word_weight(cand[i], delta)
        for i in range(len(cand))
        if match_of[i] >= 0
    )
    wm_r = sum(
        weight_of[i] * _word_weight(ref[match_of[i]], delta)
        for i in range(len(cand))
        if match_of[i] >= 0
    )
    chunks = 0
    prev = None
    for m in match_of:
        if m >= 0:
            if prev is None or m != prev + 1:
                chunks += 1
            prev = m
        else:
            prev = None
    return wm_c, wm_r, matches, chunks


def _sentence_score(cand, ref, tables, alpha, beta, gamma, delta):
    wm_c, wm_r, matches, chunks = _align(cand, ref, tables, delta)
    if matches == 0 or wm_c == 0 or wm_r == 0:
        return 0.0
    w_cand = sum(_word_weight(w, delta) for w in cand)
    w_ref = sum(_word_weight(w, delta) for w in ref)
    p = wm_c / max(w_cand, 1e-9)
    r = wm_r / max(w_ref, 1e-9)
    f = (p * r) / (alpha * p + (1 - alpha) * r)
    frag = chunks / matches if matches > 1 else (1.0 if chunks else 0.0)
    penalty = gamma * frag**beta if matches > 1 else gamma * frag
    return f * (1.0 - penalty)


def meteor(
    gts: dict[str, list[str]],
    res: dict[str, list[str]],
    tables: MeteorTables | None = _DEFAULT,
    alpha: float = ALPHA,
    beta: float = BETA,
    gamma: float = GAMMA,
    delta: float = DELTA,
) -> float:
    if tables is _DEFAULT:
        tables = default_tables()
    scores = []
    for sid, cands in res.items():
        cand = cands[0].lower().split()
        best = 0.0
        for ref_s in gts[sid]:
            best = max(
                best,
                _sentence_score(
                    cand, ref_s.lower().split(), tables, alpha, beta,
                    gamma, delta,
                ),
            )
        scores.append(best)
    return sum(scores) / max(len(scores), 1)
