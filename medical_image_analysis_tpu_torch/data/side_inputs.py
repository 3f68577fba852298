"""Side inputs of AM-MRG, R2GenKG and MAC-RRG: memory banks,
knowledge-graph tensors and the agents' context, loaded from files or
synthesized from the training split.

Counterpart of ``medical_image_analysis_tpu/data/side_inputs.py``
(``make_text_embedder``, ``build_am_banks``, ``_project``,
``_load_array``, ``synthesize_graph_artifacts``, ``load_graph_npz``,
``build_alias_dict``, ``build_relations``, ``MACContext``).
Where no artifact path is given, the chain of the reference's offline
scripts runs on the training split with towers initialised from a seed:

- AM-MRG's visual memory: GradCAM over a small SwinCheX (``utils/cam.py``)
  for each of the 14 labels -> the top CAM tokens of each image -> the
  stage-1 disease tokens and sampled CAM features, projected to the bank
  width; its report memory: the reports' EOS-pooled text embeddings,
  sampled in proportion to their rule labels.
- R2GenKG's graph: the top content words at five granularities, edges
  typed by co-occurrence in a report (0), adjacency (1) and a shared
  CheXpert category (2), padded to a fixed edge count with pad edges at
  the dummy node row; and a disease-token bank of the labels and words.

The JAX package pins this chain to the host CPU; here it runs on the
run's ``device`` (the card, unless the caller asks for the CPU), and
what it returns is numpy. The numpy steps, and their ``default_rng``
draws, are the JAX package's.

MAC-RRG's context is an alias dictionary (CheXpert keywords to their
label, frequent words to themselves), co-occurrence triples, a chunk
corpus of the train reports' sentences and its searcher; its agents
(``agents/``) run in numpy on the host, over embeddings that the embedder
computes on its device and returns as numpy.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Sequence

import numpy as np
import torch

from ..agents.kg_agent import encode_concepts
from ..agents.rag_agent import EntityWiseSearcher, encode_rag
from ..evalx.chexbert import CHEXPERT_LABELS, _KEYWORDS, extract_labels
from ..utils.cam import (
    build_report_memory,
    build_visual_memory,
    extract_cam_features,
    swin_grad_cam,
)
from .tokenizer import WordTokenizer

# The SwinCheX of the visual-memory chain (``build_am_banks``'s default):
# stage 0 has two heads of 8, stage 1 two of 16.
CAM_SWIN = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window_size=4,
                drop_path_rate=0.0)
CAM_CLASSES = 14  # one GradCAM a CheXpert label


def _init(model: torch.nn.Module, seed: int, device, params):
    """``model`` initialised from ``seed`` on ``device``, or loaded from
    ``params`` (a flax-style parameter tree, ``ckpt.from_jax``)."""
    from ..ckpt.from_jax import load_jax_params
    from ..models.common import init_params

    if params is None:
        return init_params(model, torch.Generator(device).manual_seed(seed))
    return load_jax_params(model, params)


def make_text_embedder(
    tok: WordTokenizer,
    dim: int = 64,
    depth: int = 2,
    num_heads: int = 4,
    max_len: int = 64,
    seed: int = 0,
    params=None,
    device="cpu",
) -> Callable[[Sequence[str]], np.ndarray]:
    """EOS-pooled text embedding (the Bio_ClinicalBERT stand-in of the
    report-memory and graph chains): a ``TextEncoder`` initialised from
    ``seed`` unless ``params`` is given. Texts -> (n, dim) fp32."""
    from ..models.text_encoder import TextEncoder

    device = torch.device(device)
    model = TextEncoder(vocab_size=tok.vocab_size, dim=dim, depth=depth,
                        num_heads=num_heads, max_len=max_len, device=device)
    _init(model, seed, device, params)

    def embed(texts: Sequence[str]) -> np.ndarray:
        ids, masks = [], []
        for t in texts:
            i, m = tok.pad(tok.encode(t, max_len=max_len - 1, add_eos=True),
                           max_len)
            ids.append(i)
            masks.append(m)
        ids = torch.tensor(ids, dtype=torch.int32, device=device)
        masks = torch.tensor(masks, dtype=torch.int32, device=device)
        with torch.no_grad():
            pooled = TextEncoder.pool_eos(model(ids, masks), masks)
        return pooled.float().cpu().numpy()

    return embed


def build_am_banks(
    samples,
    image_loader,
    embed_texts: Callable[[Sequence[str]], np.ndarray],
    bank_dim: int,
    visual_bank_path: str = "",
    report_bank_path: str = "",
    n_cam_images: int = 8,
    cam_top_n: int = 4,
    report_memory_size: int = 256,
    visual_max_features: int = 128,
    swin_kwargs: dict | None = None,
    seed: int = 0,
    device="cpu",
    swin_params=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(visual_bank (14 + N, bank_dim), report_bank (M, bank_dim)), fp32.

    A path, when given, wins for its bank (``.npy``, or ``.npz`` with an
    ``arr`` or first key). Otherwise AM-MRG's artifact chain runs on the
    training split: GradCAM over a SwinCheX (``CAM_SWIN`` updated by
    ``swin_kwargs``; initialised from ``seed`` on ``device``, or from
    ``swin_params``) for each label -> CAM features ->
    :func:`..utils.cam.build_visual_memory`; embedded reports and their
    rule labels -> :func:`..utils.cam.build_report_memory`.
    """
    from ..models.swin import SwinCheX, SwinTransformer

    rng = np.random.default_rng(seed)
    rbank = vbank = None
    if report_bank_path:
        rbank = _load_array(report_bank_path)
    if visual_bank_path:
        vbank = _load_array(visual_bank_path)
    if rbank is not None and vbank is not None:
        return vbank, rbank

    if rbank is None:
        reports = [s.report for s in samples[: 4 * report_memory_size]]
        embs = embed_texts(reports)
        labels = np.stack([extract_labels(r) for r in reports])
        rbank = build_report_memory(embs, labels, size=report_memory_size,
                                    seed=seed)
        rbank = _project(rbank, bank_dim, rng)
    if vbank is not None:
        return vbank.astype(np.float32), rbank.astype(np.float32)

    # the visual memory: the stage-1 CAM chain
    imgs = np.stack([image_loader(s)[0] for s in samples[:n_cam_images]]
                    ).astype(np.float32)
    device = torch.device(device)
    kw = dict(CAM_SWIN, img_size=imgs.shape[1])
    kw.update(swin_kwargs or {})
    model = SwinCheX(SwinTransformer(**kw, device=device),
                     num_classes=CAM_CLASSES, device=device)
    _init(model, seed, device, swin_params)
    x = torch.from_numpy(imgs).to(device)
    per_class = []
    for c in range(CAM_CLASSES):
        cam, tokens = swin_grad_cam(model, x, c)
        per_class.append(extract_cam_features(tokens, cam, top_n=cam_top_n))
    feats = np.stack(per_class)  # (14, B, top_n, C)
    disease_tokens = feats.mean(axis=(1, 2))  # (14, C) stage-1 tokens
    cam_features = feats.reshape(-1, feats.shape[-1])
    vbank = build_visual_memory(
        _project(disease_tokens, bank_dim, rng),
        _project(cam_features, bank_dim, rng),
        max_features=visual_max_features, seed=seed,
    )
    return vbank.astype(np.float32), rbank.astype(np.float32)


def _project(x: np.ndarray, dim: int, rng: np.random.Generator):
    """Fixed random projection into the bank width (identity when the
    widths match)."""
    if x.shape[-1] == dim:
        return x.astype(np.float32)
    w = rng.standard_normal((x.shape[-1], dim)).astype(np.float32)
    return (x @ w) / np.sqrt(x.shape[-1])


def _load_array(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        z = np.load(path)
        key = "arr" if "arr" in z.files else z.files[0]
        return z[key].astype(np.float32)
    return np.load(path).astype(np.float32)


def synthesize_graph_artifacts(
    reports: Sequence[str],
    embed_texts: Callable[[Sequence[str]], np.ndarray],
    num_scales: int = 5,
    base_nodes: int = 8,
    edges_per_scale: int = 64,
    disease_bank_size: int = 64,
    seed: int = 0,
) -> dict:
    """Multi-granularity graph tensors from the training reports (the
    M3KG artifacts' analog). Scale ``s`` holds the top ``base_nodes * (s +
    1)`` content words; node row ``N_s`` is the dummy pad row, and pad
    edges point at it (``models.rgcn.rgcn_conv``).

    Returns ``{"node_feats": [...], "edge_indices": [...], "edge_types":
    [...], "disease_bank": (M, D)}``.
    """
    stop = {"the", "is", "are", "of", "a", "an", "no", ".", "there", "in"}
    counter = Counter()
    for r in reports:
        counter.update(w for w in r.split() if w not in stop and len(w) > 2)
    ranked = [w for w, _ in counter.most_common(num_scales * base_nodes * 2)]

    kw_cat = {}  # keyword -> CheXpert category, for type-2 edges
    for ci, label in enumerate(CHEXPERT_LABELS[:-1]):
        for kw in _KEYWORDS[label]:
            for w in kw.split():
                kw_cat[w] = ci

    out = {"node_feats": [], "edge_indices": [], "edge_types": []}
    for s in range(num_scales):
        k = base_nodes * (s + 1)
        words = (ranked + [f"node{i}" for i in range(k)])[:k]
        widx = {w: i for i, w in enumerate(words)}
        feats = embed_texts(words)  # (k, D)
        feats = np.concatenate(
            [feats, np.zeros((1, feats.shape[1]), np.float32)])

        edges: list[tuple[int, int, int]] = []
        seen = set()

        def add(a: int, b: int, t: int):
            if a != b and (a, b, t) not in seen:
                seen.add((a, b, t))
                edges.append((a, b, t))

        for r in reports[:200]:
            toks = [w for w in r.split() if w in widx]
            present = sorted({widx[w] for w in toks})
            for i in range(len(toks) - 1):  # type 1: adjacency
                if toks[i] in widx and toks[i + 1] in widx:
                    add(widx[toks[i]], widx[toks[i + 1]], 1)
            for i in present:  # type 0: co-occurrence
                for j in present:
                    add(i, j, 0)
            if len(edges) >= edges_per_scale:
                break
        for wa, ca in kw_cat.items():  # type 2: one CheXpert category
            for wb, cb in kw_cat.items():
                if ca == cb and wa in widx and wb in widx:
                    add(widx[wa], widx[wb], 2)
        edges = edges[:edges_per_scale]
        ei = np.full((2, edges_per_scale), k, np.int32)  # pad -> dummy row
        et = np.zeros((edges_per_scale,), np.int32)
        for i, (a, b, t) in enumerate(edges):
            ei[0, i], ei[1, i], et[i] = a, b, t
        out["node_feats"].append(feats)
        out["edge_indices"].append(ei)
        out["edge_types"].append(et)

    bank_terms = list(CHEXPERT_LABELS) + ranked
    bank_terms = bank_terms + [f"term{i}" for i in range(disease_bank_size)]
    out["disease_bank"] = embed_texts(bank_terms[:disease_bank_size])
    return out


def load_graph_npz(path: str, num_scales: int = 5) -> dict:
    """Graph tensors from one ``.npz`` with keys ``node_feats_{s}``,
    ``edge_index_{s}``, ``edge_type_{s}`` and ``disease_bank``."""
    z = np.load(path)
    return {
        "node_feats": [z[f"node_feats_{s}"] for s in range(num_scales)],
        "edge_indices": [z[f"edge_index_{s}"] for s in range(num_scales)],
        "edge_types": [z[f"edge_type_{s}"] for s in range(num_scales)],
        "disease_bank": z["disease_bank"],
    }


# ---------------------------------------------------------------------------
# MAC-RRG's agent context
# ---------------------------------------------------------------------------


def build_alias_dict(reports: Sequence[str], max_terms: int = 200) -> dict:
    """alias -> canonical entity: each CheXpert keyword maps to its label,
    and the ``max_terms`` most frequent words longer than 3 letters to
    themselves (where no keyword took them)."""
    alias = {}
    for label in CHEXPERT_LABELS[:-1]:
        for kw in _KEYWORDS[label]:
            alias[kw] = label
    counter = Counter()
    for r in reports:
        counter.update(w for w in r.split() if len(w) > 3)
    for w, _ in counter.most_common(max_terms):
        alias.setdefault(w, w)
    return alias


def build_relations(reports: Sequence[str], alias_dict: dict,
                    max_relations: int = 500) -> list[tuple[str, str, str]]:
    """``(head, "co_occurs", tail)`` triples of the canonical entities that
    occur together in a report, in first-seen order. An alias occurs where
    it is a substring of the report (``a in text``, no word boundary)."""
    rels: list[tuple[str, str, str]] = []
    seen = set()
    aliases = sorted(alias_dict, key=len, reverse=True)
    for r in reports:
        text = " " + r.lower() + " "
        ents = list(dict.fromkeys(alias_dict[a] for a in aliases if a in text))
        for i in range(len(ents)):
            for j in range(i + 1, len(ents)):
                key = (ents[i], "co_occurs", ents[j])
                if key not in seen:
                    seen.add(key)
                    rels.append(key)
                if len(rels) >= max_relations:
                    return rels
    return rels


class MACContext:
    """What MAC-RRG's agents need, built once a run from the train reports:
    the alias dictionary, the relations, the chunk corpus (the reports'
    unique ``"."``-split sentences, at most 512) and its searcher, and the
    embedder; plus a cache of each draft's (rag, concept) arrays."""

    def __init__(
        self,
        reports: Sequence[str],
        embed_texts: Callable[[Sequence[str]], np.ndarray],
        max_chunks: int = 8,
        max_entities: int = 8,
        topk: int = 3,
    ):
        self.embed_texts = embed_texts
        self.alias_dict = build_alias_dict(reports)
        self.relations = build_relations(reports, self.alias_dict)
        chunks = dict.fromkeys(
            sent.strip() for r in reports for sent in r.split("."))
        chunks.pop("", None)
        self.chunks = list(chunks)[:512] or ["none"]
        self.searcher = EntityWiseSearcher(self.chunks, embed_texts)
        self.max_chunks = max_chunks
        self.max_entities = max_entities
        self.topk = topk
        self._cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def agent_embeds(self, draft: str) -> tuple[np.ndarray, np.ndarray]:
        """Draft text -> (rag (max_chunks, D), concept (max_entities, D));
        the rag mask is dropped."""
        if draft not in self._cache:
            rag, _ = encode_rag(
                draft, self.alias_dict, self.searcher, self.embed_texts,
                topk=self.topk, max_chunks=self.max_chunks)
            concept = encode_concepts(
                draft, self.alias_dict, self.relations, self.embed_texts,
                max_entities=self.max_entities)
            self._cache[draft] = (rag, concept)
        return self._cache[draft]

    def extra_fn(self, sample) -> dict:
        """``MRGBatcher``'s ``extra_fn``: the agents over the sample's draft
        (its report where it has none)."""
        rag, concept = self.agent_embeds(sample.draft or sample.report)
        return {"rag_embeds": rag, "concept_embeds": concept}
