"""MAC-RRG's retrieval agent, on the host in numpy.

Counterpart of ``medical_image_analysis_tpu/agents/rag_agent.py``: dense
retrieval of chunks per entity (an optional reranker reorders the
candidates), merged without duplicates, and the chunks' embeddings. The
candidates are ``np.argsort(-scores)``, numpy's default sort, so that both
packages break ties alike.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .kg_agent import merge_entities, preprocess_report


class EntityWiseSearcher:
    """Per-entity top-k cosine retrieval over a chunk corpus."""

    def __init__(
        self,
        chunks: Sequence[str],
        embed_texts: Callable[[Sequence[str]], np.ndarray],
        doc_vecs: np.ndarray | None = None,  # precomputed cache
        rerank: Callable[[str, Sequence[str]], np.ndarray] | None = None,
    ):
        self.chunks = list(chunks)
        self.embed_texts = embed_texts
        if doc_vecs is None:
            doc_vecs = embed_texts(self.chunks)
        norms = np.linalg.norm(doc_vecs, axis=1, keepdims=True)
        self.doc_vecs = doc_vecs / np.maximum(norms, 1e-9)
        self.rerank = rerank

    def search(self, entity: str, topk: int = 3) -> list[int]:
        q = self.embed_texts([entity])[0]
        q = q / max(np.linalg.norm(q), 1e-9)
        scores = self.doc_vecs @ q
        idx = np.argsort(-scores)[: max(topk * 3, topk)]
        if self.rerank is not None:
            rr = self.rerank(entity, [self.chunks[i] for i in idx])
            idx = idx[np.argsort(-rr)]
        return list(idx[:topk])


def merge_dedup_chunks_only(
        per_entity_hits: Sequence[Sequence[int]]) -> list[int]:
    """Merge the per-entity hit lists without duplicates, in first-hit
    order."""
    return list(dict.fromkeys(i for hits in per_entity_hits for i in hits))


def encode_rag(
    report: str,
    alias_dict,
    searcher: EntityWiseSearcher,
    embed_texts: Callable[[Sequence[str]], np.ndarray],
    topk: int = 3,
    max_chunks: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Report -> ((max_chunks, D) fp32 chunk embeddings, zero-padded, and
    their (max_chunks,) mask)."""
    entities = merge_entities(preprocess_report(report, alias_dict))
    hits = merge_dedup_chunks_only(
        [searcher.search(e, topk) for e in entities])[:max_chunks]
    dim = searcher.doc_vecs.shape[1]
    out = np.zeros((max_chunks, dim), np.float32)
    mask = np.zeros((max_chunks,), np.float32)
    if hits:
        out[: len(hits)] = embed_texts([searcher.chunks[i] for i in hits])
        mask[: len(hits)] = 1.0
    return out, mask
