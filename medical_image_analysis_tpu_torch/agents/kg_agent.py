"""MAC-RRG's knowledge-graph agent, on the host in numpy.

Counterpart of ``medical_image_analysis_tpu/agents/kg_agent.py``: entity
extraction against an alias dictionary (the aliases tried longest first,
inside word boundaries), merging, neighbourhood link extraction, and an
attention of each entity over its neighbours and edges. Embeddings come
from any ``embed_texts(list[str]) -> (N, D)`` callable
(``data.side_inputs.make_text_embedder``).
"""

from __future__ import annotations

import re
from typing import Callable, Mapping, Sequence

import numpy as np


def preprocess_report(report: str, alias_dict: Mapping[str, str]) -> list[str]:
    """The canonical entities (``alias_dict``: alias -> entity) whose aliases
    appear in the report, longest alias first."""
    text = " " + report.lower() + " "
    found = []
    for alias in sorted(alias_dict, key=len, reverse=True):
        if re.search(r"(?<![a-z])" + re.escape(alias.lower()) + r"(?![a-z])",
                     text):
            found.append(alias_dict[alias])
    return found


def merge_entities(entities: Sequence[str]) -> list[str]:
    """De-duplicate, keeping the first-seen order."""
    return list(dict.fromkeys(entities))


def extract_entity_links(
    relations: Sequence[tuple[str, str, str]],
    entities: Sequence[str],
    topk: int = 10,
) -> dict[str, list[tuple[str, str]]]:
    """entity -> up to ``topk`` (relation, neighbour) pairs, in the order of
    ``relations``."""
    out: dict[str, list[tuple[str, str]]] = {}
    for e in entities:
        links = []
        for head, rel, tail in relations:
            if head == e:
                links.append((rel, tail))
            elif tail == e:
                links.append((rel, head))
            if len(links) >= topk:
                break
        out[e] = links
    return out


def graph_attention_embed(central: np.ndarray, neighbors: np.ndarray,
                          edges: np.ndarray) -> np.ndarray:
    """``central`` (D,) attends over the keys ``neighbors + edges`` (K, D);
    returns ``central + w @ neighbors`` (D,), or ``central`` without
    neighbours."""
    if neighbors.size == 0:
        return central
    keys = neighbors + edges
    scores = keys @ central / np.sqrt(central.shape[-1])
    w = np.exp(scores - scores.max())
    w = w / w.sum()
    return central + w @ neighbors


def encode_concepts(
    report: str,
    alias_dict: Mapping[str, str],
    relations: Sequence[tuple[str, str, str]],
    embed_texts: Callable[[Sequence[str]], np.ndarray],
    topk: int = 10,
    max_entities: int = 100,
) -> np.ndarray:
    """Report -> (max_entities, D) fp32 concept embeddings, zero-padded.
    Without an entity, ``embed_texts(["none"])`` is called only for D."""
    entities = merge_entities(preprocess_report(report, alias_dict))
    if not entities:
        dim = embed_texts(["none"]).shape[-1]
        return np.zeros((max_entities, dim), np.float32)
    links = extract_entity_links(relations, entities, topk)
    outs = []
    for central in entities[:max_entities]:
        pairs = links.get(central, [])
        texts = [central] + [n for _, n in pairs] + [r for r, _ in pairs]
        embs = embed_texts(texts)
        k = len(pairs)
        outs.append(graph_attention_embed(embs[0], embs[1 : 1 + k],
                                          embs[1 + k : 1 + 2 * k]))
    arr = np.stack(outs).astype(np.float32)
    pad = max_entities - arr.shape[0]
    if pad > 0:
        arr = np.concatenate([arr, np.zeros((pad, arr.shape[1]), np.float32)])
    return arr
