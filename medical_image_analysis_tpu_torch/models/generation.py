"""Autoregressive generation: greedy, sampling and beam search, in PyTorch.

Counterpart of ``medical_image_analysis_tpu/models/generation.py``, with
the same HF ``generate`` semantics (repetition penalty over generated
tokens, EOS banned before ``min_new_tokens``, no-repeat n-grams, beam
hypotheses scored ``sum_logprobs / len**length_penalty``). The step loop
is a Python loop whose tensors stay on the model's device; ``t`` is a
Python int.

Ranking ties go to the lower index, as in ``jax.lax.top_k``:
:func:`_top_k` is a stable descending sort, since ``torch.topk`` does not
promise an order among equal values.
"""

from __future__ import annotations

from typing import Callable

import torch

NEG_INF = -1.0e7

# decode_step(tokens (B, 1), cache, t) -> (logits (B, V) fp32, cache)
DecodeStep = Callable


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _seen_mask(seq: torch.Tensor, v: int) -> torch.Tensor:
    """(B, T) ids with -1 for unfilled slots -> (B, V) bool seen mask."""
    idx = torch.where(seq < 0, v, seq).long()
    seen = torch.zeros(seq.shape[0], v + 1, dtype=torch.bool,
                       device=seq.device)
    return seen.scatter_(1, idx, True)[:, :v]


def _apply_repetition_penalty(logits, seq, penalty):
    """HF RepetitionPenaltyLogitsProcessor over generated tokens."""
    if penalty == 1.0:
        return logits
    return _penalize_seen(logits, _seen_mask(seq, logits.shape[-1]), penalty)


def _penalize_seen(logits, seen, penalty):
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _mark_seen(seen, tok):
    """seen (B, V) bool; tok (B,) -> seen with each row's tok set."""
    return seen.scatter(1, tok[:, None].long(), True)


def _ban_repeated_ngrams(logits, seq, t: int, n: int):
    """HF NoRepeatNGramLogitsProcessor over the generated ids: ban any
    token that would complete an n-gram already in ``seq[:t]``.

    seq: (B, T) generated ids, -1 in unfilled slots; ``t`` is the slot
    being chosen.
    """
    if n <= 0:
        return logits
    b, T = seq.shape
    v = logits.shape[-1]
    if T - n + 1 <= 0:
        return logits
    dev = seq.device
    # window i matches iff seq[i : i+n-1] equals seq[t-n+1 : t]; only
    # windows fully inside the filled prefix count
    m = (torch.arange(T - n + 1, device=dev) <= t - n)[None].expand(b, -1)
    for j in range(n - 1):
        pos = max(t - (n - 1) + j, 0)
        m = m & (seq[:, j : j + T - n + 1] == seq[:, pos : pos + 1])
    nxt = seq[:, n - 1 : T]  # token following each window
    hits = torch.zeros(b, v, dtype=torch.int32, device=dev).scatter_add_(
        1, torch.where(m, nxt, 0).long(), m.to(torch.int32)
    )
    return torch.where(hits > 0, NEG_INF, logits)


def _ban_eos_before_min(logits, t: int, eos_id: int, min_new_tokens: int):
    if t >= min_new_tokens:
        return logits
    ban = torch.arange(logits.shape[-1], device=logits.device) == eos_id
    return torch.where(ban[None], NEG_INF, logits)


def greedy_generate(
    decode_step: DecodeStep,
    cache,
    first_logits: torch.Tensor,  # (B, V) from the prefill call
    max_new_tokens: int,
    eos_id: int,
    min_new_tokens: int = 0,
    repetition_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
):
    """Greedy decode; returns (B, max_new_tokens), EOS-padded after stop."""
    b, v = first_logits.shape
    dev = first_logits.device
    seq = torch.full((b, max_new_tokens), -1, dtype=torch.int32, device=dev)
    seen = torch.zeros(b, v, dtype=torch.bool, device=dev)

    def pick(logits, t):
        logits = _penalize_seen(logits, seen, repetition_penalty)
        logits = _ban_repeated_ngrams(logits, seq, t, no_repeat_ngram_size)
        logits = _ban_eos_before_min(logits, t, eos_id, min_new_tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    tok = pick(first_logits, 0)
    seq[:, 0] = tok
    seen = _mark_seen(seen, tok)
    done = tok == eos_id
    for t in range(1, max_new_tokens):
        logits, cache = decode_step(tok[:, None], cache, t)
        tok = torch.where(done, eos_id, pick(logits, t)).to(torch.int32)
        seq[:, t] = tok
        seen = _mark_seen(seen, tok)
        done = done | (tok == eos_id)
    return torch.where(seq < 0, eos_id, seq)


def sample_filter(logits, seq, seen, t: int, eos_id: int,
                  temperature: float = 1.0, top_p: float = 1.0,
                  min_new_tokens: int = 0, repetition_penalty: float = 1.0,
                  no_repeat_ngram_size: int = 0):
    """The logits that :func:`sample_generate` draws slot ``t`` from: the
    repetition penalty over ``seen``, the n-gram ban over ``seq``, EOS
    banned before ``min_new_tokens``, the temperature, then the nucleus
    cut (every logit below the one at which the sorted softmax's running
    sum first reaches ``top_p`` set to ``NEG_INF``; ties kept)."""
    logits = _penalize_seen(logits, seen, repetition_penalty)
    logits = _ban_repeated_ngrams(logits, seq, t, no_repeat_ngram_size)
    logits = _ban_eos_before_min(logits, t, eos_id, min_new_tokens)
    logits = logits / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def sample_generate(
    decode_step: DecodeStep,
    cache,
    generator: torch.Generator,
    first_logits: torch.Tensor,  # (B, V) from the prefill call
    max_new_tokens: int,
    eos_id: int,
    temperature: float = 1.0,
    top_p: float = 1.0,
    min_new_tokens: int = 0,
    repetition_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
):
    """Temperature / nucleus sampling (JAX ``sample_generate``), each slot
    drawn from the softmax of :func:`sample_filter`'s logits with
    ``generator`` (on the logits' device). JAX draws with
    ``jax.random.categorical``; the same seed gives other draws here.
    Returns (B, max_new_tokens), EOS-padded after a row stops."""
    b, v = first_logits.shape
    dev = first_logits.device
    seq = torch.full((b, max_new_tokens), -1, dtype=torch.int32, device=dev)
    seen = torch.zeros(b, v, dtype=torch.bool, device=dev)

    def pick(logits, t):
        logits = sample_filter(logits.float(), seq, seen, t, eos_id,
                               temperature, top_p, min_new_tokens,
                               repetition_penalty, no_repeat_ngram_size)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    tok = pick(first_logits, 0)
    seq[:, 0] = tok
    seen = _mark_seen(seen, tok)
    done = tok == eos_id
    for t in range(1, max_new_tokens):
        logits, cache = decode_step(tok[:, None], cache, t)
        tok = torch.where(done, eos_id, pick(logits, t)).to(torch.int32)
        seq[:, t] = tok
        seen = _mark_seen(seen, tok)
        done = done | (tok == eos_id)
    return torch.where(seq < 0, eos_id, seq)


def beam_generate(
    decode_step: DecodeStep,
    cache,  # expanded to batch*num_beams rows, or the split beam cache
    first_logits: torch.Tensor,  # (B*nb, V) from prefill (identical per beam)
    batch: int,
    num_beams: int,
    max_new_tokens: int,
    eos_id: int,
    min_new_tokens: int = 0,
    repetition_penalty: float = 1.0,
    length_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
    reorder_cache_fn=None,
    ancestry_slots: int | None = None,
    prompt_len: int = 0,
):
    """Beam search; returns the best sequence per item, (B, max_new_tokens).

    With ``reorder_cache_fn`` the KV cache is re-gathered to the parent
    rows every step. With ``ancestry_slots=S`` the cache is append-only
    and a (rows, S) ancestry map says which group row wrote each slot;
    ``decode_step`` then takes ``(tokens, cache, anc, t)``.
    """
    nb = num_beams
    v = first_logits.shape[-1]
    dev = first_logits.device
    ancestry = ancestry_slots is not None
    rows = batch * nb
    group_base = (torch.arange(batch, device=dev) * nb)[:, None]

    def expand(logits, alive_seq, alive_logp, fin_seq, fin_scores, t):
        # HF order: log_softmax first, then the processors act on the
        # log-probs with no renormalisation.
        lp = torch.log_softmax(logits.reshape(rows, v).float(), dim=-1)
        flat_seq = alive_seq.reshape(rows, -1)
        lp = _apply_repetition_penalty(lp, flat_seq, repetition_penalty)
        lp = _ban_repeated_ngrams(lp, flat_seq, t, no_repeat_ngram_size)
        lp = _ban_eos_before_min(lp, t, eos_id, min_new_tokens)
        cand = alive_logp[..., None] + lp.reshape(batch, nb, v)
        top_logp, top_idx = _top_k(cand.reshape(batch, nb * v), 2 * nb)
        beam_idx = top_idx // v
        tok = (top_idx % v).to(torch.int32)
        seqs = torch.gather(
            alive_seq, 1, beam_idx[..., None].expand(-1, -1, max_new_tokens)
        ).clone()
        seqs[:, :, t] = tok
        is_eos = tok == eos_id

        cand_fin = torch.where(
            is_eos, top_logp / (t + 1.0) ** length_penalty, NEG_INF
        )
        fs = torch.cat([fin_scores, cand_fin], dim=1)
        ss = torch.cat([fin_seq, torch.where(seqs < 0, eos_id, seqs)], dim=1)
        fin_scores, pick = _top_k(fs, nb)
        fin_seq = torch.gather(
            ss, 1, pick[..., None].expand(-1, -1, max_new_tokens)
        )

        alive_cand = torch.where(is_eos, NEG_INF, top_logp)
        alive_logp, apick = _top_k(alive_cand, nb)
        alive_seq = torch.gather(
            seqs, 1, apick[..., None].expand(-1, -1, max_new_tokens)
        )
        bidx = torch.gather(beam_idx, 1, apick)
        ntok = torch.gather(tok, 1, apick)
        return alive_seq, alive_logp, fin_seq, fin_scores, bidx, ntok

    alive_seq = torch.full((batch, nb, max_new_tokens), -1, dtype=torch.int32,
                           device=dev)
    # only beam 0 is live at t=0 (all beams identical after prefill)
    alive_logp = torch.tensor([0.0] + [NEG_INF] * (nb - 1),
                              device=dev).repeat(batch, 1)
    fin_seq = torch.full((batch, nb, max_new_tokens), eos_id,
                         dtype=torch.int32, device=dev)
    fin_scores = torch.full((batch, nb), NEG_INF, device=dev)

    alive_seq, alive_logp, fin_seq, fin_scores, bidx, tok = expand(
        first_logits.reshape(batch, nb, v), alive_seq, alive_logp, fin_seq,
        fin_scores, 0,
    )
    flat_idx = (group_base + bidx).reshape(-1)
    if ancestry:
        own = (torch.arange(rows, device=dev) % nb).to(torch.int32)
        # prompt KV is replicated (or shared) across a group, so "own
        # row" is a valid ancestor for every slot
        anc = own[:, None].expand(rows, ancestry_slots)[flat_idx]
        slot_iota = torch.arange(ancestry_slots, device=dev)[None]
    else:
        cache = reorder_cache_fn(cache, flat_idx)

    for t in range(1, max_new_tokens):
        if ancestry:
            # decode_step writes slot prompt_len+t-1 into each row's OWN
            # cache row and reads it in the same call: mark it first
            anc = torch.where(slot_iota == prompt_len + t - 1, own[:, None],
                              anc)
            logits, cache = decode_step(tok.reshape(rows, 1), cache, anc, t)
        else:
            logits, cache = decode_step(tok.reshape(rows, 1), cache, t)
        alive_seq, alive_logp, fin_seq, fin_scores, bidx, tok = expand(
            logits.reshape(batch, nb, v), alive_seq, alive_logp, fin_seq,
            fin_scores, t,
        )
        flat_idx = (group_base + bidx).reshape(-1)
        if ancestry:
            anc = anc[flat_idx]
        else:
            cache = reorder_cache_fn(cache, flat_idx)

    # if nothing finished, fall back to the best alive beam
    alive_scores = alive_logp / float(max_new_tokens) ** length_penalty
    none_fin = torch.all(fin_scores <= NEG_INF / 2, dim=1)
    best = torch.where(none_fin, torch.argmax(alive_scores, dim=1),
                       torch.argmax(fin_scores, dim=1))
    pick_best = best[:, None, None].expand(-1, 1, max_new_tokens)
    out_fin = torch.gather(fin_seq, 1, pick_best)[:, 0]
    out_alive = torch.gather(alive_seq, 1, pick_best)[:, 0]
    out = torch.where(none_fin[:, None], out_alive, out_fin)
    return torch.where(out < 0, eos_id, out)
