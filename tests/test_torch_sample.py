"""``sample_generate`` and ``device_preprocess`` in the port against the
JAX package, on CPU.

(a) The logits that each slot is drawn from: the JAX ``sample_generate``
    runs jitted with the logits that ``jax.random.categorical`` gets
    recorded by a debug callback, and the port's draws are JAX's tokens,
    so both packages walk the same tokens; the port's ``sample_filter``
    equals JAX's filtered
    logits within 1e-6 (repetition penalty, n-gram ban, ``min_new_tokens``,
    temperature, nucleus cut), and the sequences are equal.
(b) ``top_p`` -> 0 keeps only the largest logit: the draws equal greedy
    decoding.
(c) A seeded frequency test: 20,000 draws of one slot from a fixed
    distribution, each token's share within 0.015 of its probability,
    and the nucleus-cut tokens never drawn.
(d) ``device_preprocess`` equals JAX's (``jax.image.resize`` bilinear,
    antialiased when it downsamples) within 1e-4 of the normalised values,
    down (97x131 -> 32, 300x300 -> 224) and up (20x24 -> 56, 128 ->
    224), in fp32; and in bf16 within one bf16 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.data import preprocessing as jax_prep
from medical_image_analysis_tpu.models import generation as jax_gen
from medical_image_analysis_tpu_torch.data import preprocessing
from medical_image_analysis_tpu_torch.models import generation

V, B, T, EOS = 23, 3, 9, 2
KW = dict(temperature=0.7, top_p=0.8, min_new_tokens=3,
          repetition_penalty=1.8, no_repeat_ngram_size=2)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step_logits(seed):
    """A deterministic decode step: logits from the token and slot."""
    table = np.random.default_rng(seed).standard_normal((T, V, V)) * 3

    def logits(tok, t):
        return table[t][np.asarray(tok)[:, 0]]
    return logits


def test_filter_and_tokens_match_jax(monkeypatch):
    logits_of = _step_logits(0)
    table = jnp.asarray(np.random.default_rng(0).standard_normal((T, V, V))
                        * 3)
    first = np.random.default_rng(1).standard_normal((B, V)) * 3
    seen_jax, seen_port = [], []
    draw = jax.random.categorical

    def categorical(key, logits):
        jax.debug.callback(lambda x: seen_jax.append(np.asarray(x)), logits,
                           ordered=True)
        return draw(key, logits)

    monkeypatch.setattr(jax_gen.jax.random, "categorical", categorical)
    run = jax.jit(lambda f: jax_gen.sample_generate(
        lambda tok, cache, t: (table[t][tok[:, 0]], cache),
        None, jax.random.PRNGKey(0), f, T, EOS, **KW))
    want = np.asarray(run(jnp.asarray(first)))
    jax.effects_barrier()
    filt = generation.sample_filter

    def record(logits, seq, seen, t, *a, **k):
        out = filt(logits, seq, seen, t, *a, **k)
        seen_port.append(out.numpy())
        return out

    monkeypatch.setattr(generation, "sample_filter", record)
    picks = iter(want.T)

    def multinomial(probs, n, generator=None):
        return torch.as_tensor(next(picks), dtype=torch.long)[:, None]

    monkeypatch.setattr(generation.torch, "multinomial", multinomial)
    got = generation.sample_generate(
        lambda tok, cache, t: (torch.from_numpy(logits_of(tok.numpy(), t))
                               .float(), cache),
        None, torch.Generator(), torch.from_numpy(first).float(), T, EOS,
        **KW).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(seen_port) == len(seen_jax) == T
    for g, w in zip(seen_port, seen_jax):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert (np.stack(seen_port) <= generation.NEG_INF / 2).any()


def test_top_p_to_zero_is_greedy():
    logits_of = _step_logits(3)
    first = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, V)) * 3).float()

    def step(tok, cache, t):
        return torch.from_numpy(logits_of(tok.numpy(), t)).float(), cache

    kw = dict(min_new_tokens=2, repetition_penalty=1.5,
              no_repeat_ngram_size=2)
    greedy = generation.greedy_generate(step, None, first, T, EOS, **kw)
    sampled = generation.sample_generate(
        step, None, torch.Generator().manual_seed(0), first, T, EOS,
        top_p=1e-9, **kw)
    assert torch.equal(sampled, greedy)


def test_draw_frequencies():
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    n = 20_000
    gen = torch.Generator().manual_seed(0)
    filt = generation.sample_filter(
        logits, torch.full((1, 4), -1, dtype=torch.int32),
        torch.zeros(1, 6, dtype=torch.bool), 0, EOS, top_p=0.9)
    probs = torch.softmax(filt, -1)[0]
    kept = probs > 0
    assert kept.tolist() == [True, True, True, True, False, False]
    draws = torch.cat([
        generation.sample_generate(
            lambda tok, cache, t: (logits.expand(tok.shape[0], -1), cache),
            None, gen, logits.expand(1000, -1), 1, 99, top_p=0.9)[:, 0]
        for _ in range(n // 1000)])
    share = torch.bincount(draws.long(), minlength=6).float() / n
    assert (share[~kept] == 0).all()
    assert (share - probs).abs().max() < 0.015


@pytest.mark.parametrize("shape,size", [((97, 131), 32), ((300, 300), 224),
                                        ((20, 24), 56), ((128, 128), 224)])
def test_device_preprocess_matches_jax(shape, size):
    raw = np.random.default_rng(size).integers(0, 256, (2, *shape, 3),
                                               dtype=np.uint8)
    want = np.asarray(jax.jit(jax_prep.device_preprocess, static_argnums=(
        1, 2))(jnp.asarray(raw), size, jnp.float32))
    got = preprocessing.device_preprocess(torch.from_numpy(raw), size,
                                          torch.float32).numpy()
    assert got.shape == want.shape == (2, size, size, 3)
    assert np.abs(got - want).max() <= 1e-4
    got16 = preprocessing.device_preprocess(torch.from_numpy(raw), size)
    assert got16.dtype == torch.bfloat16
    step = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got16.float().numpy() - want).max() <= step
