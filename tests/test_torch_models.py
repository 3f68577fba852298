"""PyTorch port modules against the JAX package on CPU.

One JAX ``init`` is loaded into both packages (``ckpt.from_jax``), inputs
are made with numpy from a seed, and outputs are compared in fp32.
Tolerances: fp32 on both sides; the port and XLA sum in other orders,
which stays within 1e-5 on O(1) values per layer and 1e-4 through a few
layers and a vocabulary-wide logit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import common as jax_common
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models.mamba import ARM as JaxARM
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.models import common, llm
from medical_image_analysis_tpu_torch.models.mamba import ARM

MODEL_ATOL = 1e-4  # fp32 through a few layers, reordered sums


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_spatial_transpose_with_cls_matches_jax_and_is_involution():
    x = np.random.default_rng(0).standard_normal((2, 10, 3)).astype(np.float32)
    want = jax_common.spatial_transpose_with_cls(jnp.asarray(x), 4)
    got = common.spatial_transpose_with_cls(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = common.spatial_transpose_with_cls(got, 4)
    np.testing.assert_array_equal(back.numpy(), x)


def test_patch_embed_matches_jax():
    """HWIO flax conv kernel on channels-last input == OIHW conv2d."""
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = jax_common.PatchEmbed(patch_size=16, embed_dim=8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = common.PatchEmbed(16, 8)
    load_jax_params(port, params)
    _close(port(torch.from_numpy(x)).detach(),
           jm.apply(params, jnp.asarray(x)), 1e-5)


TINY_ARM = dict(patch_size=16, embed_dim=32, depth=2, d_state=4)


@pytest.mark.parametrize("scan_backend", ["auto", "ref", "pallas"])
def test_arm_matches_jax_ref_backend(scan_backend):
    """Tiny ARM (32x32 image, 4 patches + middle cls). JAX picks its
    ``ref`` backend on CPU; the port's ``auto`` takes the plain version
    of the fused kernels there and ``ref`` the per-direction path. The
    port's ``pallas`` (the general scan's route, its plain versions here)
    is held against the JAX ``pallas`` path, its kernels in interpret
    mode, forward and the gradients of every parameter (1e-4 of each
    tensor's largest gradient)."""
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = JaxARM(**TINY_ARM, scan_backend="ref")
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    if scan_backend == "pallas":
        jm = JaxARM(**TINY_ARM, scan_backend="pallas")
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    port = ARM(**TINY_ARM, img_size=32, scan_backend=scan_backend).eval()
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 5, 32)
    _close(got, want, MODEL_ATOL)
    if scan_backend != "pallas":
        return
    w = np.random.default_rng(4).standard_normal(want.shape).astype(
        np.float32)
    want_g = state_dict_from_jax(jax.jit(jax.grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w)))(params))
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    named = dict(port.named_parameters())
    assert set(named) == set(want_g)
    for name, p in named.items():
        err = (p.grad - want_g[name]).abs().max().item()
        assert err <= 1e-4 * want_g[name].abs().max().item(), (name, err)


def _tiny_lm_pair(seed=0):
    jcfg = jax_llm.LLMConfig(**{**_tiny_fields(), "dtype": jnp.float32})
    pcfg = llm.LLMConfig(**{**_tiny_fields(), "dtype": torch.float32})
    jm = jax_llm.TransformerLM(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), ids)
    port = llm.TransformerLM(pcfg).eval()
    load_jax_params(port, params)
    return jcfg, pcfg, jm, params, port


def _tiny_fields():
    c = jax_llm.LLM_CONFIGS["tiny_test"]
    return dict(vocab_size=c.vocab_size, dim=c.dim, n_layers=c.n_layers,
                n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
                hidden_dim=c.hidden_dim)


@pytest.mark.parametrize("mode", ["no_cache", "joint_cache", "split_cache"])
def test_transformer_lm_logits_match_jax(mode):
    jcfg, pcfg, jm, params, port = _tiny_lm_pair()
    rng = np.random.default_rng(4)
    b, lp, nb = 2, 6, 3
    ids = rng.integers(0, pcfg.vocab_size, (b, lp)).astype(np.int32)
    nxt = rng.integers(0, pcfg.vocab_size, (b * nb, 1)).astype(np.int32)
    pos = np.broadcast_to(np.arange(lp), (b, lp)).astype(np.int32)
    pos1 = np.full((b * nb, 1), lp, np.int32)

    def run_port(**kw):
        with torch.no_grad():
            return port(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()})

    if mode == "no_cache":
        mask = np.ones((b, lp), np.int32)
        mask[0, -2:] = 0
        want = jm.apply(params, input_ids=jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask))
        got = run_port(input_ids=ids, attention_mask=mask)
        _close(got, want, MODEL_ATOL)
        return

    if mode == "joint_cache":
        # prefill 6 slots of a 10-slot cache, then decode one token
        jc = jax_llm.init_cache(jcfg, b, 10)
        pc = llm.init_cache(pcfg, b, 10)
        wfirst, jc = jm.apply(params, input_ids=jnp.asarray(ids),
                              positions=jnp.asarray(pos), cache=jc)
        gfirst, pc = run_port(input_ids=ids, positions=pos, cache=pc)
        _close(gfirst, wfirst, MODEL_ATOL)
        want, _ = jm.apply(params, input_ids=jnp.asarray(nxt[:b]),
                           positions=jnp.asarray(pos1[:b]), cache=jc)
        got, _ = run_port(input_ids=nxt[:b], positions=pos1[:b], cache=pc)
        _close(got, want, MODEL_ATOL)
        return

    # split cache: B-row prefill of exactly lp slots, nb beams decode with
    # a non-trivial ancestry map over 4 generated slots
    jc = jax_llm.init_cache(jcfg, b, lp)
    pc = llm.init_cache(pcfg, b, lp)
    _, jc = jm.apply(params, input_ids=jnp.asarray(ids),
                     positions=jnp.asarray(pos), cache=jc)
    _, pc = run_port(input_ids=ids, positions=pos, cache=pc)
    jc = jax_llm.split_beam_cache(jc, nb, 4)
    pc = llm.split_beam_cache(pc, nb, 4)
    anc = np.zeros((b, nb, 4), np.int32)
    for step in range(2):
        anc[:, :, step] = np.arange(nb)[None]  # each row wrote its own slot
        toks = rng.integers(0, pcfg.vocab_size, (b * nb, 1)).astype(np.int32)
        p1 = np.full((b * nb, 1), lp + step, np.int32)
        want, jc = jm.apply(params, input_ids=jnp.asarray(toks),
                            positions=jnp.asarray(p1), cache=jc,
                            beam=jnp.asarray(anc))
        got, pc = run_port(input_ids=toks, positions=p1, cache=pc, beam=anc)
        _close(got, want, MODEL_ATOL)
        anc = anc[:, ::-1].copy()  # beams swap parents between steps
