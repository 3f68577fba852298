"""The port's fused short-sequence attention against the JAX package on CPU.

The same numpy inputs go through the JAX ``fused_attention`` (its Pallas
kernel in interpret mode, jitted) and the port's, whose kernel route runs
``attention_plain`` on a CPU tensor. Tolerances:

- fp32, kernel route: the same fp32 arithmetic, sums in another order:
  1e-5 of max(1, max |out|).
- bf16, kernel route: both sides widen the same bf16 q and k, and round p
  to bf16 before the product with v and the output once; a p one bf16
  step apart moves the output by at most a step: two bf16 steps (2^-6) of
  max(1, max |out|).
- the einsum route (S != L, or an fp32 score tile past 8 MiB), in the
  input dtype: fp32 as above; in bf16 the two frameworks round the scores
  and the softmax at other points, so four bf16 steps (2^-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import vit as jax_vit
from medical_image_analysis_tpu.ops import attention as jat
from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
from medical_image_analysis_tpu_torch.models import vit
from medical_image_analysis_tpu_torch.models.common import set_fused
from medical_image_analysis_tpu_torch.ops import attention as att

KERNEL_RTOL = {"fp32": 1e-5, "bf16": 2.0**-6}
EINSUM_RTOL = {"fp32": 1e-5, "bf16": 2.0**-5}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _qkv(seed, b, l, s, h, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, l, h, hd), (b, s, h, hd), (b, s, h, hd))]


def _causal(l):
    return np.where(np.tril(np.ones((l, l), bool)), 0.0, -np.inf).astype(
        np.float32)


@jax.jit
def _jax_attention(q, k, v, mask):
    return jat.fused_attention(q, k, v, mask, group=4, interpret=True)


def _both(arrays, mask, dtype):
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = _jax_attention(*jx, jm)
    got = att.fused_attention(*tx, tm, group=4)
    assert got.dtype == TORCH[dtype] and got.shape == tuple(want.shape)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    return np.abs(got - want).max(), max(1.0, np.abs(want).max()), got


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("l", [16, 144])
def test_kernel_route_matches_jax(l, masked, dtype):
    arrays = _qkv(l + masked, 2, l, l, 4, 32)
    err, scale, got = _both(arrays, _causal(l) if masked else None, dtype)
    assert np.isfinite(got).all()
    assert err <= KERNEL_RTOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,l,s,h", [(2, 8, 12, 4), (1, 1449, 1449, 1)],
                         ids=["cross", "past-tile"])
def test_einsum_route_matches_jax(monkeypatch, b, l, s, h, dtype):
    """S != L, and one head of L = 1,449 (an fp32 tile of 8.4 MB): the
    einsum route on both sides, in the input dtype, and no kernel call."""
    calls = []
    monkeypatch.setattr(att, "attention_fwd",
                        lambda *a: calls.append(1) or att.attention_plain(*a))
    err, scale, _ = _both(_qkv(s, b, l, s, h, 16), None, dtype)
    assert calls == []
    assert err <= EINSUM_RTOL[dtype] * scale, (err, scale)


def test_attention_module_matches_jax():
    """``Attention(32, 4)`` against the flax module, one parameter tree
    carried by ``ckpt.from_jax`` (strict); fp32, the kernel route."""
    x = np.random.default_rng(20).standard_normal((2, 16, 32)).astype(
        np.float32)
    jm = jax_vit.Attention(32, 4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(21)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.2 * rng.standard_normal(s.shape), jnp.float32),
        shapes)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    port = vit.Attention(32, 4)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= KERNEL_RTOL["fp32"] * max(
        1.0, np.abs(want).max())


def test_gate_no_kernel_call_under_a_gradient(monkeypatch):
    """The kernel wrapper is called once per forward without a gradient,
    never with one (autograd takes ``attention_plain``), and never when
    ``set_fused(model, False)``; the three agree."""
    calls = []
    monkeypatch.setattr(att, "attention_fwd",
                        lambda *a: calls.append(1) or att.attention_plain(*a))
    torch.manual_seed(0)
    port = vit.Attention(32, 4)
    x = torch.randn(2, 16, 32)
    with torch.no_grad():
        fused = port(x)
    assert len(calls) == 1
    y = port(x)
    y.sum().backward()
    assert len(calls) == 1 and port.qkv.weight.grad is not None
    set_fused(port, False)
    with torch.no_grad():
        plain = port(x)
    assert len(calls) == 1
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)
    torch.testing.assert_close(y.detach(), plain, rtol=0, atol=0)


def test_work_counts():
    """ViT-B at B=64 (L 197, 12 heads of 64): about 7.6 GFLOP, of which
    the two products are 4 hd per score and the softmax 5."""
    assert 7.6e9 < att.flops(64, 197, 12, 64) < 7.8e9
    scores = 64 * 12 * 197 * 197
    assert att.work(64, 197, 12, 64) == (4 * 64 * scores, 5 * scores)
    assert att.flops(64, 197, 12, 64) == scores * (4 * 64 + 5)
