"""The port's sequence-parallel selective scan against the JAX package's.

``selective_scan_sp`` over 2 and 4 gloo processes on the CPU (each holding
L / S rows, ``tests/torch_ranks.py``) against JAX ``selective_scan_sp`` on
as many devices of the 8-device virtual CPU mesh, with softplus on and
off, B and C shared or grouped (G = 2). Both run the recurrence in fp32 and
fold the shards' transitions in the same order; the local scans differ
(a loop over the rows here, ``jax.lax.associative_scan`` there), so y is
held within 1e-5 of max(1, max |y|). One process (no grid) gives the same y.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks as tr
from medical_image_analysis_tpu.parallel import mesh as jax_mesh
from medical_image_analysis_tpu.parallel import sp_scan as jax_sp

BATCH, L, D, N = 2, 16, 8, 4
VARIANTS = [(sp, g) for sp in (True, False) for g in (1, 2)]
IDS = [f"softplus-{sp}-groups-{g}" for sp, g in VARIANTS]


def _case(seed, softplus, groups):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    bc = (BATCH, L, N) if groups == 1 else (BATCH, L, groups, N)
    return dict(u=t(BATCH, L, D), delta=t(BATCH, L, D, scale=0.5),
                A=-np.exp(t(D, N, scale=0.3)), B=t(*bc), C=t(*bc),
                D=t(D), delta_bias=t(D, scale=0.2), softplus=softplus)


CASES = [_case(i, sp, g) for i, (sp, g) in enumerate(VARIANTS)]


@pytest.fixture(scope="module")
def port_runs():
    return {world: tr.spawn(tr.sp_scan_rank, world, CASES)
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(len(VARIANTS)), ids=IDS)
def test_sp_scan_matches_jax(port_runs, world, i):
    case = CASES[i]
    mesh = jax_mesh.make_mesh(data=world, model=1,
                              devices=jax.devices()[:world])
    args = [jnp.asarray(case[k]) for k in ("u", "delta", "A", "B", "C", "D",
                                           "delta_bias")]
    want = np.asarray(jax.jit(lambda *a: jax_sp.selective_scan_sp(
        *a, case["softplus"], mesh))(*args))
    got = np.concatenate([r[i] for r in port_runs[world]], axis=1)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-5 * scale
    one = np.asarray(tr.sp_scan_rank(0, 1, [case])[0])
    assert np.abs(one - want).max() <= 1e-5 * scale
