"""The heads of AM-MRG and R2GenKG in the port against the JAX package on
CPU, at tiny widths: the BLIP-2 Q-Former (``Blip2QFormer``, ``QFormer``,
``EncoderProjectorQFormer``), the Hopfield modules (``hopfield_retrieve``,
``Hopfield``, ``HopfieldLayer``, ``HopfieldPooling``), the R-GCN modules
(``rgcn_conv``, ``RGCN``, ``MultiScaleSelfAttentionFusion``,
``ResidualCrossAttentionBlock``, ``CrossAttentionLookup``), and R2GenGPT's
``projector: qformer``; the Q-Former's text path, Hopfield's separate
``values`` and the lookup's per-item banks too.

Each module gets parameters of its JAX ``init``'s shapes, random from
numpy, loaded strictly into the port (``ckpt/from_jax.py``), and the same
numpy inputs. Outputs are held within 1e-5 of max(1, max |y|); the
gradients of ``sum(y * cotangent)`` w.r.t. every parameter and every
floating input within 1e-4 of that tensor's largest (fp32 both sides,
reordered sums). A key bias (BERT's ``key``, the cross blocks' and the
lookup's ``k``, the fusion's ``key``; Hopfield's ``k_proj`` and
``norm_stored`` bias where no update step reads the keys) has a gradient of
0 in exact arithmetic, since a softmax is unchanged by a shift along its
keys: there both sides must stay within 1e-6 of the largest gradient of
any parameter of the module (rounding noise).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.models import bert as jax_bert
from medical_image_analysis_tpu.models import hopfield as jax_hop
from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu.models import qformer as jax_qf
from medical_image_analysis_tpu.models import rgcn as jax_rgcn
from medical_image_analysis_tpu_torch.ckpt.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)
from medical_image_analysis_tpu_torch.models import bert, hopfield, llm, mrg
from medical_image_analysis_tpu_torch.models import qformer, rgcn

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_RTOL = 1e-6
KEY_BIASES = r"(^|\.)(key|k|k_proj)\.bias$"


@pytest.fixture(autouse=True)
def one_thread():
    """The port's many tiny ops run faster on one thread, and the parallel
    test run shares the cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(shapes, seed):
    """Random parameters of the JAX tree's shapes: norm scales near 1,
    ``A_log`` as the mixer's init (log 1..N), matrices N(0, 1/fan-in) (so
    that a 768-wide layer stays as well conditioned as a 16-wide one), the
    rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if key == "scale":
            return jnp.asarray(1.0 + 0.1 * v)
        if key == "A_log":
            n = leaf.shape[-1]
            return jnp.asarray(np.broadcast_to(
                np.log(np.arange(1, n + 1, dtype=np.float32)), leaf.shape))
        if leaf.ndim >= 2 and "bias" not in key:
            return jnp.asarray(v / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray(0.1 * v)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_jax(args):
    return jax.tree_util.tree_map(jnp.asarray, args)


def _to_torch(args, grad=False):
    def conv(a):
        t = torch.from_numpy(np.array(a))
        return t.requires_grad_() if grad and t.is_floating_point() else t

    return jax.tree_util.tree_map(conv, args)


def _close(got, want, rtol=OUT_RTOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def check_module(jm, port, args, seed, apply=None, forward=None,
                 zero_grads=KEY_BIASES):
    """Load one set of parameters of ``jm``'s shapes into ``port``; hold the
    output, and the gradients of sum(y * cotangent) w.r.t. every parameter
    and every floating input, against the JAX module's. ``args`` is a list
    of numpy arrays (or lists of them); ``apply(module, params, *args)``
    and ``forward(port, *args)`` default to calling the modules. The
    parameters named by the pattern ``zero_grads`` have a gradient of 0 in
    exact arithmetic: there both sides are held within ZERO_RTOL of the
    largest gradient of any parameter."""
    apply = apply or (lambda m, p, *a: m.apply(p, *a))
    forward = forward or (lambda m, *a: m(*a))
    jargs = _to_jax(args)
    params = _params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                    *jargs)), seed)
    y = jax.jit(lambda p, a: apply(jm, p, *a))(params, jargs)
    cot = _normal(seed + 1, *y.shape)
    floats = [i for i, a in enumerate(args)
              if np.asarray(jax.tree_util.tree_leaves(a)[0]).dtype.kind == "f"]

    def objective(p, fa):
        a = list(jargs)
        for i, v in zip(floats, fa):
            a[i] = v
        return jnp.sum(apply(jm, p, *a) * cot)

    gp, ga = jax.jit(jax.grad(objective, argnums=(0, 1)))(
        params, [jargs[i] for i in floats])
    load_jax_params(port, params)
    targs = _to_torch(args, grad=True)
    got = forward(port, *targs)
    _close(got, y)
    (got * torch.from_numpy(cot)).sum().backward()
    want = state_dict_from_jax(gp)
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    largest = max(g.abs().max().item() for g in want.values())
    for name, p in named.items():
        if zero_grads and re.search(zero_grads, name):
            for g in (p.grad, want[name]):
                assert g.abs().max() <= ZERO_RTOL * largest, (
                    name, g.abs().max().item() / largest)
            continue
        err = (p.grad - want[name]).abs().max().item()
        assert err <= GRAD_RTOL * want[name].abs().max().item(), (name, err)
    for i, g in zip(floats, ga):
        for t, gw in zip(jax.tree_util.tree_leaves(targs[i]),
                         jax.tree_util.tree_leaves(g)):
            gw = np.asarray(gw)
            err = float(np.abs(t.grad.numpy() - gw).max())
            assert err <= GRAD_RTOL * float(np.abs(gw).max()), (i, err)
    return port


# --------------------------------------------------------------------------
# Q-Former
# --------------------------------------------------------------------------

QF = dict(dim=16, n_heads=2, intermediate=32)


def test_blip2_qformer_with_a_wider_encoder_matches_jax():
    """Cross-attention into 24-wide image features every other layer of 3,
    the query FFN, 4 queries."""
    args = [_normal(0, 3, 7, 24)]
    jm = jax_bert.Blip2QFormer(num_queries=4, n_layers=3,
                               cross_attention_freq=2, **QF)
    port = bert.Blip2QFormer(num_queries=4, n_layers=3,
                             cross_attention_freq=2, enc_dim=24, **QF)
    port = check_module(jm, port, args, 1)
    assert port.bert.layer_0.ffn is None and port.bert.layer_1.crossattention \
        is None


def test_blip2_qformer_text_path_matches_jax():
    """The text path: 5 token ids (a padded tail in one row) through the
    word, position and token-type embeddings after 3 queries, the text
    FFN beside the query FFN, and cross-attention of the queries alone
    into 20-wide image features."""
    ids = np.random.default_rng(40).integers(0, 50, (2, 5)).astype(np.int32)
    mask = np.array([[1] * 5, [1] * 3 + [0] * 2], np.int32)
    kw = dict(num_queries=3, n_layers=2, cross_attention_freq=1, **QF)
    jm = jax_bert.Blip2QFormer(vocab_size=50, **kw)
    port = bert.Blip2QFormer(enc_dim=20, text=True, vocab_size=50, **kw)
    port = check_module(jm, port, [_normal(41, 2, 6, 20), ids, mask], 42)
    assert port.bert.layer_1.ffn is not None
    assert port.bert.word_embeddings.weight.shape == (50, 16)
    with pytest.raises(ValueError, match="text=True"):
        bert.Blip2QFormer(enc_dim=20, **kw)(
            torch.zeros(2, 6, 20), torch.from_numpy(ids))


@pytest.mark.parametrize("which", ["qformer", "projector"])
def test_qformer_and_projector_match_jax(which):
    args = [_normal(2, 2, 9, 20)]
    if which == "qformer":
        kw = dict(dim=16, num_layers=2, num_heads=4, num_queries=5,
                  intermediate=24)
        jm, port = jax_qf.QFormer(**kw), qformer.QFormer(**kw, enc_dim=20)
    else:
        kw = dict(dim=16, out_dim=12, num_queries=6, num_layers=2,
                  num_heads=4)
        jm = jax_qf.EncoderProjectorQFormer(**kw)
        port = qformer.EncoderProjectorQFormer(**kw, enc_dim=20)
    check_module(jm, port, args, 3)


# --------------------------------------------------------------------------
# Hopfield
# --------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [0, 2])
@pytest.mark.parametrize("shared", [False, True])
def test_hopfield_retrieve_matches_jax(steps, shared):
    """Per-batch keys and values, or one bank shared by the batch (the
    port's form of a broadcast bank) against the JAX broadcast."""
    q, k, v = _normal(4, 2, 5, 3, 8), _normal(5, 7, 3, 8), _normal(6, 7, 3, 6)
    jk, jv = (np.broadcast_to(a, (2, *a.shape)) for a in (k, v))
    want = jax_hop.hopfield_retrieve(jnp.asarray(q), jnp.asarray(jk),
                                     jnp.asarray(jv), 0.7, steps)
    tk, tv = (torch.from_numpy(a if shared else np.ascontiguousarray(b))
              for a, b in ((k, jk), (v, jv)))
    got = hopfield.hopfield_retrieve(torch.from_numpy(q), tk, tv, 0.7, steps)
    _close(got, want)


def test_hopfield_matches_jax():
    """A query and per-item stored patterns of two widths, 2 heads, 1
    update step, an output width of its own."""
    args = [_normal(7, 2, 5, 12), _normal(8, 2, 9, 10)]
    kw = dict(hidden=8, num_heads=2, pattern_dim=4, out_dim=14,
              update_steps_max=1, scaling=0.5)
    check_module(jax_hop.Hopfield(**kw),
                 hopfield.Hopfield(12, stored_dim=10, **kw),
                 args, 10, zero_grads=None)  # an update step reads K


@pytest.mark.parametrize("steps", [0, 1])
def test_hopfield_with_separate_values_matches_jax(steps):
    """``values`` of their own width (6) beside the stored patterns (10),
    normalized by ``norm_pattern`` at that width; without an update step
    a shift of every key leaves the softmax, so the key-side biases have
    a gradient of 0."""
    args = [_normal(43, 2, 5, 12), _normal(44, 2, 9, 10),
            _normal(45, 2, 9, 6)]
    kw = dict(hidden=8, num_heads=2, pattern_dim=4, update_steps_max=steps)
    port = hopfield.Hopfield(12, stored_dim=10, value_dim=6, **kw)
    check_module(jax_hop.Hopfield(**kw), port, args, 46,
                 zero_grads=None if steps else r"(k_proj|norm_stored)\.bias$")
    assert port.norm_pattern.weight.shape == (6,)


@pytest.mark.parametrize("bank", ["given-2d", "own"])
def test_hopfield_layer_matches_jax(bank):
    """AM-MRG's form (a given 2-D bank, scaling 4, pattern width = the
    query's) and the learned bank."""
    x = _normal(11, 3, 4, 16)
    kw = dict(hidden=12, num_heads=3, pattern_dim=16)
    # without an update step, a shift of every key leaves the softmax
    shifts = r"(k_proj|norm_stored)\.bias$"
    if bank == "own":
        check_module(jax_hop.HopfieldLayer(num_patterns=6, **kw),
                     hopfield.HopfieldLayer(16, num_patterns=6, **kw),
                     [x], 12, zero_grads=shifts)
        return
    kw["scaling"] = 4.0
    check_module(jax_hop.HopfieldLayer(**kw),
                 hopfield.HopfieldLayer(16, bank_dim=10, **kw),
                 [x, _normal(13, 11, 10)], 14, zero_grads=shifts)


def test_hopfield_pooling_matches_jax():
    check_module(jax_hop.HopfieldPooling(hidden=8, num_queries=3,
                                         num_heads=2, update_steps_max=1),
                 hopfield.HopfieldPooling(10, 8, num_queries=3, num_heads=2,
                                          update_steps_max=1),
                 [_normal(15, 2, 6, 10)], 16, zero_grads=None)


# --------------------------------------------------------------------------
# R-GCN heads
# --------------------------------------------------------------------------


def _graph(seed, n=6, e=10, real=7):
    """(N+1, D) node features with a zero dummy row, and ``e`` edges of
    which the last ``e - real`` are pads at the dummy row (type 0)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n + 1, 8)).astype(np.float32)
    h[n] = 0.0
    ei = np.full((2, e), n, np.int32)
    ei[:, :real] = rng.integers(0, n, (2, real))
    et = np.zeros(e, np.int32)
    et[:real] = rng.integers(0, 3, real)
    et[0], ei[:, 0], ei[:, 1] = 1, (2, 4), (3, 4)  # two edges into node 4
    return h, ei, et


def test_rgcn_conv_with_pad_edges_matches_jax():
    h, ei, et = _graph(17)
    w_rel, w_self = _normal(18, 3, 8, 5), _normal(19, 8, 5)
    want = jax_rgcn.rgcn_conv(*map(jnp.asarray, (h, ei, et, w_rel, w_self)))
    got = rgcn.rgcn_conv(*map(torch.from_numpy, (h, ei, et, w_rel, w_self)))
    _close(got, want)


def test_rgcn_matches_jax():
    check_module(jax_rgcn.RGCN(hidden=12, out_dim=6),
                 rgcn.RGCN(8, 12, 6), list(_graph(20)), 21)


def test_fusion_matches_jax():
    feats = [[_normal(22 + s, 2, n, 16) for s, n in enumerate((3, 5, 4))]]
    check_module(
        jax_rgcn.MultiScaleSelfAttentionFusion(dim=16, num_scales=3,
                                               num_heads=4, max_nodes=8),
        rgcn.MultiScaleSelfAttentionFusion(16, 3, 4, max_nodes=8),
        feats, 25)


def test_cross_block_matches_jax():
    check_module(jax_rgcn.ResidualCrossAttentionBlock(dim=16, num_heads=4),
                 rgcn.ResidualCrossAttentionBlock(16, 4),
                 [_normal(26, 2, 5, 16), _normal(27, 2, 9, 16)], 28)


def test_lookup_into_a_shared_bank_matches_jax():
    check_module(jax_rgcn.CrossAttentionLookup(dim=16),
                 rgcn.CrossAttentionLookup(16, bank_dim=12),
                 [_normal(29, 3, 4, 16), _normal(30, 10, 12)], 31)


def test_lookup_into_per_item_banks_matches_jax():
    """A (B, M, bank_dim) bank, one a row, taken as it is."""
    check_module(jax_rgcn.CrossAttentionLookup(dim=16),
                 rgcn.CrossAttentionLookup(16, bank_dim=12),
                 [_normal(47, 3, 4, 16), _normal(48, 3, 10, 12)], 49)


# --------------------------------------------------------------------------
# R2GenGPT's projector: qformer
# --------------------------------------------------------------------------

LLM_KW = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64,
              vocab_size=40)
ARM_KW = dict(patch_size=8, embed_dim=16, depth=1, d_state=4)


def test_r2gengpt_qformer_projector_matches_jax():
    """``encode_img`` (64 queries of 768 into the LLM's 32) and the loss,
    with every parameter's gradient, on a tiny ARM."""
    rng = np.random.default_rng(32)
    batch = [rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32),
             rng.integers(4, 40, (2, 3)).astype(np.int32),
             rng.integers(4, 40, (2, 2)).astype(np.int32),
             rng.integers(4, 40, (2, 5)).astype(np.int32),
             np.array([[1] * 5, [1] * 3 + [0] * 2], np.int32)]
    jm = jax_mrg.R2GenGPT(
        llm_cfg=jax_llm.LLMConfig(**LLM_KW, dtype=jnp.float32), chosen="arm",
        vision_kwargs=dict(ARM_KW, scan_backend="ref"), projector="qformer")
    port = mrg.R2GenGPT(
        llm.LLMConfig(**LLM_KW, dtype=torch.float32), chosen="arm",
        vision_kwargs=dict(ARM_KW, img_size=32), projector="qformer")
    assert not hasattr(port, "proj") and port.proj_q.linear.out_features == 32
    port = check_module(jm, port, batch, 33,
                        apply=lambda m, p, *a: m.apply(p, *a)[None],
                        forward=lambda m, *a: m(*a)[None])
    with torch.no_grad():
        got = port.encode_img(torch.from_numpy(batch[0]))
    params = _params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *_to_jax(batch))), 33)
    want = jm.apply(params, jnp.asarray(batch[0]),
                    method=jax_mrg.R2GenGPT.encode_img)
    assert got.shape == (2, 64, 32)
    _close(got, want)
