"""The reference's PyTorch checkpoints through ``ckpt/torch_import.py``, on CPU.

For every map, a synthetic state dict in its source's layout
(``tests/ref_ckpt_files.py``, small non-square widths): the port's tree
equals the JAX map's leaf for leaf (exact), loads strictly into the port's
module (``load_jax_params``: no missing and no unexpected name), and the
port's forward equals the JAX module's on the JAX map's tree, fp32, within
2e-5 of the output's largest magnitude (at least 1; one variant of each
map runs the forward, the others load strictly). Also
``interpolate_pos_embed`` growing and shrinking against ``jax.image``'s
bicubic (2e-6), ``replicate_dir_weights`` and ``strip_prefix`` (exact), and
``load_torch_state_dict`` reading a released file's wrapper and its
``argparse.Namespace`` but refusing any other object.
"""

import fractions
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_analysis_tpu.ckpt import torch_import as jax_ti
from medical_image_analysis_tpu.models import bert as jax_bert
from medical_image_analysis_tpu.models import hopfield as jax_hopfield
from medical_image_analysis_tpu.models import mamba as jax_mamba
from medical_image_analysis_tpu.models import r2gen as jax_r2gen
from medical_image_analysis_tpu.models import rgcn as jax_rgcn
from medical_image_analysis_tpu.models import swin as jax_swin
from medical_image_analysis_tpu.models import vit as jax_vit
from medical_image_analysis_tpu.models import vmamba as jax_vmamba
from medical_image_analysis_tpu_torch.ckpt import torch_import as ti
from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
from medical_image_analysis_tpu_torch.models import bert, hopfield, r2gen, rgcn
from medical_image_analysis_tpu_torch.models import swin, vit, vmamba
from medical_image_analysis_tpu_torch.models.mamba import ARM

sys.path.insert(0, str(Path(__file__).resolve().parent))
import ref_ckpt_files as ref  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_tree(got, want, path=""):
    """The port's numpy tree equals the JAX map's, leaf for leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, np.ndarray), path
        w = np.asarray(want)
        assert got.shape == w.shape and got.dtype == w.dtype, path
        np.testing.assert_array_equal(got, w, err_msg=path)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got) - want).max() <= TOL * scale


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _maps(name, sd, *args):
    """(JAX tree, port tree) of the map ``name``, held equal."""
    want = getattr(jax_ti, name)(sd, *args)
    got = getattr(ti, name)(sd, *args)
    _same_tree(got, want)
    return want, got


def _port(module, tree):
    return load_jax_params(module.eval(), tree)


# --------------------------------------------------------------------------
# the towers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dirs", [4, 1], ids=["four_dirs", "stage1"])
def test_arm_map(dirs):
    sd = ref.arm_sd(np.random.default_rng(0), depth=2, dim=24, d_state=4,
                    patch=8, img=32, dirs=dirs)
    if dirs == 1:
        rep = ti.replicate_dir_weights(sd)
        assert rep.keys() == jax_ti.replicate_dir_weights(sd).keys()
        assert rep["layers.0.mixer.A_c_b_log"] is sd["layers.0.mixer.A_log"]
        sd = rep
    want, got = _maps("arm_torch_to_flax", sd, 2)
    kw = dict(patch_size=8, embed_dim=24, depth=2, d_state=4,
              drop_path_rate=0.0)
    port = _port(ARM(**kw, img_size=32), got)
    if dirs == 1:  # the forward is the four-direction case's
        return
    x = _x(1, 2, 32, 32, 3)
    ref_out = jax.jit(jax_mamba.ARM(**kw, scan_backend="ref").apply)(
        want, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), ref_out)


@pytest.mark.parametrize("v2", [True, False], ids=["vssm1", "vssm_v1"])
def test_vssm_map(v2):
    depths, dims = (1, 1), (16, 24)
    kw = (dict(d_state=1, conv_bias=False, disable_z=True, patch_v2=True)
          if v2 else dict(d_state=4, conv_bias=True, disable_z=False,
                          patch_v2=False))
    sd = ref.vssm_sd(np.random.default_rng(2), depths=depths, dims=dims, **kw)
    want, got = _maps("vssm_torch_to_flax", sd, list(depths))
    mkw = dict(depths=depths, dims=dims, d_state=kw["d_state"],
               conv_bias=kw["conv_bias"], disable_z=kw["disable_z"],
               patch_embed_version="v2" if v2 else "v1",
               drop_path_rate=0.0)
    port = _port(vmamba.VSSM(**mkw, scan_backend="plain"), got)
    if not v2:  # the forward is vssm1's
        return
    x = _x(3, 2, 32, 32, 3)
    ref_out = jax.jit(jax_vmamba.VSSM(**mkw, scan_backend="ref").apply)(
        want, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), ref_out)


def test_swin_map():
    kw = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 4), window_size=4)
    sd = ref.swin_hf_sd(np.random.default_rng(4), embed_dim=8, depths=(2, 2),
                        num_heads=(2, 4), window=4)
    want, got = _maps("swin_hf_to_flax", sd, [2, 2])
    port = _port(swin.SwinTransformer(**kw, drop_path_rate=0.0,
                                      img_size=32), got)
    x = _x(5, 2, 32, 32, 3)
    ref_out = jax.jit(jax_swin.SwinTransformer(
        **kw, drop_path_rate=0.0).apply)(want, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), ref_out)


def test_vit_map():
    sd = ref.vit_timm_sd(np.random.default_rng(6), depth=2, dim=24, patch=8,
                         img=32)
    want, got = _maps("vit_torch_to_flax", sd, 2, True)
    kw = dict(patch_size=8, embed_dim=24, depth=2, num_heads=2,
              fixed_sincos_pos=False)
    port = _port(vit.ViT(**kw, img_size=32), got)
    x = _x(7, 2, 32, 32, 3)
    ref_out = jax.jit(jax_vit.ViT(**kw).apply)(want, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), ref_out)


# --------------------------------------------------------------------------
# the text towers and heads
# --------------------------------------------------------------------------

BERT = dict(vocab_size=50, dim=24, n_layers=2, n_heads=4, intermediate=40,
            max_position=16)


@pytest.mark.parametrize("pool", [None, "cls"])
def test_bert_map(pool):
    sd = ref.bert_hf_sd(np.random.default_rng(8), n_layers=2, dim=24,
                        intermediate=40, vocab=50, max_position=16)
    want, got = _maps("bert_hf_to_flax", sd, 2)
    cfg = bert.BertConfig(**BERT)
    port = _port(bert.BertModel(cfg, pooler=True), got)
    ids = np.random.default_rng(9).integers(1, 50, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    ref_out = jax.jit(lambda p, i, m: jax_bert.BertModel(
        jax_bert.BertConfig(**BERT)).apply(p, input_ids=i, attention_mask=m,
                                           pool=pool))(
        want, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = port(input_ids=torch.from_numpy(ids),
                   attention_mask=torch.from_numpy(mask), pool=pool)
    _close(out.numpy(), ref_out)
    with pytest.raises(ValueError, match="pooler"):
        bert.BertModel(cfg)(input_ids=torch.from_numpy(ids), pool="cls")


@pytest.mark.parametrize("lavis", [True, False], ids=["lavis", "hf"])
def test_blip2_qformer_map(lavis):
    sd = ref.qformer_lavis_sd(np.random.default_rng(10), n_layers=2, dim=24,
                              intermediate=40, enc_dim=20, num_queries=5)
    if not lavis:  # HF Blip2QFormerModel's names
        sd = {k.replace("Qformer.bert.", "").replace(
                  ".attention.self.", ".attention.attention.").replace(
                  ".crossattention.self.", ".crossattention.attention.")
              .replace("embeddings.LayerNorm", "layernorm"): v
              for k, v in sd.items()}
    want, got = _maps("blip2_qformer_to_flax", sd, 2)
    port = bert.Blip2QFormer(num_queries=5, dim=24, n_layers=2, n_heads=4,
                             intermediate=40, enc_dim=20, text_ffn=True)
    queries = sd["query_tokens"]
    _port(port, {"query_tokens": queries, "bert": got["params"]})
    img = _x(11, 2, 7, 20)
    cfg = jax_bert.BertConfig(vocab_size=50, dim=24, n_layers=2, n_heads=4,
                              intermediate=40, cross_attention_freq=2,
                              query_ffn=True, use_embeddings=False)
    ref_out = jax.jit(lambda p, q, e: jax_bert.BertModel(cfg).apply(
        p, query_embeds=q, encoder_hidden_states=e,
        encoder_attention_mask=jnp.ones(e.shape[:2], jnp.int32),
        attention_mask=jnp.zeros((2, 0), jnp.int32)))(
        want, jnp.broadcast_to(jnp.asarray(queries), (2, 5, 24)),
        jnp.asarray(img))
    with torch.no_grad():
        _close(port(torch.from_numpy(img)).numpy(), ref_out)


@pytest.mark.parametrize("norms", [3, 1], ids=["all_norms", "state_norm"])
def test_hopfield_map(norms):
    names = ("norm_state_pattern", "norm_stored_pattern",
             "norm_pattern_projection")[:norms]
    sd = ref.hopfield_sd(np.random.default_rng(12), in_dim=24, hidden=12,
                         num_heads=2, pattern_dim=10, stored_dim=20,
                         out_dim=24, norms=names)
    want, got = _maps("hopfield_torch_to_flax", sd)
    on = {ours: theirs in names for theirs, ours in ti._HOPFIELD_NORMS}
    port = _port(hopfield.Hopfield(24, 12, num_heads=2, pattern_dim=10,
                                   stored_dim=20, scaling=0.5, **on), got)
    q, stored = _x(13, 2, 3, 24), _x(14, 2, 6, 20)
    ref_out = jax.jit(jax_hopfield.Hopfield(
        hidden=12, num_heads=2, pattern_dim=10, scaling=0.5, **on).apply)(
        want, jnp.asarray(q), jnp.asarray(stored))
    with torch.no_grad():
        _close(port(torch.from_numpy(q), torch.from_numpy(stored)).numpy(),
               ref_out)


def test_cross_block_map():
    sd = ref.cross_block_sd(np.random.default_rng(15), dim=24)
    want, got = _maps("cross_block_torch_to_flax", sd)
    port = _port(rgcn.ResidualCrossAttentionBlock(24, 4), got)
    q, ctx = _x(16, 2, 3, 24), _x(17, 2, 5, 24)
    ref_out = jax.jit(jax_rgcn.ResidualCrossAttentionBlock(24, 4).apply)(
        want, jnp.asarray(q), jnp.asarray(ctx))
    with torch.no_grad():
        _close(port(torch.from_numpy(q), torch.from_numpy(ctx)).numpy(),
               ref_out)


@pytest.mark.parametrize("att_embed", [True, False])
def test_r2gen_map(att_embed):
    kw = dict(d_model=16, d_ff=24, num_layers=2, num_heads=4,
              rm_num_slots=3, rm_num_heads=4)
    sd = ref.r2gen_sd(np.random.default_rng(18), vocab=30, att_dim=16,
                      d_model=16, d_ff=24, num_layers=2)
    if not att_embed:  # the identity is installed
        del sd["att_embed.weight"], sd["att_embed.bias"]
    want, got = _maps("r2gen_torch_to_flax", sd, 2)
    port = _port(r2gen.R2Gen(30, 16, **kw), got)
    if not att_embed:  # the forward is the other case's
        return
    feats = _x(19, 2, 9, 16)
    seq = np.random.default_rng(20).integers(0, 30, (2, 7)).astype(np.int32)
    ref_out = jax.jit(jax_r2gen.R2Gen(vocab_size=30, **kw).apply)(
        want, jnp.asarray(feats), jnp.asarray(seq))
    with torch.no_grad():
        _close(port(torch.from_numpy(feats), torch.from_numpy(seq)).numpy(),
               ref_out)


# --------------------------------------------------------------------------
# the surgeries and the file reader
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(4, 7), (7, 4), (6, 6), (14, 3)],
                         ids=["grow", "shrink", "same", "shrink_more"])
def test_interpolate_pos_embed(grid):
    old, new = grid
    pos = _x(21, 1, 1 + old * old, 8)
    want = jax_ti.interpolate_pos_embed(pos, new * new)
    got = ti.interpolate_pos_embed(pos, new * new)
    assert got.shape == want.shape == (1, 1 + new * new, 8)
    np.testing.assert_array_equal(got[:, :1], pos[:, :1])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-6)


def test_strip_prefix():
    sd = {"module.a": 1, "module.b.c": 2, "other": 3}
    assert ti.strip_prefix(sd, "module.") == jax_ti.strip_prefix(
        sd, "module.") == {"a": 1, "b.c": 2}


@pytest.mark.parametrize("wrap", [None, "model", "model_state_dict"])
def test_load_torch_state_dict(tmp_path, wrap):
    sd = {"a.weight": _x(22, 3, 2), "b": _x(23, 4)}
    path = tmp_path / "ckpt.pth"
    ref.save_pth(path, sd, wrap)
    got = ti.load_torch_state_dict(str(path))
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])
    if wrap != "model_state_dict":  # the JAX reader does not unwrap it
        want = jax_ti.load_torch_state_dict(str(path))
        assert set(want) == set(sd)


def test_load_torch_state_dict_refuses_other_objects(tmp_path):
    path = tmp_path / "ckpt.pth"
    torch.save({"model": {"w": torch.zeros(2)},
                "args": fractions.Fraction(1, 3)}, path)
    with pytest.raises(Exception, match="Fraction|weights_only"):
        ti.load_torch_state_dict(str(path))


def test_chip_smoke_and_file_makers_never_import_jax():
    """``chip_smoke.py`` (its reference cases built) and the file makers of
    ``tests/`` import neither JAX, flax nor the JAX package."""
    import subprocess

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(root / 'tests')!r}]\n"
        "import chip_smoke, ref_ckpt_files, jax_state_files, dicom_files\n"
        "chip_smoke._ref_cases()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'medical_image_analysis_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
