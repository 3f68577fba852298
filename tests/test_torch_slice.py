"""The port's serving slice against the JAX package on CPU.

Tiny R2GenGPT (ARM 32x32, depth 2; tiny_test LM in fp32), one JAX init
loaded into both packages: generated tokens must be identical, and the
teacher-forced loss must agree within fp32 summation-order error (1e-5).
Also: the demo server answers a POST, the preset builds at full width
(on the meta device, allocating nothing), and the port never imports jax.
"""

import argparse
import base64
import dataclasses
import io
import json
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medical_image_analysis_tpu.models import llm as jax_llm
from medical_image_analysis_tpu.models import mrg as jax_mrg
from medical_image_analysis_tpu_torch.ckpt.from_jax import load_jax_params
from medical_image_analysis_tpu_torch.models import llm, mrg

ARM_KW = dict(patch_size=16, embed_dim=32, depth=2, d_state=4)
GEN = dict(max_new_tokens=10, min_new_tokens=3, repetition_penalty=2.0,
           length_penalty=2.0, no_repeat_ngram_size=2, eos_id=2,
           max_cache_len=64)


def _tiny_pair():
    c = jax_llm.LLM_CONFIGS["tiny_test"]
    fields = dict(vocab_size=c.vocab_size, dim=c.dim, n_layers=c.n_layers,
                  n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
                  hidden_dim=c.hidden_dim)
    jm = jax_mrg.R2GenGPT(
        llm_cfg=jax_llm.LLMConfig(**fields, dtype=jnp.float32),
        chosen="arm", vision_kwargs=ARM_KW,
    )
    port = mrg.R2GenGPT(
        llm.LLMConfig(**fields, dtype=torch.float32), chosen="arm",
        vision_kwargs=dict(ARM_KW, img_size=32),
    ).eval()
    rng = np.random.default_rng(0)
    batch = dict(
        images=rng.standard_normal((2, 1, 32, 32, 3)).astype(np.float32),
        before_ids=rng.integers(4, c.vocab_size, (2, 5)).astype(np.int32),
        after_ids=rng.integers(4, c.vocab_size, (2, 3)).astype(np.int32),
        target_ids=rng.integers(4, c.vocab_size, (2, 6)).astype(np.int32),
        target_mask=np.array([[1] * 6, [1] * 4 + [0] * 2], np.int32),
    )
    params = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(v)
                                               for v in batch.values()))
    load_jax_params(port, params)
    return jm, params, port, batch


@pytest.mark.parametrize("num_beams,beam_ancestry", [
    (3, True),   # shared-prompt prefill + split ancestry cache
    (3, False),  # replicated prompt + per-step cache reorder
    (1, True),   # greedy
])
def test_generate_token_exact_vs_jax(num_beams, beam_ancestry):
    jm, params, port, batch = _tiny_pair()
    keys = ("images", "before_ids", "after_ids")
    want = jm.apply(
        params, *(jnp.asarray(batch[k]) for k in keys),
        jax_mrg.GenerateConfig(num_beams=num_beams,
                               beam_ancestry=beam_ancestry, **GEN),
        method=jax_mrg.R2GenGPT.generate,
    )
    got = port.generate(
        *(torch.from_numpy(batch[k]) for k in keys),
        mrg.GenerateConfig(num_beams=num_beams, beam_ancestry=beam_ancestry,
                           **GEN),
    )
    assert got.shape == (2, GEN["max_new_tokens"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_teacher_forced_loss_matches_jax():
    jm, params, port, batch = _tiny_pair()
    want = jm.apply(params, *(jnp.asarray(v) for v in batch.values()))
    with torch.no_grad():
        got = port(*(torch.from_numpy(v) for v in batch.values()))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)


def test_demo_server_answers_post(tmp_path):
    from medical_image_analysis_tpu_torch.cli.demo import (
        build_pipeline,
        make_server,
    )
    import PIL.Image

    cfg = {
        "data": {"input_size": 32},
        "model": {"task": "r2gengpt", "vision": "arm",
                  "vision_kwargs": ARM_KW,
                  "llm_kwargs": {"dim": 32, "n_layers": 1, "n_heads": 4,
                                 "n_kv_heads": 2, "hidden_dim": 64}},
        "generate": {"max_new_tokens": 5, "min_new_tokens": 2,
                     "max_cache_len": 64},
    }
    path = tmp_path / "demo.yaml"
    path.write_text(yaml.safe_dump(cfg))
    report_for = build_pipeline(argparse.Namespace(
        config=str(path), vocab=None, vocab_size=40, delta=None,
        device="cpu", seed=0,
    ))
    img = np.random.default_rng(0).integers(0, 255, (48, 40, 3),
                                            dtype=np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="PNG")
    server = make_server(report_for, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate",
            data=json.dumps(
                {"image": base64.b64encode(buf.getvalue()).decode()}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert out == report_for(img)
    assert len(out["ids"]) == 5 and all(0 <= i < 40 for i in out["ids"])


def test_preset_builds_published_widths():
    """r2gengpt_mimic: ARM-B 768x12 + qwen1_5_1_8b, on the meta device."""
    from medical_image_analysis_tpu_torch.configs.config import (
        PRESET_DIR,
        load_config,
    )
    from medical_image_analysis_tpu_torch.train.loop import build_mrg_model

    cfg = load_config(str(PRESET_DIR / "r2gengpt_mimic.yaml"))
    assert dataclasses.asdict(cfg.generate)["num_beams"] == 3
    model = build_mrg_model(cfg, 151936, device="meta")
    arm = model.vision.arm
    assert len(arm.layers) == 12 and arm.pos_embed.shape == (1, 197, 768)
    assert model.llm_cfg == dataclasses.replace(
        llm.LLM_CONFIGS["qwen1_5_1_8b"], vocab_size=151936)
    assert model.llm.lm_head.weight.shape == (151936, 2048)


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import medical_image_analysis_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'medical_image_analysis_tpu'))\n"
        "assert len(mods) > 15, mods\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
