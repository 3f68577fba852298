"""Serving demo on one device: preprocess -> encode -> beam generate -> decode.

Counterpart of ``medical_image_analysis_tpu/cli/demo.py``. Modes:
  one-shot:  python -m medical_image_analysis_tpu_torch.cli.demo --image x.png
  server:    ... --serve 8080   (JSON API: POST /generate {"image": b64})

The weights are drawn from ``--seed``; then, as the JAX demo does, the
config's ``model.llm_weights_dir`` (an HF Llama/Qwen2 directory of
safetensors shards, ``model.llm_int8`` to serve int8 kernels) is streamed
over the LLM, and ``--delta`` (the port's ``.pt`` or the JAX package's
``.msgpack``, told apart by their bytes) over the trained tensors. A delta
of a LoRA run (``base/`` and ``lora/`` names) gets the run's adapters,
built from the config's ``train`` section as ``fit_mrg`` builds them. The
tokenizer is ``--vocab`` (a word vocabulary), else the ``tokenizer.json``
of ``data.tokenizer_dir`` or, failing that, of ``model.llm_weights_dir``
(``data/hf_tokenizer.py``). ``--device`` defaults to ``cuda`` and nothing
falls back to the CPU: pass ``--device cpu`` to run there.

Started by torchrun on N processes, the demo serves the LLM tensor-parallel
over all of them (``parallel.tp.shard_llm``, a (1, N) grid; each rank on
``cuda:LOCAL_RANK``, or sharing the host's card over gloo where the ranks
outnumber the cards): rank 0 reads the image and serves HTTP, and hands
each preprocessed image to the other ranks (a broadcast), which generate
with it and wait for the next.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import os

import numpy as np
import torch
from torch.nn.utils import parametrize

from ..ckpt.checkpoint import load_delta, merge_delta
from ..ckpt.from_jax import flax_named_parameters
from ..configs.config import load_config, make_config
from ..data.hf_tokenizer import HFTokenizer
from ..data.preprocessing import host_preprocess
from ..data.tokenizer import WordTokenizer
from ..models.common import init_params
from ..parallel.mesh import (
    broadcast,
    init_distributed,
    make_mesh,
    rank_device,
    world_and_rank,
)
from ..parallel.tp import shard_llm
from ..train.loop import build_mrg_model, mrg_trainables, splice_llm_weights


class Pipeline:
    """``report_for``: uint8 (H, W, 3) image -> {"report", "ids"}."""

    def __init__(self, model, tok, gcfg, before, after, size, mesh=None):
        self.model, self.tok, self.gcfg = model, tok, gcfg
        self.before, self.after, self.size = before, after, size
        self.mesh = mesh  # the tensor-parallel grid, or None

    @property
    def device(self) -> torch.device:
        return self.before.device

    def preprocess(self, img_u8: np.ndarray) -> torch.Tensor:
        x = host_preprocess(img_u8, self.size)[None, None]
        return torch.from_numpy(x).to(self.device)

    def __call__(self, img_u8: np.ndarray) -> dict:
        x = self.preprocess(img_u8)
        if self.mesh is not None:  # the followers' next image
            broadcast(torch.ones(1, device=self.device), self.mesh)
            broadcast(x, self.mesh)
        ids = self._generate(x)
        return {"report": self.tok.decode(ids), "ids": ids}

    def _generate(self, x: torch.Tensor) -> list[int]:
        with parametrize.cached():  # LoRA-merged weights, once a request
            out = self.model.generate(x, self.before, self.after, self.gcfg)
        return out[0].tolist()

    def follow(self) -> int:
        """A rank other than 0: generate with each image rank 0 hands over
        until it stops; returns the images served."""
        n = 0
        while True:
            flag = broadcast(torch.zeros(1, device=self.device), self.mesh)
            if flag.item() == 0:
                return n
            x = broadcast(torch.zeros(1, 1, self.size, self.size, 3,
                                      device=self.device), self.mesh)
            self._generate(x)
            n += 1

    def stop(self) -> None:
        """Rank 0: release the followers."""
        if self.mesh is not None:
            broadcast(torch.zeros(1, device=self.device), self.mesh)


def _tokenizer(args, cfg):
    if args.vocab:
        return WordTokenizer.load(args.vocab)
    tok_dir = cfg.data.tokenizer_dir or cfg.model.llm_weights_dir
    if tok_dir:
        return HFTokenizer.from_file(os.path.join(tok_dir, "tokenizer.json"))
    return WordTokenizer(["the", "lungs", "are", "clear", "."])


def build_pipeline(args) -> Pipeline:
    """Build the model on ``args.device``: weights from ``args.seed``, the
    LLM from ``model.llm_weights_dir`` where set, then ``args.delta``.

    ``args.vocab_size`` (optional) sizes the LM vocabulary where no
    checkpoint does; by default it is the tokenizer's. Ids past the
    tokenizer decode as "<unk>" (a word vocabulary) or as nothing (an HF
    tokenizer, as its runtime decodes them).
    """
    cfg = load_config(args.config) if args.config else make_config({})
    if cfg.model.task != "r2gengpt":
        raise NotImplementedError(
            f"the demo serves task=r2gengpt (on either tower), as the JAX "
            f"package's demo does; got task={cfg.model.task!r}")
    tok = _tokenizer(args, cfg)
    vocab_size = getattr(args, "vocab_size", None) or tok.vocab_size
    if vocab_size < tok.vocab_size:
        raise ValueError(f"vocab_size {vocab_size} < tokenizer vocab "
                         f"{tok.vocab_size}")
    device = rank_device(args.device)
    model = build_mrg_model(cfg, vocab_size, device=device)
    init_params(model, torch.Generator(device).manual_seed(args.seed))
    model.eval()
    if cfg.model.llm_weights_dir:
        # serve the real streamed LLM weights (int8 too): the splice the
        # training recipes use
        splice_llm_weights(model, cfg)
    if args.delta:
        delta, meta = load_delta(args.delta)
        lora_run = any(n.startswith(("base/", "lora/")) for n in delta)
        named = (mrg_trainables(cfg, model)[0] if lora_run
                 else flax_named_parameters(model))
        merge_delta(named, delta)
        print(f"[demo] merged delta {args.delta} (epoch {meta['epoch']}, "
              f"{sum(v.numel() > 0 for v in delta.values())} tensors)")
    gcfg = dataclasses.replace(cfg.generate, eos_id=tok.EOS, num_beams=3)
    world, _ = world_and_rank()
    mesh = None
    if world > 1:
        mesh = make_mesh(data=1, model=world)
        shard_llm(model.llm, mesh)

    def ids(text, **kw):
        return torch.tensor([tok.encode(text, **kw)], device=device)

    return Pipeline(
        model, tok, gcfg, ids(cfg.data.prompt, add_bos=True),
        ids(cfg.data.prompt_after), cfg.data.input_size, mesh,
    )


def make_server(report_for, port: int):
    """HTTP JSON server: POST /generate {"image": <b64 png/jpg>} ->
    ``report_for(image)`` as JSON. Bind port 0 for an ephemeral port."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            import PIL.Image

            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or "{}")
            raw = base64.b64decode(req["image"])
            with PIL.Image.open(io.BytesIO(raw)) as pil:
                img = np.asarray(pil.convert("RGB"), np.uint8)
            body = json.dumps(report_for(img)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    return HTTPServer(("0.0.0.0", port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--vocab-size", type=int, default=None,
                    help="LM vocabulary size (default: the tokenizer's)")
    ap.add_argument("--delta", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--serve", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)
    init_distributed()

    report_for = build_pipeline(args)
    if world_and_rank()[1] != 0:
        report_for.follow()
        return

    try:
        if args.image:
            import PIL.Image

            with PIL.Image.open(args.image) as pil:
                img = np.asarray(pil.convert("RGB"), np.uint8)
            print(report_for(img)["report"])
            return

        if args.serve:
            server = make_server(report_for, args.serve)
            print(f"serving on :{server.server_address[1]}")
            try:
                server.serve_forever()
            finally:
                server.server_close()
    finally:
        report_for.stop()


if __name__ == "__main__":
    main()
