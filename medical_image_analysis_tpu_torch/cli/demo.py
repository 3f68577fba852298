"""Serving demo on one device: preprocess -> encode -> beam generate -> decode.

Counterpart of ``medical_image_analysis_tpu/cli/demo.py``. Modes:
  one-shot:  python -m medical_image_analysis_tpu_torch.cli.demo --image x.png
  server:    ... --serve 8080   (JSON API: POST /generate {"image": b64})

Weights are random, drawn from ``--seed``; loading checkpoints is not
ported yet. ``--device`` defaults to ``cuda`` and nothing falls back to
the CPU: pass ``--device cpu`` to run there.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json

import numpy as np
import torch

from ..configs.config import load_config, make_config
from ..data.preprocessing import host_preprocess
from ..data.tokenizer import WordTokenizer
from ..models.common import init_params
from ..train.loop import build_mrg_model


class Pipeline:
    """``report_for``: uint8 (H, W, 3) image -> {"report", "ids"}."""

    def __init__(self, model, tok, gcfg, before, after, size):
        self.model, self.tok, self.gcfg = model, tok, gcfg
        self.before, self.after, self.size = before, after, size

    @property
    def device(self) -> torch.device:
        return self.before.device

    def preprocess(self, img_u8: np.ndarray) -> torch.Tensor:
        x = host_preprocess(img_u8, self.size)[None, None]
        return torch.from_numpy(x).to(self.device)

    def __call__(self, img_u8: np.ndarray) -> dict:
        out = self.model.generate(self.preprocess(img_u8), self.before,
                                  self.after, self.gcfg)
        ids = out[0].tolist()
        return {"report": self.tok.decode(ids), "ids": ids}


def _tokenizer(args, cfg):
    if args.vocab:
        return WordTokenizer.load(args.vocab)
    if cfg.data.tokenizer_dir:
        raise NotImplementedError(
            "HF tokenizer files (data.tokenizer_dir) are not ported yet "
            "(ROADMAP.md, queue 1, item 9)"
        )
    return WordTokenizer(["the", "lungs", "are", "clear", "."])


def build_pipeline(args) -> Pipeline:
    """Build the model on ``args.device`` with weights from ``args.seed``.

    ``args.vocab_size`` (optional) sizes the LM vocabulary; by default it
    is the tokenizer's. Ids past the tokenizer decode as "<unk>".
    """
    if args.delta:
        raise NotImplementedError(
            "delta checkpoints are not ported yet (ROADMAP.md, queue 1, "
            "item 9)"
        )
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
    device = torch.device(args.device)
    model = build_mrg_model(cfg, vocab_size, device=device)
    init_params(model, torch.Generator(device).manual_seed(args.seed))
    model.eval()
    gcfg = dataclasses.replace(cfg.generate, eos_id=tok.EOS, num_beams=3)

    def ids(text, **kw):
        return torch.tensor([tok.encode(text, **kw)], device=device)

    return Pipeline(
        model, tok, gcfg, ids(cfg.data.prompt, add_bos=True),
        ids(cfg.data.prompt_after), cfg.data.input_size,
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

    report_for = build_pipeline(args)

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


if __name__ == "__main__":
    main()
