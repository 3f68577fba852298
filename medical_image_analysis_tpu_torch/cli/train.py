"""Training CLI of the port.

Usage:
  python -m medical_image_analysis_tpu_torch.cli.train --config cfg.yaml \\
      [--set train.lr=3e-4 --set data.dataset=synthetic] [--test|--validate]
      [--throughput]

Counterpart of ``medical_image_analysis_tpu/cli/train.py``; ``--throughput``
times the tower's forward passes (``cli/throughput.py``) and prints their
JSON instead of training. ``--device`` defaults to
``cuda``, and the CLI raises when there is no CUDA device: it does not
fall back to the CPU (pass ``--device cpu`` to train there).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..configs.config import load_config, make_config, save_config
from ..train.loop import fit


def main(argv=None, on_start=None) -> dict:
    """Parse ``argv``, train (or evaluate), print and return the scores (or
    the ``--throughput`` timings).

    ``on_start`` is handed to ``train.loop.fit`` (see ``fit_mrg``).
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument(
        "--set", action="append", default=[], dest="overrides",
        help="dotted override, e.g. train.lr=3e-4",
    )
    ap.add_argument("--throughput", action="store_true",
                    help="timed forward passes instead of training")
    ap.add_argument("--test", action="store_true",
                    help="eval-only on the test split")
    ap.add_argument("--validate", action="store_true",
                    help="eval-only on the val split")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cli.train: --device cuda but no CUDA device is "
                         "available; pass --device cpu to train on the CPU")
    if args.config:
        cfg = load_config(args.config, args.overrides)
    else:
        cfg = make_config({}, args.overrides)
    if args.test or args.validate:
        cfg.train.eval_only = True
        cfg.train.eval_split = "test" if args.test else "val"
        if not (cfg.train.resume or cfg.train.init_delta):
            cfg.train.resume = "auto"

    if args.throughput:
        from .throughput import run_throughput

        stats = run_throughput(cfg, device)
        print(json.dumps(stats))
        return stats

    os.makedirs(cfg.train.save_dir, exist_ok=True)
    save_config(cfg, os.path.join(cfg.train.save_dir, "config.yaml"))
    results = fit(cfg, device, on_start)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
