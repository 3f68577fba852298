"""MAC-RRG's refinement CLI: draft -> agents -> regenerate, then the scores.

Usage:
  python -m medical_image_analysis_tpu_torch.cli.mac_refine \\
      --config .../mac_rrg_mimic.yaml [--delta checkpoint_epochN_....pt] \\
      [--rounds 1] [--split val] [--max-batches 20] [--set key=value]

Counterpart of ``medical_image_analysis_tpu/cli/mac_refine.py``; the
delta is one that ``cli.train`` wrote for the preset, or one that the JAX
package's ``cli.train`` wrote (``.msgpack``). ``--device``
defaults to ``cuda``, and the CLI raises when there is no CUDA device: it
does not fall back to the CPU (pass ``--device cpu`` to refine there).
Prints one JSON line of the draft's and the refined reports' scores.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..configs.config import load_config, make_config
from ..train.mac_driver import refine_mac_rrg


def main(argv=None, on_start=None) -> dict:
    """Parse ``argv``, refine, print the scores and return
    ``refine_mac_rrg``'s result. ``on_start`` is handed to it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--delta", default="",
                    help="trainable-delta checkpoint of the mac_rrg recipe")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--split", default="val")
    ap.add_argument("--max-batches", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cli.mac_refine: --device cuda but no CUDA device is "
                         "available; pass --device cpu to refine on the CPU")
    if args.config:
        cfg = load_config(args.config, args.overrides)
    else:
        cfg = make_config({}, args.overrides)
    cfg.model.task = "mac_rrg"

    out = refine_mac_rrg(
        cfg, delta_file=args.delta, rounds=args.rounds, split=args.split,
        max_batches=args.max_batches, device=device, on_start=on_start,
    )
    print(json.dumps({"draft": out["draft"], "refined": out["refined"]}))
    return out


if __name__ == "__main__":
    main()
