"""Weights from the seed, made on the device in a few large draws.

A family's reference lists its tensors (``param_specs``): a name, a
shape, a dtype and how the tensor is drawn. :func:`make` draws every
normal tensor of one dtype from one ``randn`` call and every uniform one
from one ``rand`` call, each tensor a slice of those, so the same seed
gives the same tensors on both sides of the comparison and the draw costs
a few kernels, not one a tensor. The same names are loaded into the
program (:func:`load_into`) and handed to the reference.

Draws (``init``): ``["normal", std]``, ``["uniform", lo, hi]``,
``["const", value]``, ``["log_arange"]`` (``log(1..n)`` along the last
axis, Mamba's ``A_log``) and ``["dt_bias", dt_min, dt_max, floor]`` (the
inverse softplus of a log-uniform step in ``[dt_min, dt_max]``).
"""

from __future__ import annotations

import math

import torch

from harness import BenchError, derive

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def make(specs: list[dict], seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device).manual_seed(derive(seed, "weights"))
    out: dict[str, torch.Tensor] = {}
    normal: dict[torch.dtype, list[dict]] = {}
    uniform: list[dict] = []
    for s in specs:
        kind = s["init"][0]
        if kind == "normal":
            normal.setdefault(DTYPES[s["dtype"]], []).append(s)
        elif kind in ("uniform", "dt_bias"):
            uniform.append(s)
    for dtype, group in normal.items():
        buf = torch.randn(sum(_numel(s["shape"]) for s in group),
                          generator=gen, device=device, dtype=dtype)
        off = 0
        for s in group:
            n = _numel(s["shape"])
            out[s["name"]] = buf[off:off + n].view(s["shape"]).mul_(
                s["init"][1])
            off += n
    if uniform:
        buf = torch.rand(sum(_numel(s["shape"]) for s in uniform),
                         generator=gen, device=device)
        off = 0
        for s in uniform:
            n = _numel(s["shape"])
            u = buf[off:off + n].view(s["shape"])
            off += n
            if s["init"][0] == "uniform":
                lo, hi = s["init"][1:]
                t = u.mul_(hi - lo).add_(lo)
            else:
                dt_min, dt_max, floor = s["init"][1:]
                dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                               + math.log(dt_min)).clamp_min(floor)
                t = dt + torch.log(-torch.expm1(-dt))
            out[s["name"]] = t.to(DTYPES[s["dtype"]])
    for s in specs:
        kind = s["init"][0]
        dtype = DTYPES[s["dtype"]]
        if kind == "const":
            out[s["name"]] = torch.full(s["shape"], float(s["init"][1]),
                                        device=device, dtype=dtype)
        elif kind == "log_arange":
            n = s["shape"][-1]
            a = torch.log(torch.arange(1, n + 1, device=device,
                                       dtype=torch.float32))
            out[s["name"]] = a.expand(s["shape"]).to(dtype).contiguous()
        elif s["name"] not in out:
            raise BenchError(f"unknown draw {s['init']} for {s['name']}")
    return {s["name"]: out[s["name"]] for s in specs}


@torch.no_grad()
def load_into(params: dict[str, torch.Tensor],
              weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the program's tensors of the same names; the
    two sets of names, shapes and dtypes must be equal."""
    if params.keys() != weights.keys():
        diff = sorted(set(params) ^ set(weights))
        raise BenchError(f"the program's tensors and the reference's "
                         f"differ: {diff[:8]}")
    for name, p in params.items():
        w = weights[name]
        if p.shape != w.shape or p.dtype != w.dtype:
            raise BenchError(f"{name}: program {tuple(p.shape)} {p.dtype}, "
                             f"reference {tuple(w.shape)} {w.dtype}")
        p.copy_(w)
