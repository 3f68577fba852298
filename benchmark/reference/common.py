"""Plain PyTorch pieces shared by the references: the products in a stated
precision, the norms and activations, and AdamW as optax computes it.

Nothing here, nor in any file of this folder, imports the program. Every
matrix product of a reference goes through :class:`Products`:

- ``exact``: fp32 operands (bf16 weights widened exactly) and fp32 sums,
  with TF32 off;
- ``lower``: the control, one step below what the configuration states:
  fp32 operands rounded to TF32 (10 explicit mantissa bits, nearest),
  bf16 operands rounded to fp8 e4m3 with a per-tensor scale, sums in
  fp32. The gradients' products round their operands alike.
"""

from __future__ import annotations

import math
import re
from contextlib import contextmanager

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away), as fp32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """-> fp8 e4m3 with the tensor's amax at 448, back in fp32."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _LowMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.rnd(g)
        return (rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg, None)


class Products:
    """``mm(a, b, low)``: ``a @ b`` in fp32; under ``lower``, with operands
    rounded by ``low`` (``"tf32"`` for products the configuration computes
    in fp32, ``"fp8"`` for those it computes in bf16)."""

    def __init__(self, precision: str = "exact"):
        if precision not in ("exact", "lower"):
            raise ValueError(precision)
        self.precision = precision

    def mm(self, a, b, low: str = "tf32"):
        a, b = a.float(), b.float()
        if self.precision == "exact":
            return a @ b
        return _LowMM.apply(a, b, round_tf32 if low == "tf32" else round_fp8)

    def linear(self, x, w, bias=None, low: str = "tf32"):
        """``x @ w.T + bias`` for a (out, in) weight."""
        y = self.mm(x, w.t(), low)
        return y if bias is None else y + bias.float()


@contextmanager
def exact_fp32():
    """TF32 off for every product in the block (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def layer_norm(x, scale, bias, eps):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def rms_norm(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.float()


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def softplus(x):
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps,
    weight_decay, mask))`` over named fp32 tensors, the schedule constant:
    the update scaled by ``clip / norm`` where the gradients' global norm
    is at least ``clip``; bias-corrected moments (the corrections in
    fp32); ``eps`` outside the root; decay ``wd * p`` added to the
    direction before the learning rate, on names that no pattern of
    ``no_decay`` matches."""

    def __init__(self, params: dict, opt: dict):
        self.params = params
        self.lr, self.wd = opt["lr"], opt["weight_decay"]
        self.b1, self.b2, self.eps = opt["b1"], opt["b2"], opt["eps"]
        self.clip = opt["grad_clip"]
        self.decay = {n: not any(re.search(p, n) for p in opt["no_decay"])
                      for n in params}
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(m) for n, m in self.mu.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm) if self.clip else 1.0
        self.count += 1
        f32 = torch.tensor
        c1 = float(1.0 - f32(self.b1, dtype=torch.float32) ** self.count)
        c2 = float(1.0 - f32(self.b2, dtype=torch.float32) ** self.count)
        for n, p in self.params.items():
            g = grads[n].float() * scale
            self.mu[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + self.eps)
            if self.wd and self.decay[n]:
                upd = upd + self.wd * p.float()
            p.add_((-self.lr * upd).to(p.dtype))


def masked_mean_ce(logits, labels, mask, denom):
    """Sum over the masked positions of -log p(label), over ``denom``
    (logits[t] predicts labels[t + 1])."""
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = torch.gather(lp, -1, labels[:, 1:, None].long())[..., 0]
    return -(ll * mask[:, 1:].float()).sum() / denom
