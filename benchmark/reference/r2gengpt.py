"""R2GenGPT with the ARM tower and a LoRA'd Qwen1.5 LLM, in plain PyTorch.

The step of R2GenGPT (arXiv:2311.10811) as MambaXray-VL fine-tunes it
(arXiv:2410.00379): each study's views through the ARM tower (a flat
Vim-style Mamba encoder: 16x16 patches, a cls token in the middle, blocks
of RMSNorm and a four-direction selective-scan mixer, row and column
order each forward and back), the views' tokens averaged, LayerNorm and a
Linear into the LLM's width, between the prompt's two parts; the LLM
(Qwen2's decoder: RMSNorm, rotary attention with q/k/v biases, SwiGLU)
with LoRA on q and v; the cross-entropy of the report's tokens, each
micro-batch's mean over its report tokens, the step's the mean of its
micro-batches'. The LLM is frozen; the tower, the projector and the
adapters train.

The selective scan (Gu and Dao, arXiv:2312.00752): per direction,
u = silu(causal depthwise conv(x) + b); [dt_raw | B | C] = u W_x^T;
dt = softplus(dt_raw W_dt^T + b_dt); h_t = exp(dt_t A) h_{t-1} +
dt_t u_t B_t; y_t = C_t . h_t + D u_t, with A = -exp(A_log).

Each product goes through :class:`reference.common.Products`: the tower's,
the projector's and the LLM head's as the configuration computes them in
fp32, the LLM's layers' as it computes them in bf16. In ``exact`` all are
fp32, the bf16 weights widened. The tower runs a micro-batch at a time,
each block under a checkpoint (the scan's states of a block take some
GB); the LLM runs ``ROWS`` studies at a time against the
tower's output detached, whose gradient then runs the tower's backward
once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import layer_norm, masked_mean_ce, rms_norm, softplus

# Studies through the LLM at a time: a study's fp32 logits over Qwen's
# vocabulary take about 190 MB, three times that with the backward's.
ROWS = 16


def _tower(cfg):
    t = cfg["model"]["tower"]
    d = t["embed_dim"]
    return (d, t["depth"], t["d_state"], t["patch_size"],
            d * t["expand"], t["dt_rank"] or math.ceil(d / 16),
            t["d_conv"], t["directions"])


def param_specs(cfg) -> list[dict]:
    m = cfg["model"]
    d, depth, n, p, di, rank, taps, k = _tower(cfg)
    llm = m["llm"]
    h, ff, vocab = llm["hidden_size"], llm["intermediate_size"], \
        llm["vocab_size"]
    lora = m["lora"]
    img = m["image_size"]
    specs = []

    def t(name, shape, init, dtype="float32"):
        specs.append({"name": name, "shape": list(shape), "init": init,
                      "dtype": dtype})

    def lecun(fan_in):
        return ["normal", fan_in ** -0.5]

    zero, one = ["const", 0.0], ["const", 1.0]
    a = "vision/arm"
    t(f"{a}/cls_token", (1, 1, d), ["normal", 0.02])
    t(f"{a}/pos_embed", (1, (img // p) ** 2 + 1, d), ["normal", 0.02])
    t(f"{a}/patch_embed/proj/kernel", (d, 3, p, p), lecun(3 * p * p))
    t(f"{a}/patch_embed/proj/bias", (d,), zero)
    for i in range(depth):
        x = f"{a}/layers_{i}"
        t(f"{x}/norm/scale", (d,), one)
        t(f"{x}/mixer/conv_w", (k, taps, di), ["uniform", -taps ** -0.5,
                                               taps ** -0.5])
        t(f"{x}/mixer/conv_b", (k, di), ["uniform", -taps ** -0.5,
                                         taps ** -0.5])
        t(f"{x}/mixer/x_proj_w", (k, rank + 2 * n, di),
          ["uniform", -di ** -0.5, di ** -0.5])
        t(f"{x}/mixer/dt_proj_w", (k, di, rank),
          ["uniform", -rank ** -0.5, rank ** -0.5])
        t(f"{x}/mixer/dt_bias", (k, di), ["dt_bias", 1e-3, 0.1, 1e-4])
        t(f"{x}/mixer/A_log", (k, di, n), ["log_arange"])
        t(f"{x}/mixer/D", (k, di), one)
        t(f"{x}/mixer/in_proj/kernel", (2 * di, d), lecun(d))
        t(f"{x}/mixer/out_proj/kernel", (d, di), lecun(di))
    t(f"{a}/norm_f/scale", (d,), one)
    t(f"{a}/norm_f/bias", (d,), zero)
    bf = llm["dtype"]
    t("llm/embed_tokens/embedding", (vocab, h), ["normal", h ** -0.5], bf)
    for i in range(llm["num_hidden_layers"]):
        x = f"llm/layers_{i}"
        t(f"{x}/input_layernorm/scale", (h,), one)
        for proj in ("q_proj", "k_proj", "v_proj"):
            t(f"{x}/self_attn/{proj}/kernel", (h, h), lecun(h), bf)
            if llm["attention_bias"]:
                t(f"{x}/self_attn/{proj}/bias", (h,), ["normal", 0.02], bf)
        t(f"{x}/self_attn/o_proj/kernel", (h, h), lecun(h), bf)
        t(f"{x}/post_attention_layernorm/scale", (h,), one)
        t(f"{x}/mlp/gate_proj/kernel", (ff, h), lecun(h), bf)
        t(f"{x}/mlp/up_proj/kernel", (ff, h), lecun(h), bf)
        t(f"{x}/mlp/down_proj/kernel", (h, ff), lecun(ff), bf)
    t("llm/norm/scale", (h,), one)
    t("llm/lm_head/kernel", (vocab, h), lecun(h))
    t("proj_norm/scale", (d,), one)
    t("proj_norm/bias", (d,), zero)
    t("proj/kernel", (h, d), lecun(d))
    t("proj/bias", (h,), zero)
    for i in range(llm["num_hidden_layers"]):
        for proj in lora["targets"]:
            key = f"lora/llm/layers_{i}/self_attn/{proj}/kernel"
            t(f"{key}/a", (h, lora["rank"]), ["normal", 0.01])
            t(f"{key}/b", (lora["rank"], h), zero)
    return specs


def trainable(cfg) -> list[str]:
    return [s["name"] for s in param_specs(cfg)
            if not s["name"].startswith("llm/")]


def _col_major(x, pos):
    """Row-major tokens -> column-major, the cls token kept at ``pos``
    (its own inverse)."""
    n, l, d = x.shape
    s = math.isqrt(l - 1)
    rest = torch.cat([x[:, :pos], x[:, pos + 1:]], 1)
    rest = rest.reshape(n, s, s, d).transpose(1, 2).reshape(n, l - 1, d)
    return torch.cat([rest[:, :pos], x[:, pos:pos + 1], rest[:, pos:]], 1)


def _mixer(P, w, x, cfg, h, pos):
    """The mixer over (n, L, d): every direction at once, (n, K, L, ...)."""
    d, _, n, _, di, rank, taps, k = _tower(cfg)
    xz = P.linear(h, w[f"{x}/in_proj/kernel"])
    xi, z = xz[..., :di], xz[..., di:]
    a = -torch.exp(w[f"{x}/A_log"].float())  # (K, di, N)
    xc = _col_major(xi, pos)
    src = torch.stack([xi, xi.flip(1), xc, xc.flip(1)][:k], 1)
    length = src.shape[2]
    conv_w, conv_b = w[f"{x}/conv_w"], w[f"{x}/conv_b"]  # (K, taps, di)
    pad = F.pad(src, (0, 0, taps - 1, 0))
    pre = conv_b[None, :, None, :] + sum(
        conv_w[None, :, i, None, :] * pad[:, :, i:i + length]
        for i in range(taps))
    u = pre * torch.sigmoid(pre)  # (n, K, L, di)
    # x_dbl = u W_x^T and dt_raw W_dt^T, a product a direction
    x_dbl = P.mm(u.transpose(0, 1).reshape(k, -1, di),
                 w[f"{x}/x_proj_w"].transpose(1, 2))
    x_dbl = x_dbl.reshape(k, u.shape[0], length, -1).transpose(0, 1)
    dt = P.mm(x_dbl[..., :rank].transpose(0, 1).reshape(k, -1, rank),
              w[f"{x}/dt_proj_w"].transpose(1, 2))
    dt = dt.reshape(k, u.shape[0], length, di).transpose(0, 1)
    dt = softplus(dt + w[f"{x}/dt_bias"][None, :, None, :])
    bm, cm = x_dbl[..., rank:rank + n], x_dbl[..., rank + n:]
    decay = torch.exp(dt[..., None] * a[None, :, None])  # (n, K, L, di, N)
    drive = (dt * u)[..., None] * bm[..., None, :]
    state = torch.zeros_like(decay[:, :, 0])
    states = []
    # unbind: one backward for all the rows (a slice's makes a full copy)
    for dec, drv in zip(decay.unbind(2), drive.unbind(2)):
        state = dec * state + drv
        states.append(state)
    y = (torch.stack(states, 2) * cm[..., None, :]).sum(-1)
    y = y + u * w[f"{x}/D"][None, :, None, :]
    ys = [y[:, j].flip(1) if j % 2 else y[:, j] for j in range(k)]
    y = ys[0] + ys[1] + _col_major(ys[2] + ys[3], pos) if k == 4 else sum(ys)
    y = y * (z * torch.sigmoid(z))
    if cfg["model"]["tower"]["divide_out"]:
        y = y / k
    return P.linear(y, w[f"{x}/out_proj/kernel"])


def _arm_block(P, w, i, cfg, pos, x):
    pre = f"vision/arm/layers_{i}"
    eps = cfg["model"]["tower"]["norm_eps"]
    return x + _mixer(P, w, f"{pre}/mixer", cfg,
                      rms_norm(x, w[f"{pre}/norm/scale"], eps), pos)


def tower(P, w, cfg, images):
    """(B, V, H, W, 3) -> the projected image tokens (B, L, hidden)."""
    d, depth, _, p, _, _, _, _ = _tower(cfg)
    b, v, hh, ww, c = images.shape
    x = images.reshape(b * v, hh // p, p, ww // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b * v, -1, p * p * c).float()
    kernel = w["vision/arm/patch_embed/proj/kernel"]
    kernel = kernel.permute(0, 2, 3, 1).reshape(d, -1)
    x = P.linear(x, kernel, w["vision/arm/patch_embed/proj/bias"])
    pos = x.shape[1] // 2
    cls = w["vision/arm/cls_token"].expand(b * v, 1, d)
    x = torch.cat([x[:, :pos], cls, x[:, pos:]], 1) + w["vision/arm/pos_embed"]
    for i in range(depth):
        x = checkpoint(_arm_block, P, w, i, cfg, pos, x, use_reentrant=False)
    x = layer_norm(x, w["vision/arm/norm_f/scale"], w["vision/arm/norm_f/bias"],
                   1e-6)
    x = x.reshape(b, v, *x.shape[1:]).mean(1)
    x = layer_norm(x, w["proj_norm/scale"], w["proj_norm/bias"], 1e-6)
    return P.linear(x, w["proj/kernel"], w["proj/bias"])


def _rope(x, theta):
    """Rotary embedding (rotate-half) over (n, heads, L, hd), fp32."""
    hd, length = x.shape[-1], x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    freqs = torch.arange(length, device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _weight(w, cfg, layer, proj):
    """A q/k/v/o kernel with its LoRA delta added (alpha / r times a b)."""
    kernel = w[f"llm/layers_{layer}/self_attn/{proj}/kernel"].float()
    lora = cfg["model"]["lora"]
    if proj not in lora["targets"]:
        return kernel
    key = f"lora/llm/layers_{layer}/self_attn/{proj}/kernel"
    delta = w[f"{key}/a"] @ w[f"{key}/b"]
    return kernel + (lora["alpha"] / lora["rank"]) * delta.t()


def _llm_block(P, w, cfg, i, keep, x):
    llm = cfg["model"]["llm"]
    eps, heads = llm["rms_norm_eps"], llm["num_attention_heads"]
    n, length, hid = x.shape
    hd = hid // heads
    pre = f"llm/layers_{i}"
    h = rms_norm(x, w[f"{pre}/input_layernorm/scale"], eps)

    def qkv(proj):
        bias = w.get(f"{pre}/self_attn/{proj}/bias")
        y = P.linear(h, _weight(w, cfg, i, proj), bias, "fp8")
        return y.reshape(n, length, heads, hd).transpose(1, 2)

    q = _rope(qkv("q_proj"), llm["rope_theta"])
    k = _rope(qkv("k_proj"), llm["rope_theta"])
    v = qkv("v_proj")
    scores = P.mm(q, k.transpose(-1, -2), "fp8") * hd ** -0.5
    causal = torch.ones(length, length, dtype=torch.bool,
                        device=x.device).tril()
    ok = causal[None, None] & keep[:, None, None, :]
    scores = scores.masked_fill(~ok, float("-inf"))
    o = P.mm(torch.softmax(scores, -1), v, "fp8")
    o = o.transpose(1, 2).reshape(n, length, hid)
    x = x + P.linear(o, _weight(w, cfg, i, "o_proj"), None, "fp8")
    h = rms_norm(x, w[f"{pre}/post_attention_layernorm/scale"], eps)
    gate = P.linear(h, w[f"{pre}/mlp/gate_proj/kernel"], None, "fp8")
    up = P.linear(h, w[f"{pre}/mlp/up_proj/kernel"], None, "fp8")
    return x + P.linear(gate * torch.sigmoid(gate) * up,
                        w[f"{pre}/mlp/down_proj/kernel"], None, "fp8")


def llm_loss_sum(P, w, cfg, img, batch, rows):
    """Sum over the report tokens of ``rows`` of -log p: the prompt
    [before, image tokens, after] then the report, the report's padding
    masked out of attention; the head reads only the positions that
    predict a report token."""
    table = w["llm/embed_tokens/embedding"]

    def embed(ids):
        return table[ids[rows]].float()

    tmask = batch["target_mask"][rows]
    x = torch.cat([embed(batch["before_ids"]), img[rows],
                   embed(batch["after_ids"]), embed(batch["target_ids"])], 1)
    lp = x.shape[1] - tmask.shape[1]
    keep = torch.cat([torch.ones(x.shape[0], lp, dtype=torch.bool,
                                 device=x.device), tmask > 0], 1)
    for i in range(cfg["model"]["llm"]["num_hidden_layers"]):
        x = _llm_block(P, w, cfg, i, keep, x)
    x = rms_norm(x[:, lp - 1:-1], w["llm/norm/scale"],
                 cfg["model"]["llm"]["rms_norm_eps"])
    logits = P.linear(x, w["llm/lm_head/kernel"], None, "tf32")
    pad = torch.zeros_like(batch["target_ids"][rows][:, :1])
    labels = torch.cat([pad, batch["target_ids"][rows]], 1)
    mask = torch.cat([pad, tmask], 1)
    return masked_mean_ce(torch.cat([logits, logits[:, :1]], 1), labels, mask,
                          1.0)


def loss_and_grads(cfg, P, w, batch, names):
    accum = cfg["train"]["accum_steps"]
    b = batch["target_ids"].shape[0]
    mb = b // accum
    loss = torch.zeros((), device=batch["target_ids"].device)
    for j in range(accum):
        micro = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
        img = tower(P, w, cfg, micro["images"])
        held = img.detach().requires_grad_(True)
        denom = micro["target_mask"].sum().clamp_min(1.0) * accum
        for r in range(0, mb, ROWS):
            rows = slice(r, min(r + ROWS, mb))
            part = llm_loss_sum(P, w, cfg, held, micro, rows) / denom
            part.backward()
            loss += part.detach()
        img.backward(held.grad)
    return loss, {n: w[n].grad for n in names}
