"""MAE pretraining with chest-region masking, in plain PyTorch.

The published step (He et al., arXiv:2111.06377; the HD variant of
arXiv:2404.17926): a ViT encoder over the patches that the mask keeps, a
narrower ViT decoder over every position with mask tokens in the removed
ones, fixed 2-D sin-cos positions, and the mean squared error of the
per-patch normalised pixels over the removed patches. Region masking
keeps ``1 - ratio_outer`` of the patches outside the chest box and
``1 - ratio_inner`` of those inside it, chosen by argsorts of the noise.

The tensors are named and laid out as :func:`param_specs` says (the
layouts that the benchmark's weights take: block kernels (in, out),
Linear kernels (out, in), the patch kernel (out, C, p, p)). Each image's
forward and backward runs on its own, so that the decoder's 6,401 x
6,401 scores of one image at a time fit (about 21 GB kept for the
backward); the loss is the batch's, so each image's share is divided by
the batch's count of removed patches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.common import gelu_tanh, layer_norm

EPS = 1e-6


def _dims(cfg):
    m = cfg["model"]
    return (m["embed_dim"], m["depth"], m["num_heads"],
            m["decoder_embed_dim"], m["decoder_depth"],
            m["decoder_num_heads"], m["patch_size"], m["in_chans"],
            int(m["embed_dim"] * m["mlp_ratio"]),
            int(m["decoder_embed_dim"] * m["mlp_ratio"]))


def param_specs(cfg) -> list[dict]:
    d, depth, _, dd, ddepth, _, p, c, hid, dhid = _dims(cfg)

    def t(name, shape, init, dtype="float32"):
        return {"name": name, "shape": list(shape), "init": init,
                "dtype": dtype}

    def lecun(fan_in):
        return ["normal", fan_in ** -0.5]

    zero, one = ["const", 0.0], ["const", 1.0]
    specs = [t("cls_token", (1, 1, d), ["normal", 0.02]),
             t("mask_token", (1, 1, dd), ["normal", 0.02]),
             t("patch_embed/proj/kernel", (d, c, p, p), lecun(c * p * p)),
             t("patch_embed/proj/bias", (d,), zero)]

    def block(pre, dim, hidden):
        return [t(f"{pre}/ln1_scale", (dim,), one),
                t(f"{pre}/ln1_bias", (dim,), zero),
                t(f"{pre}/qkv_kernel", (dim, 3 * dim), lecun(dim)),
                t(f"{pre}/qkv_bias", (3 * dim,), zero),
                t(f"{pre}/proj_kernel", (dim, dim), lecun(dim)),
                t(f"{pre}/proj_bias", (dim,), zero),
                t(f"{pre}/ln2_scale", (dim,), one),
                t(f"{pre}/ln2_bias", (dim,), zero),
                t(f"{pre}/fc1_kernel", (dim, hidden), lecun(dim)),
                t(f"{pre}/fc1_bias", (hidden,), zero),
                t(f"{pre}/fc2_kernel", (hidden, dim), lecun(hidden)),
                t(f"{pre}/fc2_bias", (dim,), zero)]

    for i in range(depth):
        specs += block(f"block{i}", d, hid)
    specs += [t("encoder_norm/scale", (d,), one),
              t("encoder_norm/bias", (d,), zero),
              t("decoder_embed/kernel", (dd, d), lecun(d)),
              t("decoder_embed/bias", (dd,), zero)]
    for i in range(ddepth):
        specs += block(f"dec_block{i}", dd, dhid)
    specs += [t("decoder_norm/scale", (dd,), one),
              t("decoder_norm/bias", (dd,), zero),
              t("decoder_pred/kernel", (p * p * c, dd), lecun(dd)),
              t("decoder_pred/bias", (p * p * c,), zero)]
    return specs


def trainable(cfg) -> list[str]:
    return [s["name"] for s in param_specs(cfg)]


def sincos_2d(dim: int, grid: int) -> np.ndarray:
    """(1 + grid^2, dim): a zero row for the cls token, then sin and cos of
    the row index over dim/4 frequencies, then of the column index."""
    coords = np.arange(grid, dtype=np.float32)
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float32)
                            / (dim / 4))

    def embed(pos):
        out = pos.reshape(-1)[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    pe = np.concatenate([embed(gy), embed(gx)], axis=1)
    return np.concatenate([np.zeros((1, dim), np.float32), pe], axis=0)


def region_ids(noise: torch.Tensor, ratio_outer: float, ratio_inner: float):
    """(ids_keep, mask (1 = removed), ids_restore) of chest-region masking:
    the interior is rows [s/4 + 1, 3s/4 + 1) and columns [s/8 + 1,
    3s/4 + 1) of the s x s grid; noise's first columns shuffle the
    exterior, the rest the interior."""
    n, l = noise.shape
    s = math.isqrt(l)
    inside = np.zeros((s, s), bool)
    inside[int(s * 0.25) + 1:int(s * 0.75) + 1,
           int(s * 0.125) + 1:int(s * 0.75) + 1] = True
    idx_out = torch.as_tensor(np.nonzero(~inside.reshape(-1))[0],
                              device=noise.device)
    idx_in = torch.as_tensor(np.nonzero(inside.reshape(-1))[0],
                             device=noise.device)
    keep_out = int(len(idx_out) * (1 - ratio_outer))
    keep_in = int(len(idx_in) * (1 - ratio_inner))
    sh_out = idx_out[torch.argsort(noise[:, :len(idx_out)], dim=1, stable=True)]
    sh_in = idx_in[torch.argsort(noise[:, len(idx_out):], dim=1, stable=True)]
    shuffle = torch.cat([sh_out[:, :keep_out], sh_in[:, :keep_in],
                         sh_out[:, keep_out:], sh_in[:, keep_in:]], 1)
    keep = keep_out + keep_in
    restore = torch.argsort(shuffle, dim=1, stable=True)
    mask = torch.ones(n, l, device=noise.device)
    mask[:, :keep] = 0.0
    return shuffle[:, :keep], torch.gather(mask, 1, restore), restore


def patchify(imgs, p):
    b, h, w, c = imgs.shape
    x = imgs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def vit_block(P, w, pre, heads, x):
    n, l, dim = x.shape
    hd = dim // heads
    h = layer_norm(x, w[f"{pre}/ln1_scale"], w[f"{pre}/ln1_bias"], EPS)
    qkv = P.mm(h, w[f"{pre}/qkv_kernel"]) + w[f"{pre}/qkv_bias"]
    q, k, v = qkv.reshape(n, l, 3, heads, hd).permute(2, 0, 3, 1, 4)
    # the scale on q (l x hd), not on the l x l scores: one pass less
    att = torch.softmax(P.mm(q * hd ** -0.5, k.transpose(-1, -2)), dim=-1)
    o = P.mm(att, v).transpose(1, 2).reshape(n, l, dim)
    x = x + P.mm(o, w[f"{pre}/proj_kernel"]) + w[f"{pre}/proj_bias"]
    h = layer_norm(x, w[f"{pre}/ln2_scale"], w[f"{pre}/ln2_bias"], EPS)
    hidden = gelu_tanh(P.mm(h, w[f"{pre}/fc1_kernel"]) + w[f"{pre}/fc1_bias"])
    return x + P.mm(hidden, w[f"{pre}/fc2_kernel"]) + w[f"{pre}/fc2_bias"]


def _image_loss(cfg, P, w, img, ids_keep, mask, ids_restore):
    """Sum over the removed patches of one image (1, H, W, C) of the mean
    squared error of its normalised pixels."""
    d, depth, heads, dd, ddepth, dheads, p, c, _, _ = _dims(cfg)
    patches = patchify(img.float(), p)
    l = patches.shape[1]
    grid = math.isqrt(l)
    kernel = w["patch_embed/proj/kernel"]
    kernel = kernel.permute(0, 2, 3, 1).reshape(kernel.shape[0], -1)
    pos = torch.from_numpy(sincos_2d(d, grid)).to(img.device)
    x = P.linear(patches, kernel, w["patch_embed/proj/bias"]) + pos[1:]
    x = x[:, ids_keep[0]]
    x = torch.cat([w["cls_token"] + pos[:1], x], dim=1)
    for i in range(depth):
        x = vit_block(P, w, f"block{i}", heads, x)
    x = layer_norm(x, w["encoder_norm/scale"], w["encoder_norm/bias"], EPS)
    x = P.linear(x, w["decoder_embed/kernel"], w["decoder_embed/bias"])
    tokens = torch.cat([x[:, 1:], w["mask_token"].expand(
        1, l - x.shape[1] + 1, dd)], dim=1)
    x = torch.cat([x[:, :1], tokens[:, ids_restore[0]]], dim=1)
    x = x + torch.from_numpy(sincos_2d(dd, grid)).to(img.device)
    for i in range(ddepth):
        x = vit_block(P, w, f"dec_block{i}", dheads, x)
    x = layer_norm(x, w["decoder_norm/scale"], w["decoder_norm/bias"], EPS)
    pred = P.linear(x, w["decoder_pred/kernel"], w["decoder_pred/bias"])[:, 1:]
    target = patches
    if cfg["model"]["norm_pix_loss"]:
        mean = target.mean(-1, keepdim=True)
        var = ((target - mean) ** 2).mean(-1, keepdim=True)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(-1)
    return (per_patch * mask).sum()


def loss_and_grads(cfg, P, w, batch, names):
    """(the step's loss, the gradients of ``names``): one image at a time,
    each image's backward added into the leaves' ``.grad``. With
    accumulation the step's loss is the mean of its micro-batches' (each
    over its own count of removed patches)."""
    m = cfg["model"]
    accum = cfg["train"]["accum_steps"]
    ids_keep, mask, ids_restore = region_ids(
        batch["mask_noise"], m["mask_ratio"], m["mask_ratio_inner"])
    mb = mask.shape[0] // accum
    loss = torch.zeros((), device=mask.device)
    for i in range(mask.shape[0]):
        j = i // mb
        denom = mask[j * mb:(j + 1) * mb].sum().clamp_min(1.0) * accum
        part = _image_loss(cfg, P, w, batch["images"][i:i + 1],
                           ids_keep[i:i + 1], mask[i:i + 1],
                           ids_restore[i:i + 1]) / denom
        part.backward()
        loss += part.detach()
    return loss, {n: w[n].grad for n in names}
