"""MAE pretraining through the program: the model by ``models.vit``'s
``build_mae`` under the configuration's ``builder`` name (the published
HD MAE is ``mae_vit_base_patch64_hd``: patch 64, one channel), every
tensor trained by ``make_adamw`` in a ``TrainState``, and
``make_train_step`` over ``train.loop``'s ``mae_loss_fn``, the step that
the program's ``fit_mae`` runs."""

from __future__ import annotations

from harness import Program
from weights import load_into

REFERENCE = "mae"


def build(cfg: dict, weights: dict, device) -> Program:
    from medical_image_analysis_tpu_torch.ckpt.from_jax import \
        flax_named_parameters
    from medical_image_analysis_tpu_torch.configs.config import make_config
    from medical_image_analysis_tpu_torch.models.vit import build_mae
    from medical_image_analysis_tpu_torch.ops import vit_block
    from medical_image_analysis_tpu_torch.train.loop import mae_loss_fn
    from medical_image_analysis_tpu_torch.train.optim import make_adamw
    from medical_image_analysis_tpu_torch.train.train_state import (
        TrainState, make_train_step)

    m, opt = cfg["model"], cfg["optimizer"]
    run = make_config({"model": {
        "task": "mae", "mask_type": m["mask_type"],
        "mask_ratio": m["mask_ratio"],
        "mask_ratio_inner": m["mask_ratio_inner"]}})
    model = build_mae(cfg["builder"], device, **{
        k: m[k] for k in ("patch_size", "in_chans", "embed_dim", "depth",
                          "num_heads", "decoder_embed_dim", "decoder_depth",
                          "decoder_num_heads", "mlp_ratio",
                          "norm_pix_loss")})
    params = flax_named_parameters(model)
    load_into(params, weights)
    lr = opt["lr"]
    tx = make_adamw(params, lambda count: lr,
                    weight_decay=opt["weight_decay"], b1=opt["b1"],
                    b2=opt["b2"], grad_clip=opt["grad_clip"])
    state = TrainState(params, tx)
    loss_fn = mae_loss_fn(model, run.model)
    step = make_train_step(loss_fn, cfg["train"]["accum_steps"])
    return Program(state, step, loss_fn,
                   {"vit_block": vit_block.launches}, {n: n for n in params})
