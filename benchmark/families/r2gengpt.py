"""R2GenGPT fine-tuning through the program: the model by ``train.loop``'s
``build_mrg_model`` (put in eval mode as ``init_mrg_model`` does), the
freezes, LoRA and masters by ``mrg_trainables``, the trainable tensors
by ``make_adamw`` in a ``TrainState``, and ``make_train_step`` over the
model's loss with accumulation, as the program's ``fit_mrg`` runs it.
The adapters that ``mrg_trainables`` draws are overwritten by the
benchmark's."""

from __future__ import annotations

from harness import Program
from weights import load_into

REFERENCE = "r2gengpt"


def run_config(cfg: dict):
    from medical_image_analysis_tpu_torch.configs.config import make_config

    m, t = cfg["model"], cfg["model"]["tower"]
    llm, lora = m["llm"], m["lora"]
    return make_config({
        "data": {"input_size": m["image_size"], "num_views": m["views"]},
        "model": {
            "task": "r2gengpt", "vision": "arm", "vision_size": "base",
            "llm": llm["name"],
            "vision_kwargs": {"patch_size": t["patch_size"],
                              "embed_dim": t["embed_dim"],
                              "depth": t["depth"], "d_state": t["d_state"]},
            "llm_kwargs": {
                "dim": llm["hidden_size"],
                "n_layers": llm["num_hidden_layers"],
                "n_heads": llm["num_attention_heads"],
                "n_kv_heads": llm["num_key_value_heads"],
                "hidden_dim": llm["intermediate_size"],
                "rope_theta": llm["rope_theta"],
                "norm_eps": llm["rms_norm_eps"],
                "attn_bias": llm["attention_bias"],
                "tie_embeddings": llm["tie_word_embeddings"],
                "dtype": llm["dtype"]}},
        "train": {"freeze_llm": cfg["train"]["freeze_llm"],
                  "lora_llm": True, "lora_rank": lora["rank"],
                  "accum_steps": cfg["train"]["accum_steps"],
                  "remat": t["remat"] and llm["remat"]}})


def build(cfg: dict, weights: dict, device) -> Program:
    from medical_image_analysis_tpu_torch.ckpt.from_jax import \
        flax_named_parameters
    from medical_image_analysis_tpu_torch.ops import mamba_fused
    from medical_image_analysis_tpu_torch.train.loop import (
        build_mrg_model, mrg_trainables)
    from medical_image_analysis_tpu_torch.train.optim import make_adamw
    from medical_image_analysis_tpu_torch.train.train_state import (
        TrainState, make_train_step)

    run = run_config(cfg)
    model = build_mrg_model(run, cfg["model"]["llm"]["vocab_size"],
                            device=device).eval()
    base = flax_named_parameters(model)
    load_into(base, {n: weights[n] for n in base})
    named, mask = mrg_trainables(run, model)
    adapters = {n: p for n, p in named.items() if n.startswith("lora/")}
    load_into(adapters, {n: w for n, w in weights.items()
                         if n.startswith("lora/")})
    trainable = {n: p for n, p in named.items() if mask[n]}
    frozen = {n: p for n, p in named.items() if not mask[n]}
    opt = cfg["optimizer"]
    lr = opt["lr"]
    tx = make_adamw(trainable, lambda count: lr,
                    weight_decay=opt["weight_decay"], b1=opt["b1"],
                    b2=opt["b2"], grad_clip=opt["grad_clip"])
    state = TrainState(trainable, tx, frozen=frozen)

    def loss_fn(batch):
        return model(batch["images"], batch["before_ids"], batch["after_ids"],
                     batch["target_ids"], batch["target_mask"])

    step = make_train_step(loss_fn, cfg["train"]["accum_steps"])
    names = {n: n[len("base/"):] if n.startswith("base/") else n
             for n in trainable}
    return Program(state, step, loss_fn,
                   {"mamba_fused": mamba_fused.launches}, names)
