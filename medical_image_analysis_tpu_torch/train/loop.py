"""The training recipes on one device: ``fit_mrg`` for R2GenGPT and
R2GenCSR, on the ARM or the VSSM tower, and ``fit_mae`` for MAE pretraining.

Counterpart of ``medical_image_analysis_tpu/train/loop.py`` (``vision_preset``,
``build_mrg_model``, ``build_data``, ``trainable_mask``, the r2gengpt and
r2gencsr branches of ``make_task_adapter``, ``fit_mrg``, ``evaluate_mrg``,
``fit_mae``, ``fit``):
build the data and the model from a seed, freeze the LLM and/or the tower,
put LoRA on the LLM's q/v projections, train with accumulation and remat,
validate by beam search with NLG and clinical-efficacy scores, and save
trainable-only deltas, the best one, and full train states for resume.
MAE pretraining trains every parameter of the masked autoencoder and saves
full train states.

The other tasks, towers and options raise ``NotImplementedError`` naming
their ROADMAP.md item. Beyond the JAX recipe, each step's loss, grad norm,
learning rate and wall seconds are written to ``log.txt``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch
from torch.nn.utils import parametrize

from ..ckpt.checkpoint import (
    auto_resume_helper,
    delta_filename,
    load_delta,
    merge_delta,
    restore_train_state,
    save_delta,
    save_train_state,
)
from ..ckpt.from_jax import flax_named_parameters
from ..configs.config import RunConfig
from ..data.datasets import (
    MRGBatcher,
    disk_image_loader,
    drop_unclear_reports,
    group_study_two_views,
    load_annotations,
    load_chexbert_csv,
    prefetch,
    synthetic_annotations,
    synthetic_image_loader,
)
from ..data.tokenizer import WordTokenizer
from ..evalx.chexbert import clinical_efficacy
from ..evalx.nlg import compute_nlg_scores
from ..models.common import init_params
from ..models.llm import LLM_CONFIGS
from ..models.mamba import ARM_CONFIGS
from ..models.mrg import R2GenCSR, R2GenGPT
from ..models.vit import MAE
from ..models.vmamba import VSSM_CONFIGS
from ..peft.lora import apply_lora, init_lora, llama_qv_rules, vision_qv_rules
from ..utils.logging import JsonlLogger, MetricLogger
from .optim import make_adamw, scaled_lr, warmup_cosine
from .train_state import TrainState, make_train_step

# ROADMAP.md, queue 1: where each task the JAX package trains is ported.
_NOT_PORTED = {
    "swinchex": "slice 4, item 14",
    "dp": "slice 4, item 14",
    "emrrg": "slice 5, item 16",
    "am_mrg": "slice 5, item 16",
    "r2gen_kg": "slice 5, item 16",
    "mac_rrg": "slice 5, item 16",
    "r2gen": "slice 5, item 16",
    "clip": "slice 5, item 16",
    "ar": "slice 5, item 16",
    "mamba_lm_sft": "slice 5, item 16",
}


_TOWERS_NOT_PORTED = {
    "vit": "slice 4, item 14",
    "swin": "slice 4, item 14",
}


def vision_preset(family: str, size: str, extra: dict | None = None) -> dict:
    """The tower's kwargs. As in the JAX package, ``vssm`` names the
    d_state=16 ``vssm_*`` configs; the d_state=1 ``vssm1_*`` family is
    reached through ``extra`` (``model.vision_kwargs``)."""
    if family == "arm":
        base = dict(ARM_CONFIGS[f"arm_{size}_pz16"])
    elif family == "vssm":
        base = dict(VSSM_CONFIGS[f"vssm_{size}"])
    else:
        raise NotImplementedError(
            f"vision tower {family!r} is not ported yet (ROADMAP.md, queue 1, "
            f"{_TOWERS_NOT_PORTED.get(family, 'slice 5')})"
        )
    base.update(extra or {})
    return base


def build_mrg_model(cfg: RunConfig, vocab_size: int,
                    device=None) -> R2GenGPT | R2GenCSR:
    """R2GenGPT or R2GenCSR with an ARM or VSSM tower and a
    ``cfg.model.llm`` decoder.

    Parameters are allocated on ``device`` and left uninitialised by
    this function: call ``models.common.init_params`` with a seeded
    generator, or load weights (``ckpt.from_jax``). ``train.remat``
    checkpoints every ARM and LLM block under a gradient (not the VSSM's,
    as in the JAX package).
    ``model.llm_kwargs["vocab_size"]`` may size the LM's vocabulary above
    the tokenizer's ``vocab_size`` (ids past the tokenizer decode as
    ``<unk>``).
    """
    m = cfg.model
    if m.llm_weights_dir or m.vision_init:
        raise NotImplementedError(
            "loading checkpoints (model.llm_weights_dir, model.vision_init) "
            "is not ported yet (ROADMAP.md, queue 1, item 9)"
        )
    if m.task not in ("r2gengpt", "r2gencsr"):
        raise NotImplementedError(
            f"task {m.task!r} is not ported yet (ROADMAP.md, queue 1, "
            f"{_NOT_PORTED.get(m.task, 'slice 5')})"
        )
    llm_kw = {"vocab_size": vocab_size, **(m.llm_kwargs or {})}
    llm_cfg = dataclasses.replace(LLM_CONFIGS[m.llm], **llm_kw)
    if llm_cfg.vocab_size < vocab_size:
        raise ValueError(f"model.llm_kwargs vocab_size {llm_cfg.vocab_size} "
                         f"is below the tokenizer's {vocab_size}")
    vk = vision_preset(m.vision, m.vision_size, m.vision_kwargs)
    if m.vision == "arm":
        vk.setdefault("img_size", cfg.data.input_size)
    if cfg.train.remat:
        llm_cfg = dataclasses.replace(llm_cfg, remat=True)
        if m.vision == "arm":
            vk.setdefault("remat", True)
    cls = R2GenCSR if m.task == "r2gencsr" else R2GenGPT
    return cls(llm_cfg=llm_cfg, chosen=m.vision, vision_kwargs=vk,
               device=device, **(m.task_kwargs or {}))


def build_data(cfg: RunConfig):
    """Returns (annotations, tokenizer, batcher factory, image loader)."""
    d = cfg.data
    if d.dataset == "synthetic":
        ann = synthetic_annotations()
        loader = synthetic_image_loader(d.input_size, d.num_views)
    elif d.dataset == "synthetic_learnable":
        raise NotImplementedError(
            "data.dataset=synthetic_learnable is not ported yet (ROADMAP.md, "
            "queue 1, item 9)"
        )
    else:
        ann = load_annotations(d.annotation_path, d.dataset)
        loader = disk_image_loader(d.base_dir, d.input_size)
    if d.drop_unclear_report:
        ann["train"] = drop_unclear_reports(ann["train"])
    two_view = not d.use_feature_mean and d.dataset == "mimic_cxr"
    if two_view:
        # val/test get one deterministic grouping; the train batcher
        # re-samples the pooled extra view per epoch.
        for split in ("val", "test"):
            ann[split] = group_study_two_views(ann[split])
    if d.tokenizer_dir or cfg.model.llm_weights_dir:
        raise NotImplementedError(
            "HF tokenizer files (data.tokenizer_dir) are not ported yet "
            "(ROADMAP.md, queue 1, item 9)"
        )
    tok = WordTokenizer.from_corpus(
        (s.report for s in ann["train"]), min_freq=d.vocab_min_freq
    )
    chexbert = load_chexbert_csv(d.chexbert_csv) if d.chexbert_csv else None

    def batcher(split, n_context=0):
        bs = (
            d.val_batch_size
            if split != "train" and d.val_batch_size > 0
            else d.batch_size
        )
        return MRGBatcher(
            ann[split], tok, loader, bs, max_len=d.max_len,
            num_views=d.num_views, prompt_before=d.prompt,
            prompt_after=d.prompt_after, n_context=n_context,
            context_mode=d.context_retrieval_mode,
            context_keyword=d.context_keyword, chexbert_labels=chexbert,
            num_workers=d.num_workers,
            regroup_views=two_view and split == "train",
        )

    return ann, tok, batcher, loader


def trainable_mask(names, freeze_llm: bool,
                   freeze_vision: bool = False) -> dict[str, bool]:
    """flax path -> trainable. ``freeze_llm`` freezes the top-level ``llm``
    subtree (embeddings and ``lm_head`` included); ``freeze_vision`` the
    ``vision``/``visual_encoder`` one. The projector stays trainable."""
    frozen = ({"llm"} if freeze_llm else set()) | (
        {"vision", "visual_encoder"} if freeze_vision else set()
    )
    return {n: n.split("/", 1)[0] not in frozen for n in names}


@dataclasses.dataclass
class TaskAdapter:
    """Batch -> positional arguments of the model's loss and generate, and
    the context exemplars per study that the batchers draw."""

    loss_args: Any
    gen_args: Any
    n_context: int = 0


def make_task_adapter(cfg: RunConfig) -> TaskAdapter:
    task = cfg.model.task
    if task not in ("r2gengpt", "r2gencsr"):
        raise NotImplementedError(
            f"task {task!r} is not ported yet (ROADMAP.md, queue 1, "
            f"{_NOT_PORTED.get(task, 'slice 5')})"
        )

    def base(b):
        return (b["before_ids"], b["after_ids"])

    if task == "r2gencsr":
        return TaskAdapter(
            loss_args=lambda b: (b["images"], b["context_images"], *base(b),
                                 b["target_ids"], b["target_mask"]),
            gen_args=lambda b: (b["images"], b["context_images"], *base(b)),
            n_context=cfg.data.n_context,
        )
    return TaskAdapter(
        loss_args=lambda b: (b["images"], *base(b), b["target_ids"],
                             b["target_mask"]),
        gen_args=lambda b: (b["images"], *base(b)),
    )


def _device_batch(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


@contextmanager
def _swapped(params: dict[str, torch.Tensor], values: dict | None):
    """Copy ``values`` into ``params`` for the block, then restore."""
    if values is None:
        yield
        return
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in params.items()}
        for n, p in params.items():
            p.copy_(values[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])


def evaluate_mrg(batcher: MRGBatcher, tok, gen_fn, device,
                 max_batches: int = 50, dump_path: str = "",
                 chinese: bool = False) -> dict:
    """Generate a report per sample and score them against the references."""
    gts, res = {}, {}
    n_total = -(-len(batcher.samples) // batcher.batch_size)
    if n_total > max_batches:
        print(f"[evaluate_mrg] truncating validation to {max_batches} of "
              f"{n_total} batches (max_batches)")
    for bi, batch in enumerate(batcher.batches(shuffle=False,
                                               drop_last=False)):
        if bi >= max_batches:
            break
        out = gen_fn(_device_batch(batch, device)).cpu().numpy()
        for i, sid in enumerate(batch["ids"]):
            res[sid] = [tok.decode(out[i])]
            gts[sid] = [batch["reports"][i]]
    scores = compute_nlg_scores(gts, res, chinese=chinese)
    scores.update(clinical_efficacy(gts, res))
    if dump_path:
        with open(dump_path, "w") as f:
            json.dump(
                {sid: {"generated": res[sid][0], "reference": gts[sid][0]}
                 for sid in res},
                f, indent=1,
            )
    return scores


def fit_mrg(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """SFT of R2GenGPT or R2GenCSR: returns the last validation's scores (and
    ``val_score``), or the scores of an eval-only run.

    ``on_start(model, state)``, when given, is called once the model and
    the train state are built, before the first step, so that a caller
    can observe them (``chip_smoke.py`` checks what moved).
    """
    t = cfg.train
    if t.debug_nans:
        raise NotImplementedError(
            "train.debug_nans: utils/profiling.py is not ported yet "
            "(ROADMAP.md, queue 1, item 17)"
        )
    if t.mesh_model > 1:
        raise NotImplementedError(
            "train.mesh_model > 1: tensor parallelism is not ported yet "
            "(ROADMAP.md, queue 1, slice 6, item 18)"
        )
    ad = make_task_adapter(cfg)
    device = torch.device(device)
    os.makedirs(t.save_dir, exist_ok=True)
    logger = JsonlLogger(t.save_dir)
    ann, tok, batcher, _ = build_data(cfg)
    model = build_mrg_model(cfg, tok.vocab_size, device=device).eval()
    init_params(model, torch.Generator(device).manual_seed(t.seed))
    gcfg = dataclasses.replace(cfg.generate, eos_id=tok.EOS)
    print("[fit_mrg] data ready, params initialized", flush=True)

    # LoRA on the LLM q/v projections and/or the vision q/v (or the
    # mixers' in_proj X half), trained beside the unfrozen towers.
    rules = ((llama_qv_rules(t.lora_rank) if t.lora_llm else [])
             + (vision_qv_rules(t.lora_vision_rank) if t.lora_vision
                else []))
    named = flax_named_parameters(model)
    mask = trainable_mask(named, t.freeze_llm,
                          t.freeze_vision or t.lora_vision)
    for n, p in named.items():
        p.requires_grad_(mask[n])
    if rules:
        lora = init_lora(model, rules,
                         torch.Generator(device).manual_seed(t.seed + 2))
        apply_lora(model, lora, rules)
        named = {f"base/{n}": p for n, p in named.items()}
        mask = {f"base/{n}": m for n, m in mask.items()}
        for key, ab in lora.items():
            for part, tensor in ab.items():
                named[f"lora/{key}/{part}"] = tensor
                mask[f"lora/{key}/{part}"] = True
    trainable = {n: p for n, p in named.items() if mask[n]}
    frozen = {n: p for n, p in named.items() if not mask[n]}

    bs = cfg.data.batch_size
    if bs % max(t.accum_steps, 1):
        raise ValueError("data.batch_size must be divisible by "
                         "train.accum_steps")
    steps_per_epoch = max(len(ann["train"]) // bs, 1)
    lr = t.lr if t.blr <= 0 else scaled_lr(t.blr, bs)
    tx = make_adamw(trainable,
                    warmup_cosine(lr, t.warmup_steps,
                                  steps_per_epoch * t.epochs),
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    state = TrainState(trainable, tx, ema=t.ema_decay > 0, frozen=frozen)
    start_epoch = _maybe_resume(state, t)
    if on_start is not None:
        on_start(model, state)

    def loss_fn(batch):
        return model(*ad.loss_args(batch))

    def gen_fn(batch):
        with torch.no_grad(), parametrize.cached():
            return model.generate(*ad.gen_args(batch), gcfg)

    # EMA shadow weights are the eval weights when enabled.
    ema = state.ema_params if t.ema_decay > 0 else None

    def score(split: str, dump_name: str, weights=None) -> dict:
        vb = batcher(split, n_context=ad.n_context)
        try:
            with _swapped(state.params, weights):
                return evaluate_mrg(
                    vb, tok, gen_fn, device,
                    max_batches=t.val_max_batches or 10**9,
                    chinese=cfg.data.dataset == "chinese",
                    dump_path=os.path.join(t.save_dir, dump_name),
                )
        finally:
            vb.close()

    if t.eval_only:
        # trainer.test/validate: the resumed state's weights (its EMA
        # shadow when enabled), with a delta merged over them, scored.
        if ema is not None:
            with torch.no_grad():
                for n, p in state.params.items():
                    p.copy_(ema[n])
        if t.init_delta:
            delta, meta = load_delta(t.init_delta)
            merge_delta(state.params, delta)
            print(f"[eval_only] merged delta {t.init_delta} "
                  f"(epoch {meta['epoch']})")
        scores = score(t.eval_split, f"result_{t.eval_split}.json")
        logger.write({"eval_only": t.eval_split, **scores})
        return scores

    step = make_train_step(loss_fn, t.accum_steps, t.ema_decay)
    train_b = batcher("train", n_context=ad.n_context)
    ml = MetricLogger()
    results: dict = {}
    best_score = float("-inf")
    best_path = os.path.join(t.save_dir, "best.json")
    if os.path.exists(best_path):
        with open(best_path) as f:
            best_score = float(json.load(f).get("val_score", best_score))
    try:
        for epoch in range(start_epoch, t.epochs):
            it = prefetch(train_b.batches(epoch=epoch))
            t_prev = time.perf_counter()
            for batch in ml.log_every(it, t.log_every, f"epoch {epoch}",
                                      total=steps_per_epoch):
                metrics = step(state, _device_batch(batch, device))
                loss = float(metrics["loss"])  # waits for the step's loss
                now = time.perf_counter()
                logger.write({"epoch": epoch, "step": state.step,
                              "loss": loss,
                              "grad_norm": float(metrics["grad_norm"]),
                              "lr": metrics["lr"], "step_s": now - t_prev})
                t_prev = now
                ml.update(loss=loss)
            logger.write({"epoch": epoch,
                          "loss": ml.meters["loss"].global_avg})
            if (epoch + 1) % t.save_state_every_epochs == 0:
                save_train_state(t.save_dir, state.state_dict(), epoch,
                                 keep=t.keep_states)

            if (epoch + 1) % t.val_every_epochs == 0:
                t0 = time.perf_counter()
                scores = score("val", f"result_val_epoch{epoch}.json", ema)
                val_s = time.perf_counter() - t0
                # weighted model-selection score (0.5 Bleu_4 + 0.5 CIDEr)
                val_score = sum(
                    scores.get(s, 0.0) * w
                    for s, w in zip(t.scorer_types, t.scorer_weights)
                )
                logger.write({"epoch": epoch, "val_score": val_score,
                              "val_s": val_s, **scores})
                results = {**scores, "val_score": val_score}
                path = os.path.join(
                    t.save_dir, delta_filename(epoch, state.step, scores))
                save_delta(path, state.params,
                           config={"task": cfg.model.task}, epoch=epoch,
                           step=state.step)
                if val_score > best_score:
                    best_score = val_score
                    shutil.copyfile(
                        path, os.path.join(t.save_dir, "checkpoint_best.pt"))
                    with open(best_path, "w") as f:
                        json.dump({"epoch": epoch, "val_score": val_score,
                                   **scores}, f)
            # after validation, so that a capped run still scores and
            # saves its last epoch
            if t.max_epochs_this_run and (
                epoch - start_epoch + 1 >= t.max_epochs_this_run
            ):
                break
    finally:
        train_b.close()
    return results


def _maybe_resume(state: TrainState, t) -> int:
    """Restore the full train state; returns the epoch to start from."""
    if not t.resume:
        return 0
    path = auto_resume_helper(t.save_dir) if t.resume == "auto" else t.resume
    if not path or not os.path.exists(path):
        print(f"[resume] no checkpoint found under {t.save_dir}")
        return 0
    saved, epoch = restore_train_state(path)
    state.load_state_dict(saved)
    print(f"[resume] restored {path} (epoch {epoch})")
    return epoch + 1


def build_mae_model(cfg: RunConfig, device=None) -> MAE:
    """The MAE as the JAX ``fit_mae`` builds it: patch 16 and 3 channels,
    whatever ``model.vision_kwargs`` says besides (ROADMAP.md, section 3).
    Parameters are left uninitialised (``models.common.init_params``)."""
    return MAE(patch_size=16, in_chans=3, **(cfg.model.vision_kwargs or {}),
               device=device)


def mae_mask_noise(seed: int, step: int, n: int, l: int,
                   device) -> torch.Tensor:
    """The masking noise (n, l) of training step ``step``: a function of
    (seed, step) alone, so that a resumed run masks as the unbroken run
    would; accumulation hands each micro-batch its own rows."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.rand(n, l, generator=torch.Generator(device).manual_seed(key),
                      device=device)


def mae_loss_fn(model: MAE, m):
    """``loss_fn(batch)`` of MAE pretraining over ``batch["images"]`` (B, H,
    W, C) and ``batch["mask_noise"]`` (B, L), with the config's masking."""

    def loss_fn(batch):
        loss, _, _ = model(batch["images"], batch["mask_noise"], m.mask_type,
                           m.mask_ratio, m.mask_ratio_inner,
                           deterministic=False)
        return loss

    return loss_fn


def fit_mae(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """MAE pretraining (random or region masking): returns the mean loss of
    the run's steps. ``on_start`` as in :func:`fit_mrg`."""
    t, m = cfg.train, cfg.model
    device = torch.device(device)
    os.makedirs(t.save_dir, exist_ok=True)
    logger = JsonlLogger(t.save_dir)
    ann, _, batcher, _ = build_data(cfg)
    model = build_mae_model(cfg, device)
    init_params(model, torch.Generator(device).manual_seed(t.seed))
    params = flax_named_parameters(model)
    n_params = sum(p.numel() for p in params.values())
    print(f"[fit_mae] data ready, {n_params} params initialized", flush=True)

    bs = cfg.data.batch_size
    steps_per_epoch = max(len(ann["train"]) // bs, 1)
    lr = t.lr if t.blr <= 0 else scaled_lr(t.blr, bs)
    tx = make_adamw(params, warmup_cosine(lr, t.warmup_steps,
                                          steps_per_epoch * t.epochs),
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    state = TrainState(params, tx, ema=t.ema_decay > 0)
    start_epoch = _maybe_resume(state, t)
    if on_start is not None:
        on_start(model, state)

    step = make_train_step(mae_loss_fn(model, m), t.accum_steps, t.ema_decay)
    train_b = batcher("train")
    ml = MetricLogger()
    try:
        for epoch in range(start_epoch, t.epochs):
            it = prefetch(train_b.batches(epoch=epoch))
            t_prev = time.perf_counter()
            for batch in ml.log_every(it, t.log_every, f"mae epoch {epoch}",
                                      total=steps_per_epoch):
                imgs = torch.from_numpy(batch["images"][:, 0]).to(device)
                noise = mae_mask_noise(t.seed, state.step, imgs.shape[0],
                                       model.num_patches(imgs), device)
                metrics = step(state, {"images": imgs, "mask_noise": noise})
                loss = float(metrics["loss"])  # waits for the step's loss
                now = time.perf_counter()
                logger.write({"epoch": epoch, "step": state.step,
                              "loss": loss,
                              "grad_norm": float(metrics["grad_norm"]),
                              "lr": metrics["lr"], "step_s": now - t_prev})
                t_prev = now
                ml.update(loss=loss)
            if (epoch + 1) % t.save_state_every_epochs == 0:
                save_train_state(t.save_dir, state.state_dict(), epoch,
                                 keep=t.keep_states)
            if t.max_epochs_this_run and (
                epoch - start_epoch + 1 >= t.max_epochs_this_run
            ):
                break
    finally:
        train_b.close()
    return {"loss": ml.meters["loss"].global_avg}


def fit(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """The JAX package's dispatch by ``model.task``: ``mae`` to
    :func:`fit_mae`; r2gengpt and r2gencsr to :func:`fit_mrg`, which raises
    for the tasks not ported yet."""
    if cfg.model.task == "mae":
        return fit_mae(cfg, device, on_start)
    return fit_mrg(cfg, device, on_start)
