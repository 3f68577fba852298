"""The training recipes on one device: ``fit_mrg`` for R2GenGPT,
R2GenCSR, AM-MRG, R2GenKG, EMRRG and MAC-RRG (R2GenGPT and R2GenCSR on the
ARM, VSSM, Swin or ViT tower; AM-MRG and EMRRG on the ARM; R2GenKG and
MAC-RRG on any of them), ``fit_r2gen`` for R2Gen (a tower and the
relational-memory decoder), ``fit_mae`` for MAE pretraining, ``fit_ar`` and
``fit_clip`` for MambaXray-VL's stages 1 and 2 (AR pretraining, CLIP
alignment), ``fit_classify`` for SwinCheX, the VSSM classifier and the DP
ViT classifier, and ``fit_lm_sft`` for EMRRG's text finetune of the Mamba
LM. Every task of the JAX package trains here.

Counterpart of ``medical_image_analysis_tpu/train/loop.py`` (``vision_preset``,
``build_mrg_model``, ``build_data``, ``trainable_mask``,
``unfreeze_hybrid_layers``, ``make_task_adapter``, ``fit_mrg``,
``evaluate_mrg``, ``fit_r2gen``, ``fit_mae``, ``fit_ar``, ``fit_clip``,
``fit_classify``, ``fit_lm_sft``, ``fit``):
build the data and the model from a seed, freeze the LLM and/or the tower
(EMRRG's hybrid layers stay trainable in a frozen LLM), put LoRA on the
LLM's q/v projections, train with accumulation and remat, validate by
beam search with NLG and clinical-efficacy scores, and save
trainable-only deltas, the best one, and full train states for resume.
A trainable LLM tensor keeps an fp32 master (``fp32_masters``); the
frozen ones stay in the LLM's dtype.
AM-MRG's memory banks and R2GenKG's graph tensors are built before the
model (``data/side_inputs.py``), on the run's device, and closed over by
the task adapter as device tensors; MAC-RRG's agents embed each sample's
draft in the batcher (``extra_fn``) with an embedder on the run's device.
The pretraining recipes (MAE, AR, CLIP) train every parameter and save
full train states; so does classification, with labels extracted from the
reports, mixup/cutmix, EMA, and a validation of AUC and accuracy.
``model.vision_init`` grafts a tower from an earlier stage's artifact
(``ckpt/bridge.py``) into ``fit_clip``, ``fit_mrg`` (AM-MRG's and EMRRG's
bare ARM at ``vision``, the other tasks' tower at ``vision/<family>``),
``fit_r2gen`` (``vision/<family>``) and ``fit_classify`` (``vit``,
``vssm``).

``train.debug_nans`` (``fit_mrg``, as in the JAX package) checks every
module's output, the loss and every gradient and raises
``FloatingPointError`` at the first NaN (:func:`debug_nans`).
The options not ported raise ``NotImplementedError`` naming their
ROADMAP.md item. Beyond the JAX recipe, each step's loss, grad norm,
learning rate and wall seconds are written to ``log.txt``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch
from torch.nn.utils import parametrize

from ..ckpt.bridge import apply_vision_init
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
from ..ckpt.hf_load import load_llm_params, read_hf_config
from ..configs.config import RunConfig
from ..data import side_inputs as side
from ..data.datasets import (
    MRGBatcher,
    disk_image_loader,
    drop_unclear_reports,
    group_study_two_views,
    learnable_image_loader,
    learnable_synthetic_annotations,
    load_annotations,
    load_chexbert_csv,
    mixup_cutmix,
    prefetch,
    synthetic_annotations,
    synthetic_image_loader,
)
from ..data.hf_tokenizer import HFTokenizer
from ..data.tokenizer import WordTokenizer
from ..evalx.chexbert import clinical_efficacy, extract_labels
from ..evalx.classification import (
    multilabel_auc,
    pedestrian_metrics,
    per_label_accuracy,
)
from ..evalx.nlg import compute_nlg_scores
from ..models.am_mrg import AMMRG
from ..models.classifiers import (
    DPClassifier,
    VSSMClassifier,
    swinchex_loss,
    weighted_bce_loss,
)
from ..models.common import init_params
from ..models.emrrg import EMRRG
from ..models.llm import LLM_CONFIGS
from ..models.mac_rrg import MACRRG
from ..models.mamba import ARM_CONFIGS
from ..models.mamba_lm import MambaLM, alpaca_prompt, lm_loss
from ..models.mambaxray_vl import MambaXrayVLCLIP
from ..models.mrg import R2GenCSR, R2GenGPT
from ..models.r2gen import R2GenPipeline
from ..models.r2gen_kg import R2GenKG
from ..models.swin import SWIN_CONFIGS, SwinCheX, SwinTransformer
from ..models.vision_mamba_ar import VisionMambaAR
from ..models.vit import MAE, VIT_CONFIGS
from ..models.vmamba import VSSM_CONFIGS
from ..peft.lora import apply_lora, init_lora, llama_qv_rules, vision_qv_rules
from ..peft.mamba_peft import MambaPEFTConfig, weight_space_fields
from ..utils.logging import JsonlLogger, MetricLogger
from ..utils.profiling import check_nan, enable_debug_nans
from .optim import make_adamw, scaled_lr, warmup_cosine
from .train_state import TrainState, make_train_step

_IMAGE_SIZED = ("arm", "swin", "vit")  # towers that take ``img_size``


def vision_preset(family: str, size: str, extra: dict | None = None) -> dict:
    """The tower's kwargs. As in the JAX package, ``vssm`` names the
    d_state=16 ``vssm_*`` configs; the d_state=1 ``vssm1_*`` family is
    reached through ``extra`` (``model.vision_kwargs``)."""
    configs = {"arm": (ARM_CONFIGS, f"arm_{size}_pz16"),
               "vssm": (VSSM_CONFIGS, f"vssm_{size}"),
               "swin": (SWIN_CONFIGS, f"swin_{size}"),
               "vit": (VIT_CONFIGS, f"vit_{size}")}
    if family not in configs:
        raise ValueError(f"unknown vision tower {family!r}")
    table, key = configs[family]
    base = dict(table[key])
    base.update(extra or {})
    return base


def build_mrg_model(cfg: RunConfig, vocab_size: int, device=None,
                    side_dims: dict | None = None):
    """R2GenGPT or R2GenCSR with an ARM, VSSM, Swin or ViT tower, AM-MRG
    or EMRRG with an ARM, or R2GenKG or MAC-RRG, and a ``cfg.model.llm``
    decoder (EMRRG's with its hybrid layers).

    Parameters are allocated on ``device`` and left uninitialised by
    this function: call ``models.common.init_params`` with a seeded
    generator, or load weights (``ckpt.from_jax``). ``train.remat``
    checkpoints every ARM and LLM block under a gradient (not the VSSM's,
    as in the JAX package).
    ``model.llm_kwargs["vocab_size"]`` may size the LM's vocabulary above
    the tokenizer's ``vocab_size`` (ids past the tokenizer decode as
    ``<unk>``). ``side_dims`` are the side inputs' widths that the heads
    read (``TaskAdapter.side_dims``: AM-MRG's banks, R2GenKG's node
    features and disease bank, MAC-RRG's rag and concept embeddings);
    without them the heads take their own widths.
    """
    m = cfg.model
    if m.llm_weights_dir:
        # the architecture and vocabulary come from the checkpoint; the
        # data tokenizer must fit inside its embedding table
        llm_cfg = read_hf_config(m.llm_weights_dir, **(m.llm_kwargs or {}))
        if vocab_size > llm_cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({vocab_size}) exceeds the checkpoint "
                f"vocab ({llm_cfg.vocab_size}); set data.tokenizer_dir to "
                "the checkpoint's tokenizer")
        if m.llm_int8:
            llm_cfg = dataclasses.replace(llm_cfg, quant_int8=True)
    else:
        llm_kw = {"vocab_size": vocab_size, **(m.llm_kwargs or {})}
        llm_cfg = dataclasses.replace(LLM_CONFIGS[m.llm], **llm_kw)
        if llm_cfg.vocab_size < vocab_size:
            raise ValueError(f"model.llm_kwargs vocab_size "
                             f"{llm_cfg.vocab_size} is below the "
                             f"tokenizer's {vocab_size}")
    vk = vision_preset(m.vision, m.vision_size, m.vision_kwargs)
    if m.vision in _IMAGE_SIZED:
        vk.setdefault("img_size", cfg.data.input_size)
    if cfg.train.remat:
        llm_cfg = dataclasses.replace(llm_cfg, remat=True)
        if m.vision == "arm":
            vk.setdefault("remat", True)
    tkw = {**(m.task_kwargs or {}), **(side_dims or {})}
    if m.task == "am_mrg":
        return AMMRG(llm_cfg=llm_cfg, arm_kwargs=vk, device=device, **tkw)
    if m.task == "emrrg":
        return EMRRG(llm_cfg=llm_cfg, arm_kwargs=vk, device=device, **tkw)
    cls = {"r2gencsr": R2GenCSR, "r2gen_kg": R2GenKG,
           "mac_rrg": MACRRG}.get(m.task, R2GenGPT)
    return cls(llm_cfg=llm_cfg, chosen=m.vision, vision_kwargs=vk,
               device=device, **tkw)


def hf_tokenizer_of(cfg: RunConfig) -> HFTokenizer | None:
    """The HF tokenizer of ``data.tokenizer_dir``, falling back to
    ``model.llm_weights_dir``: its ``tokenizer.json``, or None where the
    fallback directory has none (a set ``data.tokenizer_dir`` without one
    raises)."""
    tok_dir = cfg.data.tokenizer_dir or cfg.model.llm_weights_dir
    tok_file = os.path.join(tok_dir, "tokenizer.json") if tok_dir else ""
    if tok_file and os.path.exists(tok_file):
        return HFTokenizer.from_file(tok_file)
    if cfg.data.tokenizer_dir:
        raise FileNotFoundError(
            f"data.tokenizer_dir set but no tokenizer.json at {tok_file}")
    return None


def build_data(cfg: RunConfig):
    """Returns (annotations, tokenizer, batcher factory, image loader)."""
    d = cfg.data
    if d.dataset == "synthetic":
        ann = synthetic_annotations()
        loader = synthetic_image_loader(d.input_size, d.num_views)
    elif d.dataset == "synthetic_learnable":
        ann = learnable_synthetic_annotations(
            n_train=d.synthetic_train_size or 512,
            holdout=d.synthetic_holdout,
        )
        loader = learnable_image_loader(d.input_size, d.num_views)
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
    tok = hf_tokenizer_of(cfg)
    if tok is None:
        tok = WordTokenizer.from_corpus(
            (s.report for s in ann["train"]), min_freq=d.vocab_min_freq
        )
    chexbert = load_chexbert_csv(d.chexbert_csv) if d.chexbert_csv else None

    def batcher(split, n_context=0, extra_fn=None):
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
            regroup_views=two_view and split == "train", extra_fn=extra_fn,
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


def unfreeze_hybrid_layers(mask: dict[str, bool],
                           cross_every: int) -> dict[str, bool]:
    """EMRRG: every tensor of the hybrid layers (``llm/layers_<i>/`` with
    ``i % cross_every == 0``: the inherited weights and the gated
    cross-attention) trainable, the rest of the mask as it is. The
    reference builds those layers after its blanket LLM freeze."""
    out = dict(mask)
    for n in mask:
        m = re.match(r"llm/layers_(\d+)/", n)
        if m and int(m.group(1)) % cross_every == 0:
            out[n] = True
    return out


@torch.no_grad()
def fp32_masters(named: dict[str, torch.Tensor], mask: dict[str, bool]):
    """Convert every trainable tensor of the LLM (``llm/...``) to fp32 in
    place: the JAX package keeps fp32 parameters and casts them at use,
    and a bf16-stored weight would round most updates away (``Dense``
    still computes in the LLM's dtype). Frozen tensors keep theirs."""
    for n, p in named.items():
        if mask[n] and n.startswith("llm/") and p.dtype != torch.float32:
            p.data = p.data.float()


@dataclasses.dataclass
class TaskAdapter:
    """Batch -> positional arguments of the model's loss and generate, the
    context exemplars per study that the batchers draw, and the task's
    side inputs: device tensors closed over by the two functions
    (``side``, by name), the widths the model's heads read of them
    (``side_dims``, keyword arguments of the model), and the per-sample
    ones that the batchers add (``extra_fn``; MAC-RRG's agents, whose
    context is ``mac_ctx``)."""

    loss_args: Any
    gen_args: Any
    n_context: int = 0
    side: dict = dataclasses.field(default_factory=dict)
    side_dims: dict = dataclasses.field(default_factory=dict)
    extra_fn: Any = None
    mac_ctx: Any = None


def make_task_adapter(cfg: RunConfig, ann, tok, loader,
                      device) -> TaskAdapter:
    """The task's batch mapping, and its side inputs built on ``device``:
    AM-MRG's memory banks (``side_inputs.build_am_banks``) and R2GenKG's
    graph tensors (``side_inputs.synthesize_graph_artifacts``, or
    ``load_graph_npz`` where ``model.side_inputs.graph`` names a file), and
    MAC-RRG's agent context (``side_inputs.MACContext``, its embedder on
    ``device``), from ``build_data``'s annotations, tokenizer and image
    loader."""
    task = cfg.model.task
    si = dict(cfg.model.side_inputs or {})
    seed = cfg.train.seed

    def base(b):
        return (b["before_ids"], b["after_ids"])

    def tgt(b):
        return (b["target_ids"], b["target_mask"])

    def on_device(x):
        return torch.as_tensor(x).to(device)

    if task == "r2gencsr":
        return TaskAdapter(
            loss_args=lambda b: (b["images"], b["context_images"], *base(b),
                                 *tgt(b)),
            gen_args=lambda b: (b["images"], b["context_images"], *base(b)),
            n_context=cfg.data.n_context,
        )
    if task == "am_mrg":
        embed = side.make_text_embedder(tok, dim=si.get("dim", 64), seed=seed,
                                        device=device)
        vb, rb = side.build_am_banks(
            ann["train"], loader, embed,
            bank_dim=si.get("bank_dim", si.get("dim", 64)),
            visual_bank_path=si.get("visual_bank", ""),
            report_bank_path=si.get("report_bank", ""),
            swin_kwargs=si.get("swin_kwargs"), seed=seed, device=device,
        )
        vb, rb = on_device(vb), on_device(rb)
        return TaskAdapter(
            loss_args=lambda b: (b["images"], vb, rb, *base(b), *tgt(b)),
            gen_args=lambda b: (b["images"], vb, rb, *base(b)),
            side={"visual_bank": vb, "report_bank": rb},
            side_dims={"visual_bank_dim": vb.shape[1],
                       "report_bank_dim": rb.shape[1]},
        )
    if task == "r2gen_kg":
        n_scales = (cfg.model.task_kwargs or {}).get("num_scales", 5)
        if si.get("graph"):
            g = side.load_graph_npz(si["graph"], num_scales=n_scales)
        else:
            embed = side.make_text_embedder(tok, dim=si.get("dim", 64),
                                            seed=seed, device=device)
            g = side.synthesize_graph_artifacts(
                [s.report for s in ann["train"]], embed,
                num_scales=n_scales, base_nodes=si.get("base_nodes", 8),
                edges_per_scale=si.get("edges_per_scale", 64),
                disease_bank_size=si.get("disease_bank_size", 64),
                seed=seed,
            )
        nf = [on_device(x) for x in g["node_feats"]]
        ei = [on_device(x) for x in g["edge_indices"]]
        et = [on_device(x) for x in g["edge_types"]]
        bank = on_device(g["disease_bank"])
        return TaskAdapter(
            loss_args=lambda b: (b["images"], nf, ei, et, bank, *base(b),
                                 *tgt(b)),
            gen_args=lambda b: (b["images"], nf, ei, et, bank, *base(b)),
            side={**{f"{k}_{i}": t for k, ts in (
                ("node_feats", nf), ("edge_index", ei), ("edge_type", et))
                for i, t in enumerate(ts)}, "disease_bank": bank},
            side_dims={"node_dim": nf[0].shape[1],
                       "bank_dim": bank.shape[1]},
        )
    if task == "mac_rrg":
        dim = si.get("dim", 64)
        embed = side.make_text_embedder(tok, dim=dim, seed=seed,
                                        device=device)
        ctx = side.MACContext(
            [s.report for s in ann["train"]], embed,
            max_chunks=si.get("max_chunks", 8),
            max_entities=si.get("max_entities", 8),
        )

        def agents(b):
            return (b["images"], b["rag_embeds"], b["concept_embeds"])

        return TaskAdapter(
            loss_args=lambda b: (*agents(b), *base(b), *tgt(b)),
            gen_args=lambda b: (*agents(b), *base(b)),
            side_dims={"rag_dim": dim, "concept_dim": dim},
            extra_fn=ctx.extra_fn, mac_ctx=ctx,
        )
    return TaskAdapter(
        loss_args=lambda b: (b["images"], *base(b), *tgt(b)),
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


def init_mrg_model(cfg: RunConfig, vocab_size: int, side_dims: dict, device,
                   init_device=None):
    """``build_mrg_model`` in eval mode, initialised from ``train.seed`` on
    ``init_device`` (``device`` where None; a CUDA and a CPU generator draw
    different numbers), grafted by ``model.vision_init``, on ``device``."""
    device = torch.device(device)
    init_device = torch.device(init_device or device)
    model = build_mrg_model(cfg, vocab_size, device=init_device,
                            side_dims=side_dims).eval()
    init_params(model, torch.Generator(init_device).manual_seed(
        cfg.train.seed))
    if cfg.model.vision_init:
        # the stage-1/2 pretrain -> SFT tower graft (ckpt/bridge.py):
        # AM-MRG and EMRRG hold a bare ARM at "vision", the others a
        # VisionEncoder
        bare = cfg.model.task in ("am_mrg", "emrrg")
        apply_vision_init(flax_named_parameters(model), cfg.model.vision_init,
                          "arm" if bare else cfg.model.vision,
                          ("vision",) if bare else ("vision",
                                                    cfg.model.vision))
    model = model.to(device)
    if cfg.model.llm_weights_dir:
        if cfg.train.lora_llm and cfg.model.llm_int8:
            raise ValueError(
                "train.lora_llm with model.llm_int8 is unsupported: int8 "
                "is a serving format; train LoRA against bf16 weights")
        splice_llm_weights(model, cfg)
    return model


def splice_llm_weights(model, cfg: RunConfig) -> list[str]:
    """Stream the real Llama/Qwen weights of ``model.llm_weights_dir`` over
    the model's LLM in place, on its device (``ckpt/hf_load.py``); the
    tower and projector keep their values. EMRRG's hybrid decoder keeps
    the Llama names and adds ``cross_attn_{kv,gate}_proj`` inside every
    ``cross_every``-th layer: the file's tensors are grafted in and the
    hybrid-only ones keep theirs (JAX ``splice_llm_weights``). Returns the
    LLM's names written."""
    t0 = time.perf_counter()
    emrrg = cfg.model.task == "emrrg"
    if emrrg and cfg.model.llm_int8:
        raise ValueError(
            "model.llm_int8 is unsupported for emrrg (the hybrid layers use "
            "plain Dense kernels)")
    written = load_llm_params(cfg.model.llm_weights_dir, model.llm,
                              strict=not emrrg)
    print(f"[splice_llm_weights] {len(written)} LLM tensors from "
          f"{cfg.model.llm_weights_dir} in {time.perf_counter() - t0:.2f} s"
          f"{' (int8)' if cfg.model.llm_int8 else ''}", flush=True)
    return written


def mrg_trainables(cfg: RunConfig, model) -> tuple[dict, dict]:
    """The run's tensors by name and their trainable mask: the freezes of
    ``train`` (EMRRG's hybrid layers trainable in a frozen LLM), fp32
    masters for the trainable LLM tensors, and LoRA on the LLM q/v
    projections and/or the vision q/v (or the mixers' in_proj X half),
    its adapters drawn from ``train.seed + 2`` and named
    ``lora/<kernel>/{a,b}`` beside the ``base/`` tensors."""
    t = cfg.train
    rules = ((llama_qv_rules(t.lora_rank) if t.lora_llm else [])
             + (vision_qv_rules(t.lora_vision_rank) if t.lora_vision
                else []))
    named = flax_named_parameters(model)
    mask = trainable_mask(named, t.freeze_llm,
                          t.freeze_vision or t.lora_vision)
    if cfg.model.task == "emrrg" and t.freeze_llm:
        mask = unfreeze_hybrid_layers(mask, model.cross_every)
    fp32_masters(named, mask)
    for n, p in named.items():
        p.requires_grad_(mask[n])
    if rules:
        device = next(model.parameters()).device
        lora = init_lora(model, rules,
                         torch.Generator(device).manual_seed(t.seed + 2))
        apply_lora(model, lora, rules)
        named = {f"base/{n}": p for n, p in named.items()}
        mask = {f"base/{n}": m for n, m in mask.items()}
        for key, ab in lora.items():
            for part, tensor in ab.items():
                named[f"lora/{key}/{part}"] = tensor
                mask[f"lora/{key}/{part}"] = True
    return named, mask


def fit_mrg(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """SFT of R2GenGPT, R2GenCSR, AM-MRG, R2GenKG, EMRRG or MAC-RRG: returns
    the last validation's scores (and ``val_score``), or the scores of an
    eval-only run. Where the task has side inputs, ``log.txt`` gets their
    shapes and the seconds that building them took (``side_s``; MAC-RRG's
    are the agent context's sizes). A delta's ``config`` names the task and
    the device type the run initialised on (``init_device``: the frozen
    tensors a delta leaves out are that device's draws from the seed).

    ``on_start(model, state)``, when given, is called once the model and
    the train state are built, before the first step, so that a caller
    can observe them (``chip_smoke.py`` checks what moved).
    """
    t = cfg.train
    if t.mesh_model > 1:
        raise NotImplementedError(
            "train.mesh_model > 1: tensor parallelism is not ported yet "
            "(ROADMAP.md, queue 1, item 18)"
        )
    device = torch.device(device)
    os.makedirs(t.save_dir, exist_ok=True)
    logger = JsonlLogger(t.save_dir)
    ann, tok, batcher, loader = build_data(cfg)
    t0 = time.perf_counter()
    ad = make_task_adapter(cfg, ann, tok, loader, device)
    if ad.side:
        logger.write({"side_inputs": {k: list(v.shape)
                                      for k, v in ad.side.items()},
                      "side_s": time.perf_counter() - t0})
    elif ad.mac_ctx is not None:
        ctx = ad.mac_ctx
        logger.write({"side_inputs": {"aliases": len(ctx.alias_dict),
                                      "relations": len(ctx.relations),
                                      "chunks": len(ctx.chunks)},
                      "side_s": time.perf_counter() - t0})
    model = init_mrg_model(cfg, tok.vocab_size, ad.side_dims, device)
    gcfg = dataclasses.replace(cfg.generate, eos_id=tok.EOS)
    print("[fit_mrg] data ready, params initialized", flush=True)
    named, mask = mrg_trainables(cfg, model)
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
        vb = batcher(split, n_context=ad.n_context, extra_fn=ad.extra_fn)
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
        _load_eval_only_weights(state, t)
        scores = score(t.eval_split, f"result_{t.eval_split}.json")
        logger.write({"eval_only": t.eval_split, **scores})
        return scores

    step = make_train_step(loss_fn, t.accum_steps, t.ema_decay,
                           debug_nans(model) if t.debug_nans else None)
    train_b = batcher("train", n_context=ad.n_context, extra_fn=ad.extra_fn)
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
                           config={"task": cfg.model.task,
                                   "init_device": device.type},
                           epoch=epoch, step=state.step)
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


def debug_nans(model):
    """``train.debug_nans``: every module's output checked after its
    forward (``utils/profiling.py:enable_debug_nans``); returns the train
    step's ``check``, which checks the loss and every gradient. Each
    raises ``FloatingPointError`` naming the module or tensor."""
    enable_debug_nans(model)

    def check(loss, grads):
        check_nan("loss", loss)
        for name, g in grads.items():
            check_nan(f"gradient of {name}", g)

    return check


def _load_eval_only_weights(state: TrainState, t) -> None:
    """trainer.test/validate: the resumed state's weights (its EMA shadow
    when enabled), with ``train.init_delta`` merged over them, into the
    model's parameters."""
    if state.ema_params is not None and t.ema_decay > 0:
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(state.ema_params[n])
    if t.init_delta:
        delta, meta = load_delta(t.init_delta)
        merge_delta(state.params, delta)
        print(f"[eval_only] merged delta {t.init_delta} "
              f"(epoch {meta['epoch']})")


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


def build_r2gen_model(cfg: RunConfig, tok, device=None) -> R2GenPipeline:
    """``R2GenPipeline`` as the JAX ``fit_r2gen`` builds it: the tower of
    ``vision_preset`` (images of ``data.input_size``), the tokenizer's
    vocabulary, BOS and EOS, and ``model.task_kwargs`` (``r2gen_kwargs``).
    Parameters are left uninitialised."""
    m = cfg.model
    vk = vision_preset(m.vision, m.vision_size, m.vision_kwargs)
    if m.vision in _IMAGE_SIZED:
        vk.setdefault("img_size", cfg.data.input_size)
    return R2GenPipeline(vocab_size=tok.vocab_size, chosen=m.vision,
                         vision_kwargs=vk, bos_id=tok.BOS, eos_id=tok.EOS,
                         device=device, **(m.task_kwargs or {}))


def fit_r2gen(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """R2Gen: a tower (``model.vision``, grafted by ``model.vision_init``)
    and the relational-memory transformer trained with the report
    cross-entropy, every tensor at ``train.lr`` (AdamW, warmup cosine; the
    decay mask reads flax names, so R2Gen's norms, ``gamma``/``beta``,
    decay), and validated by beam search (``generate.num_beams``,
    ``max_new_tokens``) with NLG and clinical-efficacy scores and a delta
    saved after each validation. Returns the last validation's scores, or
    those of an eval-only run. ``on_start`` as in :func:`fit_mrg`."""
    t, m = cfg.train, cfg.model
    device = torch.device(device)
    os.makedirs(t.save_dir, exist_ok=True)
    logger = JsonlLogger(t.save_dir)
    ann, tok, batcher, _ = build_data(cfg)
    model = build_r2gen_model(cfg, tok, device).eval()
    init_params(model, torch.Generator(device).manual_seed(t.seed))
    params = flax_named_parameters(model)
    if m.vision_init:
        # the MAE pretrain -> report generation encoder graft
        apply_vision_init(params, m.vision_init, m.vision,
                          ("vision", m.vision))
    print(f"[fit_r2gen] data ready, "
          f"{sum(p.numel() for p in params.values())} params initialized",
          flush=True)
    bs = cfg.data.batch_size
    steps_per_epoch = max(len(ann["train"]) // bs, 1)
    tx = make_adamw(params, warmup_cosine(t.lr, t.warmup_steps,
                                          steps_per_epoch * t.epochs),
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    state = TrainState(params, tx, ema=t.ema_decay > 0)
    start_epoch = _maybe_resume(state, t)
    if on_start is not None:
        on_start(model, state)
    g = cfg.generate

    def gen_fn(batch):
        return model.generate(batch["images"], g.max_new_tokens, g.num_beams)

    def score(split: str, weights=None, dump_path: str = "") -> dict:
        vb = batcher(split)
        try:
            with _swapped(state.params, weights):
                return evaluate_mrg(
                    vb, tok, gen_fn, device,
                    max_batches=t.val_max_batches or 10**9,
                    chinese=cfg.data.dataset == "chinese",
                    dump_path=dump_path)
        finally:
            vb.close()

    if t.eval_only:
        _load_eval_only_weights(state, t)
        scores = score(t.eval_split, dump_path=os.path.join(
            t.save_dir, f"result_{t.eval_split}.json"))
        logger.write({"eval_only": t.eval_split, **scores})
        return scores

    step = make_train_step(
        lambda b: model(b["images"], b["target_ids"], b["target_mask"]),
        t.accum_steps, t.ema_decay)
    keys = ("images", "target_ids", "target_mask")
    train_b = batcher("train")
    ema = state.ema_params if t.ema_decay > 0 else None
    ml = MetricLogger()
    results: dict = {}
    try:
        for epoch in range(start_epoch, t.epochs):
            it = prefetch(train_b.batches(epoch=epoch))
            t_prev = time.perf_counter()
            for batch in ml.log_every(it, t.log_every, f"r2gen epoch {epoch}",
                                      total=steps_per_epoch):
                metrics = step(state, _device_batch(
                    {k: batch[k] for k in keys}, device))
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
                results = score("val", ema)
                logger.write({"epoch": epoch,
                              "val_s": time.perf_counter() - t0, **results})
                save_delta(os.path.join(t.save_dir, delta_filename(
                    epoch, state.step, results)), state.params,
                    config={"task": "r2gen"}, epoch=epoch, step=state.step)
            if t.max_epochs_this_run and (
                epoch - start_epoch + 1 >= t.max_epochs_this_run
            ):
                break
    finally:
        train_b.close()
    return results


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
    t = cfg.train
    device = torch.device(device)
    ann, _, batcher, _ = build_data(cfg)
    model = build_mae_model(cfg, device)
    init_params(model, torch.Generator(device).manual_seed(t.seed))

    def mae_batch(batch, step):
        imgs = torch.from_numpy(batch["images"][:, 0]).to(device)
        return {"images": imgs,
                "mask_noise": mae_mask_noise(t.seed, step, imgs.shape[0],
                                             model.num_patches(imgs), device)}

    lr = t.lr if t.blr <= 0 else scaled_lr(t.blr, cfg.data.batch_size)
    return _fit_pretrain(cfg, "mae", model, mae_loss_fn(model, cfg.model),
                         mae_batch, ann, batcher, lr, on_start)


def _fit_pretrain(cfg: RunConfig, tag: str, model, loss_fn, to_device,
                  ann, batcher, lr: float, on_start) -> dict:
    """The pretraining recipes' common part (MAE, AR, CLIP), from a built and
    initialised model: every parameter trains (AdamW, warmup cosine from
    ``lr``), each step of ``loss_fn(to_device(batch, step))`` logged, a
    full train state every ``train.save_state_every_epochs``, no
    validation. Returns the mean loss of the run's steps."""
    t = cfg.train
    os.makedirs(t.save_dir, exist_ok=True)
    logger = JsonlLogger(t.save_dir)
    params = flax_named_parameters(model)
    n_params = sum(p.numel() for p in params.values())
    print(f"[fit_{tag}] data ready, {n_params} params initialized",
          flush=True)
    steps_per_epoch = max(len(ann["train"]) // cfg.data.batch_size, 1)
    tx = make_adamw(params, warmup_cosine(lr, t.warmup_steps,
                                          steps_per_epoch * t.epochs),
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    state = TrainState(params, tx, ema=t.ema_decay > 0)
    start_epoch = _maybe_resume(state, t)
    if on_start is not None:
        on_start(model, state)

    step = make_train_step(loss_fn, t.accum_steps, t.ema_decay)
    train_b = batcher("train")
    ml = MetricLogger()
    try:
        for epoch in range(start_epoch, t.epochs):
            it = prefetch(train_b.batches(epoch=epoch))
            t_prev = time.perf_counter()
            for batch in ml.log_every(it, t.log_every, f"{tag} epoch {epoch}",
                                      total=steps_per_epoch):
                metrics = step(state, to_device(batch, state.step))
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


def fit_ar(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """MambaXray-VL stage 1, autoregressive pretraining of
    ``VisionMambaAR(**model.vision_kwargs)`` (as in the JAX recipe,
    ``model.vision_size`` is not read: the class defaults are ARM-B's
    widths): every parameter trains, at ``train.blr`` scaled by the batch
    when it is set. Returns the mean loss of the run's steps. ``on_start``
    as in :func:`fit_mrg`."""
    t = cfg.train
    device = torch.device(device)
    ann, _, batcher, _ = build_data(cfg)
    model = VisionMambaAR(**(cfg.model.vision_kwargs or {}), device=device)
    init_params(model, torch.Generator(device).manual_seed(t.seed))
    lr = t.lr if t.blr <= 0 else scaled_lr(t.blr, cfg.data.batch_size)
    return _fit_pretrain(
        cfg, "ar", model, lambda b: model(b["images"][:, 0]),
        lambda b, _: _device_batch({"images": b["images"]}, device), ann,
        batcher, lr, on_start)


def build_clip_model(cfg: RunConfig, vocab_size: int,
                     device=None) -> MambaXrayVLCLIP:
    """``MambaXrayVLCLIP`` as the JAX ``fit_clip`` builds it: the ARM of
    ``model.vision_size`` (the tower is always the ARM), and unless
    ``task_kwargs.text_kwargs`` says otherwise, a scratch text tower of
    depth 2 and ``data.max_len`` positions or, with ``text_tower: bert``,
    a BERT of the tokenizer's vocabulary. Parameters are left
    uninitialised."""
    m = cfg.model
    tkw = dict(m.task_kwargs or {})
    if tkw.get("text_tower") == "bert":
        text_kwargs = tkw.pop("text_kwargs", {"vocab_size": vocab_size})
    else:
        text_kwargs = tkw.pop("text_kwargs", dict(
            vocab_size=vocab_size, depth=2, max_len=cfg.data.max_len))
    arm_kwargs = {"img_size": cfg.data.input_size,
                  **vision_preset("arm", m.vision_size, m.vision_kwargs)}
    return MambaXrayVLCLIP(arm_kwargs=arm_kwargs, text_kwargs=text_kwargs,
                           device=device, **tkw)


def fit_clip(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """MambaXray-VL stage 2, CLIP alignment of the ARM (mean-pooled) and a
    text tower (EOS-pooled) on the reports' ``target_ids``: every parameter
    trains at ``train.lr``; ``model.vision_init`` grafts the ARM from a
    stage-1 artifact first. Returns the mean loss of the run's steps.
    ``on_start`` as in :func:`fit_mrg`."""
    t = cfg.train
    device = torch.device(device)
    ann, tok, batcher, _ = build_data(cfg)
    model = build_clip_model(cfg, tok.vocab_size, device)
    init_params(model, torch.Generator(device).manual_seed(t.seed))
    if cfg.model.vision_init:
        # the AR stage-1 -> CLIP stage-2 graft
        apply_vision_init(flax_named_parameters(model), cfg.model.vision_init,
                          "arm", ("visual_encoder",))
    keys = ("images", "target_ids", "target_mask")
    return _fit_pretrain(
        cfg, "clip", model,
        lambda b: model(b["images"][:, 0], b["target_ids"], b["target_mask"]),
        lambda b, _: _device_batch({k: b[k] for k in keys}, device), ann,
        batcher, t.lr, on_start)


def build_classifier(cfg: RunConfig, device=None):
    """``(model, loss head, head kind)`` of a classification recipe, as the
    JAX ``fit_classify`` builds them: ``dp`` a ViT ``DPClassifier`` with
    the weighted BCE, ``swinchex`` on ``vision=vssm`` a ``VSSMClassifier``
    with the same loss, else ``SwinCheX`` with its per-head 2-way CE; 14
    labels. Parameters are left uninitialised."""
    m = cfg.model
    size = cfg.data.input_size
    if m.task == "dp":
        vk = {"img_size": size,
              **vision_preset("vit", m.vision_size, m.vision_kwargs)}
        return (DPClassifier(14, vit_kwargs=vk, device=device),
                weighted_bce_loss, "sigmoid")
    if m.vision == "vssm":
        vk = vision_preset("vssm", m.vision_size, m.vision_kwargs)
        return (VSSMClassifier(14, vssm_kwargs=vk, device=device),
                weighted_bce_loss, "sigmoid")
    vk = {"img_size": size,
          **vision_preset("swin", m.vision_size, m.vision_kwargs)}
    backbone = SwinTransformer(**vk, device=device)
    return SwinCheX(backbone, 14, device=device), swinchex_loss, "twoway"


def classify_metrics(logits: np.ndarray, labels: np.ndarray,
                     head_kind: str) -> dict:
    """Validation metrics of one split's logits and labels: per-label
    accuracy and mean AUC of the 2-way heads (positive-class softmax
    probability), or mean AUC and the pedestrian metrics of sigmoid
    scores."""
    if head_kind == "twoway":
        e = np.exp(logits - logits.max(-1, keepdims=True))
        scores = (e / e.sum(-1, keepdims=True))[..., 1]
        return {**per_label_accuracy(logits, labels),
                "auc_mean": multilabel_auc(scores, labels)["auc_mean"]}
    scores = 1.0 / (1.0 + np.exp(-logits))
    return {"auc_mean": multilabel_auc(scores, labels)["auc_mean"],
            **pedestrian_metrics(scores, labels)}


def report_labels(reports) -> np.ndarray:
    """(N, 14) fp32 CheXpert labels of the reports."""
    return np.stack([extract_labels(r) for r in reports]).astype(np.float32)


def fit_classify(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """Classification: SwinCheX (``swinchex`` + ``vision=swin``), the VMamba
    classification runner (``swinchex`` + ``vision=vssm``) or the DP ViT
    (``dp``), labels extracted from the reports with the CheXpert rule
    labeler. Every parameter trains (AdamW at ``train.lr``, warmup cosine),
    with batch mixup/cutmix drawn from ``(seed, epoch, step)`` when
    ``train.mixup`` or ``train.cutmix`` is set, and EMA weights for
    validation when ``train.ema_decay`` is. Returns the mean training loss
    and the last validation's metrics (or the metrics of an eval-only
    run). ``on_start`` as in :func:`fit_mrg`."""
    t = cfg.train
    device = torch.device(device)
    os.makedirs(t.save_dir, exist_ok=True)
    logger = JsonlLogger(t.save_dir)
    ann, _, batcher, _ = build_data(cfg)
    bs = cfg.data.batch_size
    if len(ann["train"]) < bs:
        raise ValueError(f"{len(ann['train'])} train samples, fewer than a "
                         f"batch of {bs}")
    model, loss_head, head_kind = build_classifier(cfg, device)
    init_params(model, torch.Generator(device).manual_seed(t.seed))
    params = flax_named_parameters(model)
    m = cfg.model
    if m.vision_init and m.vision in ("vit", "vssm"):
        # the MAE pretrain -> DP encoder graft, or a VSSM tower's
        # (ckpt/bridge.py); as in the JAX recipe, other towers take none
        apply_vision_init(params, m.vision_init, m.vision,
                          ("encoder",) if m.vision == "vit" else ("backbone",))
    print(f"[fit_classify] data ready, "
          f"{sum(p.numel() for p in params.values())} params initialized",
          flush=True)
    steps = max(len(ann["train"]) // bs, 1) * t.epochs
    tx = make_adamw(params, warmup_cosine(t.lr, t.warmup_steps, steps),
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    state = TrainState(params, tx, ema=t.ema_decay > 0)
    start_epoch = _maybe_resume(state, t)
    if on_start is not None:
        on_start(model, state)

    def loss_fn(batch):
        return loss_head(model(batch["images"][:, 0]), batch["labels"])

    def run_eval(split: str, weights=None) -> dict:
        vb = batcher(split)
        all_logits, all_labels = [], []
        try:
            with _swapped(state.params, weights), torch.no_grad():
                for batch in vb.batches(shuffle=False, drop_last=False):
                    images = torch.from_numpy(batch["images"][:, 0])
                    all_logits.append(model(images.to(device)).cpu().numpy())
                    all_labels.append(report_labels(batch["reports"]))
        finally:
            vb.close()
        # the final batch is padded by repeating its last sample: keep one
        # row per sample, or the metrics lean toward the duplicates
        n_val = len(vb.samples)
        return classify_metrics(np.concatenate(all_logits)[:n_val],
                                np.concatenate(all_labels)[:n_val],
                                head_kind)

    if t.eval_only:
        _load_eval_only_weights(state, t)
        scores = run_eval(t.eval_split)
        logger.write({"eval_only": t.eval_split, **scores})
        return scores

    step = make_train_step(loss_fn, t.accum_steps, t.ema_decay)
    train_b = batcher("train")
    ema = state.ema_params if t.ema_decay > 0 else None
    ml = MetricLogger()
    results: dict = {}
    try:
        for epoch in range(start_epoch, t.epochs):
            it = prefetch(train_b.batches(epoch=epoch))
            t_prev = time.perf_counter()
            for i, batch in enumerate(ml.log_every(
                    it, t.log_every, f"cls epoch {epoch}",
                    total=len(ann["train"]) // bs)):
                labels = report_labels(batch["reports"])
                images = batch["images"]
                if t.mixup > 0 or t.cutmix > 0:
                    images, labels = mixup_cutmix(
                        np.random.default_rng((t.seed, epoch, i)), images,
                        labels, mixup_alpha=t.mixup, cutmix_alpha=t.cutmix)
                metrics = step(state, _device_batch(
                    {"images": images, "labels": labels}, device))
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
            if (epoch + 1) % t.val_every_epochs == 0:
                t0 = time.perf_counter()
                results = run_eval("val", ema)
                logger.write({"epoch": epoch,
                              "val_s": time.perf_counter() - t0, **results})
            if t.max_epochs_this_run and (
                epoch - start_epoch + 1 >= t.max_epochs_this_run
            ):
                break
    finally:
        train_b.close()
    return {"loss": ml.meters["loss"].global_avg, **results}


LM_INSTRUCTION = "generate a comprehensive diagnosis report for this study"


def lm_sft_extra(tok, max_len: int):
    """The LM recipe's ``extra_fn``: each sample's report in the alpaca
    prompt, encoded at ``max_len - 1`` with EOS and padded to ``max_len``
    (``lm_ids``, ``lm_mask``; the prompt's words out of the report
    vocabulary encode as ``<unk>``, as in the JAX package)."""

    def lm_extra(sample) -> dict:
        ids = tok.encode(alpaca_prompt(LM_INSTRUCTION, "", sample.report),
                         max_len=max_len - 1, add_eos=True)
        ids, mask = tok.pad(ids, max_len)
        return {"lm_ids": np.asarray(ids, np.int32),
                "lm_mask": np.asarray(mask, np.int32)}

    return lm_extra


def build_lm_model(cfg: RunConfig, vocab_size: int, device=None) -> MambaLM:
    """``MambaLM(vocab_size, **model.lm_kwargs)``, its parameters left
    uninitialised. A ``peft_cfg`` mapping (as YAML gives it) becomes a
    ``MambaPEFTConfig``; its weight-space fields are refused (ROADMAP.md,
    queue 1, item 15b)."""
    kw = dict(cfg.model.lm_kwargs or {})
    pc = kw.get("peft_cfg")
    if isinstance(pc, dict):
        pc = kw["peft_cfg"] = MambaPEFTConfig(**pc)
    if pc is not None and weight_space_fields(pc):
        raise NotImplementedError(
            f"peft_cfg {weight_space_fields(pc)}: the weight-space MambaPEFT "
            "family is not ported yet (ROADMAP.md, queue 1, item 15b)")
    return MambaLM(vocab_size=vocab_size, **kw, device=device)


def fit_lm_sft(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """EMRRG's text finetune: the Mamba LM (``build_lm_model``) trained on
    the reports in alpaca prompts (``lm_sft_extra``) with the next-token
    cross-entropy, every tensor at ``train.lr`` (AdamW, warmup cosine,
    decay masked by flax name: ``A_log``, ``D``, the norms and the
    embedding take none). A validation every ``train.val_every_epochs``
    gives the mean loss over the split's real rows (the padded last batch
    sliced back) and its perplexity; ``eval_only`` scores
    ``train.eval_split`` alone. Returns the last validation's
    ``{val_loss, val_ppl}``. ``on_start`` as in :func:`fit_mrg`."""
    t, d = cfg.train, cfg.data
    device = torch.device(device)
    os.makedirs(t.save_dir, exist_ok=True)
    logger = JsonlLogger(t.save_dir)
    ann, tok, batcher, _ = build_data(cfg)
    lm_extra = lm_sft_extra(tok, d.max_len)
    model = build_lm_model(cfg, tok.vocab_size, device)
    init_params(model, torch.Generator(device).manual_seed(t.seed))
    params = flax_named_parameters(model)
    print(f"[fit_lm_sft] data ready, "
          f"{sum(p.numel() for p in params.values())} params initialized",
          flush=True)
    steps_per_epoch = max(len(ann["train"]) // d.batch_size, 1)
    tx = make_adamw(params, warmup_cosine(t.lr, t.warmup_steps,
                                          steps_per_epoch * t.epochs),
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    state = TrainState(params, tx, ema=t.ema_decay > 0)
    start_epoch = _maybe_resume(state, t)
    if on_start is not None:
        on_start(model, state)
    keys = ("lm_ids", "lm_mask")

    def loss_fn(batch):
        return lm_loss(model(batch["lm_ids"]), batch["lm_ids"],
                       batch["lm_mask"])

    def run_eval(split: str) -> dict:
        vb = batcher(split, extra_fn=lm_extra)
        n_val = len(vb.samples)
        losses, seen = [], 0
        try:
            with torch.no_grad():
                for b in vb.batches(shuffle=False, drop_last=False):
                    bsz = b["lm_ids"].shape[0]
                    real = min(bsz, n_val - seen)
                    seen += bsz
                    if real <= 0:
                        break
                    # the last batch repeats its tail row: keep the real
                    # rows, for an exact mean
                    batch = _device_batch({k: b[k][:real] for k in keys},
                                          device)
                    losses.append((float(loss_fn(batch)), real))
        finally:
            vb.close()
        val_loss = (sum(v * w for v, w in losses)
                    / max(sum(w for _, w in losses), 1)
                    if losses else float("nan"))
        return {"val_loss": val_loss,
                "val_ppl": float(np.exp(min(val_loss, 20.0)))}

    if t.eval_only:
        _load_eval_only_weights(state, t)
        scores = run_eval(t.eval_split)
        logger.write({"eval_only": t.eval_split, **scores})
        return scores

    step = make_train_step(loss_fn, t.accum_steps, t.ema_decay)
    train_b = batcher("train", extra_fn=lm_extra)
    ml = MetricLogger()
    results: dict = {}
    try:
        for epoch in range(start_epoch, t.epochs):
            it = prefetch(train_b.batches(epoch=epoch))
            t_prev = time.perf_counter()
            for batch in ml.log_every(it, t.log_every, f"lm epoch {epoch}",
                                      total=steps_per_epoch):
                metrics = step(state, _device_batch(
                    {k: batch[k] for k in keys}, device))
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
                results = run_eval("val")
                logger.write({"epoch": epoch,
                              "val_s": time.perf_counter() - t0, **results})
            if t.max_epochs_this_run and (
                epoch - start_epoch + 1 >= t.max_epochs_this_run
            ):
                break
    finally:
        train_b.close()
    return results


def fit(cfg: RunConfig, device="cuda", on_start=None) -> dict:
    """The JAX package's dispatch by ``model.task``: ``mae`` to
    :func:`fit_mae`; ``ar`` to :func:`fit_ar`; ``clip`` to
    :func:`fit_clip`; ``r2gen`` to :func:`fit_r2gen`; ``swinchex`` and
    ``dp`` to :func:`fit_classify`; ``mamba_lm_sft`` to
    :func:`fit_lm_sft`; r2gengpt, r2gencsr, am_mrg, r2gen_kg, emrrg and
    mac_rrg to :func:`fit_mrg`."""
    recipes = {"mae": fit_mae, "ar": fit_ar, "clip": fit_clip,
               "r2gen": fit_r2gen, "mamba_lm_sft": fit_lm_sft}
    if cfg.model.task in recipes:
        return recipes[cfg.model.task](cfg, device, on_start)
    if cfg.model.task in ("swinchex", "dp"):
        return fit_classify(cfg, device, on_start)
    return fit_mrg(cfg, device, on_start)
