"""MAC-RRG's multi-agent refinement: draft -> agents -> regenerate.

Counterpart of ``medical_image_analysis_tpu/train/mac_driver.py``. The
model drafts a report with no agent context (zero rag and concept
tensors); the knowledge-graph agent embeds the entities of the draft and
their graph neighbourhoods, the retrieval agent embeds the chunks it finds
for them (``data.side_inputs.MACContext``, on the host), and the model
generates again from [image, rag, concept]. ``rounds=1`` is one
refinement of the model's own draft.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.nn.utils import parametrize

from ..ckpt.checkpoint import load_delta, merge_delta
from ..configs.config import RunConfig
from ..evalx.chexbert import clinical_efficacy
from ..evalx.nlg import compute_nlg_scores
from .loop import (
    _device_batch,
    build_data,
    init_mrg_model,
    make_task_adapter,
    mrg_trainables,
)


def refine_mac_rrg(
    cfg: RunConfig,
    params: dict | None = None,
    delta_file: str = "",
    rounds: int = 1,
    split: str = "val",
    max_batches: int = 20,
    device="cuda",
    on_start=None,
) -> dict:
    """Run the draft -> agents -> regenerate loop over ``split`` (at most
    ``max_batches`` batches). Returns ``{"draft": NLG and CE scores,
    "refined": scores, "reports": {id: [refined text]}}``.

    The model is built as ``fit_mrg`` builds it (its LoRA included) and
    initialised from ``train.seed`` (its LLM streamed from
    ``model.llm_weights_dir`` where set); then ``params`` (tensors by the
    run's names, as a delta holds them) or the delta of ``delta_file``
    (``fit_mrg``'s, the port's ``.pt`` or the JAX package's ``.msgpack``)
    is merged over it, else it stays at its random initialisation (a
    plumbing check). A port delta's frozen tensors are the
    initialisation's, so the model is initialised on the device type the
    delta's run initialised on (its ``init_device``) and then moved to
    ``device``. A JAX delta's frozen tensors are JAX's random draws, which
    the port does not reproduce: they match where they come from files
    (``model.llm_weights_dir``). ``on_start(model, named, ctx)``, when given, is called once
    the weights are in place (``named``: the tensors by the run's names),
    before the first generation.
    """
    if cfg.model.task != "mac_rrg":
        raise ValueError("refine_mac_rrg needs model.task=mac_rrg")
    device = torch.device(device)
    ann, tok, batcher, loader = build_data(cfg)
    ad = make_task_adapter(cfg, ann, tok, loader, device)
    ctx = ad.mac_ctx
    init_device = device
    if delta_file:
        params, meta = load_delta(delta_file)
        init_device = meta["config"].get("init_device", device.type)
    model = init_mrg_model(cfg, tok.vocab_size, ad.side_dims, device,
                           init_device)
    named, _ = mrg_trainables(cfg, model)
    if params is not None:
        merge_delta(named, params)
    if on_start is not None:
        on_start(model, named, ctx)
    gcfg = dataclasses.replace(cfg.generate, eos_id=tok.EOS)

    def generate(batch: dict, rag: np.ndarray, con: np.ndarray) -> list:
        work = _device_batch(dict(batch, rag_embeds=rag, concept_embeds=con),
                             device)
        with torch.no_grad(), parametrize.cached():
            out = model.generate(*ad.gen_args(work), gcfg).cpu().numpy()
        return [tok.decode(row) for row in out]

    rag_shape = (ctx.max_chunks, ad.side_dims["rag_dim"])
    con_shape = (ctx.max_entities, ad.side_dims["concept_dim"])
    gts: dict = {}
    draft_res: dict = {}
    refined_res: dict = {}
    ev = batcher(split)
    try:
        for bi, batch in enumerate(ev.batches(shuffle=False,
                                              drop_last=False)):
            if bi >= max_batches:
                break
            b = len(batch["ids"])
            # round 0: the draft, with no agent context
            drafts = generate(batch, np.zeros((b, *rag_shape), np.float32),
                              np.zeros((b, *con_shape), np.float32))
            for i, sid in enumerate(batch["ids"]):
                gts[sid] = [batch["reports"][i]]
                draft_res[sid] = [drafts[i]]
            for _ in range(rounds):
                rag = np.zeros((b, *rag_shape), np.float32)
                con = np.zeros((b, *con_shape), np.float32)
                for i, d in enumerate(drafts):
                    rag[i], con[i] = ctx.agent_embeds(d or "none")
                drafts = generate(batch, rag, con)
            for i, sid in enumerate(batch["ids"]):
                refined_res[sid] = [drafts[i]]
    finally:
        ev.close()

    def score(res: dict) -> dict:
        s = compute_nlg_scores(gts, res)
        s.update(clinical_efficacy(gts, res))
        return s

    return {"draft": score(draft_res), "refined": score(refined_res),
            "reports": refined_res}
