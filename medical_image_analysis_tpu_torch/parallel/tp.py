"""Tensor parallelism of the LLM over the mesh's ``model`` axis (Megatron).

Counterpart of ``medical_image_analysis_tpu/parallel/tp.py``. The JAX
package states the shardings (:data:`LLM_TP_RULES`, :func:`param_specs`)
and XLA inserts the all-reduces; here :func:`shard_llm` cuts each
matched layer's tensors to this rank's slice and the layers run Megatron's
conjugate operators around their products:

- column-parallel (q/k/v, ``cross_attn_{kv,gate}_proj``, gate/up): the
  input through :func:`copy_to_model` (*f*: identity forward, all-reduce
  of the gradient backward), then the rank's output columns;
- row-parallel (o_proj, down_proj): the rank's input columns, then
  :func:`reduce_from_model` (*g*: all-reduce forward, identity backward);
- the embedding keeps its feature slice (JAX's ``P(None, "model")``) and
  gathers the lookup's features (:func:`gather_from_model`, whose backward
  keeps the rank's slice); ``lm_head`` keeps its vocabulary slice and
  gathers the logits.

So every activation between the layers is whole and equal on the model
group's ranks, as are the gradients flowing back into it. Attention shards
by heads: q/k/v/o shard only where ``n_heads`` and ``n_kv_heads`` divide by
the model axis (JAX's ``fits`` sees only the kernel's columns), the MLP
where ``hidden_dim`` does, the embedding and ``lm_head`` where their
sharded dimension does; everything else runs whole on every rank, never
wrong. EMRRG's fused ``cross_attn_kv_proj`` (its K heads, then its V
heads) shards each half by heads (``parts`` 2). ``QuantDense`` shards
``kernel_q`` and its per-output ``scale`` alike (a row-parallel layer keeps
the whole ``scale``). LoRA adapters stay whole on every rank; a sharded
kernel's merge takes the rank's slice of ``a @ b``, so their gradients
are partial sums, added over the model group by the train step
(:func:`partial_names`). The KV cache holds the rank's heads.
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn

from .mesh import Mesh, all_gather, all_reduce

# (regex over flax paths, spec in the flax layout) — first match wins
LLM_TP_RULES = [
    (r"embed_tokens/embedding", (None, "model")),
    (r"self_attn/(q_proj|k_proj|v_proj)/kernel", (None, "model")),
    (r"self_attn/o_proj/kernel", ("model", None)),
    (r"cross_attn_kv_proj/kernel", (None, "model")),
    (r"cross_attn_gate_proj/kernel", (None, "model")),
    (r"mlp/(gate_proj|up_proj)/kernel", (None, "model")),
    (r"mlp/down_proj/kernel", ("model", None)),
    (r"lm_head/kernel", (None, "model")),
]
REPLICATED = ()


def flax_shape(name: str, shape) -> tuple:
    """A port tensor's shape in the flax layout: Dense kernels (and
    ``kernel_q``) transposed, conv kernels OIHW -> HWIO."""
    shape = tuple(shape)
    if name.rsplit("/", 1)[-1] in ("kernel", "kernel_q"):
        if len(shape) == 2:
            return shape[::-1]
        if len(shape) == 4:
            return (shape[2], shape[3], shape[1], shape[0])
    return shape


def torch_axis(name: str, ndim: int, axis: int) -> int:
    """The port's axis of a tensor's flax ``axis`` (:func:`flax_shape`)."""
    if name.rsplit("/", 1)[-1] in ("kernel", "kernel_q"):
        if ndim == 2:
            return 1 - axis
        if ndim == 4:
            return (2, 3, 1, 0)[axis]
    return axis


def _fits(shape, spec, mesh: Mesh | None) -> bool:
    if mesh is None:
        return True
    if len(shape) < len(spec):
        return False
    return all(name is None or shape[ax] % mesh.size(name) == 0
               for ax, name in enumerate(spec))


def param_specs(params: dict, rules=None, mesh: Mesh | None = None) -> dict:
    """name -> spec in the flax layout (a tuple of axis names, ``()``
    replicated), as the JAX function gives it for the same tree: the first
    rule matching the flax path, replicated where none does or, with
    ``mesh``, where the sharded dimension does not divide. ``params`` maps
    flax paths to port tensors (or shapes)."""
    rules = rules or LLM_TP_RULES
    out = {}
    for name, t in params.items():
        shape = flax_shape(name, getattr(t, "shape", t))
        out[name] = REPLICATED
        for pat, spec in rules:
            if re.search(pat, name):
                out[name] = spec if _fits(shape, spec, mesh) else REPLICATED
                break
    return out


def tp_slice(t: torch.Tensor, axis: int, size: int, index: int,
             parts: int = 1) -> torch.Tensor:
    """Rank ``index``'s slice of ``t`` along ``axis`` among ``size``: of
    each of ``parts`` equal blocks, its ``1/size`` (contiguous)."""
    if size == 1:
        return t
    blocks = t.chunk(parts, dim=axis)
    k = blocks[0].shape[axis] // size
    return torch.cat([b.narrow(axis, index * k, k) for b in blocks],
                     dim=axis).contiguous()


def tp_unslice(pieces: list[torch.Tensor], axis: int,
               parts: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's :func:`tp_slice`, in rank order."""
    if len(pieces) == 1:
        return pieces[0]
    split = [p.chunk(parts, dim=axis) for p in pieces]
    return torch.cat([torch.cat([s[j] for s in split], dim=axis)
                      for j in range(parts)], dim=axis)


def shard_params(mesh: Mesh, params: dict, specs: dict | None = None) -> dict:
    """Each tensor of ``params`` (flax paths -> port tensors) as this
    model rank keeps it: its slice where its spec shards it, else whole.
    The params-only form (serving); a model is sharded by
    :func:`shard_llm`."""
    specs = specs if specs is not None else param_specs(params, mesh=mesh)
    out = {}
    for name, t in params.items():
        spec = specs.get(name, REPLICATED)
        if "model" not in spec:
            out[name] = t
            continue
        ax = torch_axis(name, t.ndim, spec.index("model"))
        out[name] = tp_slice(t, ax, mesh.size("model"), mesh.index("model"))
    return out


# --------------------------------------------------------------------------
# Megatron's operators
# --------------------------------------------------------------------------


def _sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-reduce over the model group in fp32, back in ``x``'s dtype."""
    y = x.float().clone() if x.dtype != torch.float32 else x.clone()
    return all_reduce(y, mesh, "model").to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return all_gather(x, mesh, "model", dim=x.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.mesh.index("model"), ctx.width
        return g[..., i * w : (i + 1) * w].contiguous(), None


def copy_to_model(x, mesh: Mesh | None):
    """*f*: identity; its backward sums the gradient over the model group."""
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh: Mesh | None):
    """*g*: the sum over the model group (in fp32); identity backward."""
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh: Mesh | None):
    """The model ranks' last-axis slices concatenated; the backward keeps
    this rank's slice of the (equal) gradients."""
    return x if mesh is None else _GatherFromModel.apply(x, mesh)


# --------------------------------------------------------------------------
# Sharding a built LLM
# --------------------------------------------------------------------------


def _weights(lin: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """(leaf, parameter) of a Dense or QuantDense, the frozen original of a
    LoRA-parametrized weight included."""
    if hasattr(lin, "kernel_q"):
        out = [("kernel_q", lin.kernel_q), ("scale", lin.scale)]
    elif hasattr(lin, "parametrizations"):
        out = [("kernel", lin.parametrizations.weight.original)]
    else:
        out = [("kernel", lin.weight)]
    if lin.bias is not None:
        out.append(("bias", lin.bias))
    return out


@torch.no_grad()
def _cut(lin: nn.Module, kind: str, mesh: Mesh, parts: int = 1) -> dict:
    """Cut a Dense/QuantDense to this rank's slice: ``kind`` "col" (output
    rows of the Linear layout; its bias and ``scale`` alike) or "row"
    (input columns; bias and ``scale`` whole). Returns {leaf: (axis,
    parts)} of what was cut."""
    m, i = mesh.size("model"), mesh.index("model")
    cut = {}
    for leaf, p in _weights(lin):
        if kind == "col":
            ax = 0
        elif leaf in ("kernel", "kernel_q"):
            ax = 1
        else:
            continue
        p.data = tp_slice(p.data, ax, m, i, parts)
        cut[leaf] = (ax, parts)
    if kind == "col":
        lin.out_features //= m
    else:
        lin.in_features //= m
    for delta in getattr(getattr(lin, "parametrizations", None), "weight",
                         []):
        delta.local = (0 if kind == "col" else 1, m, i, parts)
    return cut


def _spec_ok(lin: nn.Module, path: str, mesh: Mesh, rules) -> bool:
    w = _weights(lin)[0][1]
    name = f"{path}/kernel"
    spec = param_specs({name: w.shape}, rules, mesh)[name]
    return "model" in spec


def shard_llm(lm: nn.Module, mesh: Mesh | None, rules=None) -> dict:
    """Cut a built ``TransformerLM`` (or EMRRG's hybrid one) in place to
    this model rank's slices and switch its layers to the Megatron
    operators; returns {flax path under the LM: (port axis, parts)} of
    every tensor that was cut (the rest stay whole on every rank). A no-op
    on a model axis of one. Apply after the weights and any LoRA adapters
    are in place."""
    if mesh is None or mesh.size("model") == 1:
        return {}
    if getattr(lm, "tp_cut", None) is not None:
        raise ValueError("shard_llm: the LM is cut already")
    rules = rules or LLM_TP_RULES
    m = mesh.size("model")
    cfg = lm.cfg
    cut: dict = {}

    def take(lin, path, kind, parts=1):
        for leaf, how in _cut(lin, kind, mesh, parts).items():
            cut[f"{path}/{leaf}"] = how

    heads_ok = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    for li, layer in enumerate(lm.layers):
        pre = f"layers_{li}"
        attn, mlp = layer.self_attn, layer.mlp
        cols = [("q_proj", "col"), ("k_proj", "col"), ("v_proj", "col"),
                ("o_proj", "row")]
        if hasattr(attn, "cross_attn_kv_proj"):
            cols += [("cross_attn_kv_proj", "col"),
                     ("cross_attn_gate_proj", "col")]
        if heads_ok and all(_spec_ok(getattr(attn, n), f"{pre}/self_attn/{n}",
                                     mesh, rules) for n, _ in cols):
            for n, kind in cols:
                take(getattr(attn, n), f"{pre}/self_attn/{n}", kind,
                     2 if n == "cross_attn_kv_proj" else 1)
            attn.heads = (cfg.n_heads // m, cfg.n_kv_heads // m)
            attn.tp = mesh
        mlp_cols = [("gate_proj", "col"), ("up_proj", "col"),
                    ("down_proj", "row")]
        if all(_spec_ok(getattr(mlp, n), f"{pre}/mlp/{n}", mesh, rules)
               for n, _ in mlp_cols):
            for n, kind in mlp_cols:
                take(getattr(mlp, n), f"{pre}/mlp/{n}", kind)
            mlp.tp = mesh
    emb = lm.embed_tokens
    name = "embed_tokens/embedding"
    if "model" in param_specs({name: emb.weight.shape}, rules, mesh)[name]:
        with torch.no_grad():
            emb.weight.data = tp_slice(emb.weight.data, 1, m,
                                       mesh.index("model"))
        cut[name] = (1, 1)
        lm.embed_tp = mesh
    if lm.lm_head is not None and _spec_ok(lm.lm_head, "lm_head", mesh,
                                           rules):
        take(lm.lm_head, "lm_head", "col")
        lm.head_tp = mesh
    lm.tp_cut = cut
    return cut


def partial_names(names, cut: dict, prefix: str) -> set[str]:
    """Of the trainer's ``names``, the adapters (``lora/<key>/{a,b}``) on
    a cut kernel: whole on every rank, with gradients that are partial sums
    over the model group. ``cut`` is :func:`shard_llm`'s, whose paths lie
    under ``prefix`` (the LM's flax path in the model, ``llm``)."""
    kernels = {f"{prefix}/{p}" for p in cut if p.endswith("/kernel")}
    return {n for n in names if n.startswith("lora/")
            and n[len("lora/"):].rsplit("/", 1)[0].split("@")[0] in kernels}


def gather_tp(t: torch.Tensor, mesh: Mesh | None, how) -> torch.Tensor:
    """The whole tensor from this model rank's slice ``t`` cut as ``how``
    ((axis, parts) of :func:`shard_llm`, or None: whole already)."""
    if how is None or mesh is None or mesh.size("model") == 1:
        return t
    ax, parts = how
    whole = all_gather(t, mesh, "model", dim=ax)
    return tp_unslice(list(whole.chunk(mesh.size("model"), dim=ax)), ax,
                      parts)
