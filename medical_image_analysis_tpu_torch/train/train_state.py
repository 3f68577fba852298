"""The training step: accumulation, AdamW, EMA, and over a mesh of ranks
data parallelism, tensor parallelism and ZeRO-1.

Counterpart of ``medical_image_analysis_tpu/train/train_state.py``
(``TrainState``, ``zero_opt_specs``, ``state_shardings``, ``shard_state``,
``make_train_step``, ``make_eval_step``).

- The trainable tensors are named (flax paths) and owned by the
  :class:`TrainState`; frozen tensors stay in the model with
  ``requires_grad=False``, so no gradient is computed for them. (The JAX
  step computes the frozen LLM's gradients and zeroes them in the
  optimizer.)
- ``grad_norm`` is the global norm of the averaged gradients of the
  trainable tensors, before clipping. The JAX step's ``grad_norm`` also
  counts the frozen gradients it computed.
- Accumulation splits the leading batch axis into ``accum_steps``
  contiguous micro-batches, sums their fp32 gradients and mean losses,
  and divides both by ``accum_steps`` (``_accum_value_and_grad``).

Over a :class:`..parallel.mesh.Mesh` (``make_train_step(mesh=...)`` on a
state that :func:`shard_state` placed), one step does what the JAX step's
shardings make XLA do, with ``all_reduce`` and ``all_gather`` alone:

- data parallelism: each data rank takes its rows of every micro-batch of
  the global batch (``parallel.mesh.shard_batch``, cut as the JAX step
  cuts it) and computes its share of the global mean loss inside
  ``parallel.mesh.sharded_loss`` (its loss over the data ranks' number,
  masked means over the global count); the gradients and the loss are
  summed over the data group (one flat fp32 buffer);
- tensor parallelism (``parallel.tp.shard_llm``): a cut tensor's gradient
  is its slice's; the adapters on cut kernels (``partial``) are summed
  over the model group first. The clip's global norm counts each cut
  slice once (their squares summed over the model group) and each whole
  tensor once;
- ZeRO-1 (``zero_opt``): each data rank keeps AdamW's moments for its
  slice of every tensor :func:`zero_opt_specs` shards (JAX's rule, read on
  the flax layout, mapped onto the port's transposed Dense and OIHW conv
  layouts), updates that slice, and all-gathers the tensors;
- EMA as in the JAX step, each rank on its own slices.

A sharded state's :meth:`TrainState.state_dict` gathers the cut tensors
and the moments' slices, so it saves the one-process file; its
:meth:`TrainState.load_state_dict` takes such a file on any grid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..parallel.mesh import Mesh, all_gather, all_reduce, sharded_loss
from ..parallel.tp import flax_shape, gather_tp, torch_axis, tp_slice
from .optim import AdamW, global_norm, sq_norm


@dataclasses.dataclass
class ShardPlan:
    """Where a state's tensors lie on the mesh: ``tp`` the trainer's names
    of the tensors cut over the model axis -> (axis, parts); ``zero`` the
    trainable names whose optimizer state and update this data rank holds
    a slice of -> (axis, start, length); ``partial`` the trainable names
    (whole on every rank) whose gradients are partial sums over the model
    group."""

    mesh: Mesh
    tp: dict
    zero: dict
    partial: set


class TrainState:
    """step, trainable params, optimizer state and the EMA shadow.

    ``frozen`` names the run's other tensors, so that a saved state holds
    every tensor of the model, as the JAX package's does. ``plan`` is set
    by :func:`shard_state`.
    """

    def __init__(self, params: dict[str, torch.Tensor], tx: AdamW,
                 ema: bool = False,
                 frozen: dict[str, torch.Tensor] | None = None):
        self.step = 0
        self.params = params
        self.frozen = frozen or {}
        self.tx = tx
        self.ema_params = (
            {n: p.detach().clone() for n, p in params.items()} if ema
            else None
        )
        self.plan: ShardPlan | None = None

    def _whole(self, name: str, t: torch.Tensor,
               zero: bool = False) -> torch.Tensor:
        """The one-process tensor of this rank's ``t`` (a ZeRO slice where
        ``zero``, a model-axis slice where ``name`` is cut)."""
        plan = self.plan
        if plan is None:
            return t.detach()
        if zero and name in plan.zero:
            t = all_gather(t.detach(), plan.mesh, "data",
                           dim=plan.zero[name][0])
        return gather_tp(t.detach(), plan.mesh, plan.tp.get(name))

    def _local(self, name: str, t: torch.Tensor,
               zero: bool = False) -> torch.Tensor:
        """This rank's part of the one-process tensor ``t``."""
        plan = self.plan
        if plan is None:
            return t
        if name in plan.tp:
            ax, parts = plan.tp[name]
            t = tp_slice(t, ax, plan.mesh.size("model"),
                         plan.mesh.index("model"), parts)
        if zero and name in plan.zero:
            t = t.narrow(*plan.zero[name])
        return t

    def whole_params(self) -> dict[str, torch.Tensor]:
        """The trainable tensors as one process holds them (gathered on
        every rank where they are cut: a collective)."""
        return {n: self._whole(n, p) for n, p in self.params.items()}

    def state_dict(self) -> dict:
        """The one-process state (gathered where the state is sharded)."""
        opt = self.tx.state_dict()
        if self.plan is not None:
            opt = {**opt, **{k: {n: self._whole(n, v, zero=True)
                                 for n, v in opt[k].items()}
                             for k in ("mu", "nu")}}
        return {
            "step": self.step,
            "params": {n: self._whole(n, p) for n, p in self.params.items()},
            "frozen": {n: self._whole(n, p) for n, p in self.frozen.items()},
            "opt": opt,
            "ema": None if self.ema_params is None else {
                n: self._whole(n, e) for n, e in self.ema_params.items()},
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a saved state in (this rank's parts of it where the state
        is sharded); the trainable and frozen names must be the saved ones
        (``KeyError``)."""
        for part, mine in (("params", self.params), ("frozen", self.frozen)):
            if state[part].keys() != mine.keys():
                diff = sorted(set(state[part]) ^ set(mine))
                raise KeyError(f"TrainState.load_state_dict: {part} differ "
                               f"from the saved state's: {diff[:5]}")
        self.step = int(state["step"])
        for n, p in self.params.items():
            p.copy_(self._local(n, state["params"][n]))
        for n, p in self.frozen.items():
            p.copy_(self._local(n, state["frozen"][n]))
        opt = state["opt"]
        if self.plan is not None:
            opt = {**opt, **{k: {n: self._local(n, v, zero=True)
                                 for n, v in opt[k].items()}
                             for k in ("mu", "nu")}}
        self.tx.load_state_dict(opt)
        if self.ema_params is not None:
            for n, e in self.ema_params.items():
                e.copy_(self._local(n, state["ema"][n]))


def zero_opt_specs(params: dict, data: int,
                   min_size: int = 1 << 14) -> dict:
    """ZeRO-1 specs of the JAX function for the same tree: name -> a spec
    in the flax layout sharding ONE axis over ``"data"`` (the largest axis
    that ``data`` divides, ties toward the last), or ``()`` for a leaf
    under ``min_size`` elements or with no such axis. ``params`` maps flax
    paths to port tensors or shapes; a shape is read in the flax layout
    (``parallel.tp.flax_shape``)."""
    out = {}
    for name, t in params.items():
        shape = flax_shape(name, getattr(t, "shape", t))
        size = 1
        for dim in shape:
            size *= dim
        best = None
        if shape and size >= min_size:
            for ax, dim in enumerate(shape):
                if dim % data == 0 and dim >= data:
                    if best is None or dim >= shape[best]:
                        best = ax
        if best is None:
            out[name] = ()
        else:
            spec = [None] * len(shape)
            spec[best] = "data"
            out[name] = tuple(spec)
    return out


def state_shardings(state: TrainState, mesh: Mesh, tp: dict | None = None,
                    zero_opt: bool = True, partial: set | None = None,
                    min_size: int = 1 << 14) -> ShardPlan:
    """The :class:`ShardPlan` of ``state`` on ``mesh``: ``tp`` the
    tensors cut over the model axis (trainer names -> (axis, parts),
    ``parallel.tp.shard_llm``'s under the model's prefix), and with
    ``zero_opt`` the slice of each trainable tensor that
    :func:`zero_opt_specs` shards, read on its one-process shape. A
    dimension of this rank's tensor that the data axis does not divide
    stays whole."""
    tp = dict(tp or {})
    d = mesh.size("data")
    zero = {}
    if zero_opt and d > 1:
        shapes = {}
        for n, p in state.params.items():
            shape = list(p.shape)
            if n in tp:
                shape[tp[n][0]] *= mesh.size("model")
            shapes[n] = tuple(shape)
        for n, spec in zero_opt_specs(shapes, d, min_size).items():
            if "data" not in spec:
                continue
            p = state.params[n]
            ax = torch_axis(n, p.ndim, spec.index("data"))
            if p.shape[ax] % d:
                continue
            k = p.shape[ax] // d
            zero[n] = (ax, mesh.index("data") * k, k)
    return ShardPlan(mesh, tp, zero, set(partial or ()))


@torch.no_grad()
def shard_state(state: TrainState, mesh: Mesh, tp: dict | None = None,
                zero_opt: bool = True, partial: set | None = None,
                min_size: int = 1 << 14) -> TrainState:
    """Place a one-process ``state`` on ``mesh`` in place: call it after
    the model's tensors are cut (``parallel.tp.shard_llm``, whose cuts
    ``tp`` names). The optimizer's moments and the EMA shadow of the cut
    tensors are cut alike, and under ZeRO the moments keep this data
    rank's slice (:func:`state_shardings`)."""
    plan = state_shardings(state, mesh, tp, zero_opt, partial, min_size)
    m, i = mesh.size("model"), mesh.index("model")

    def cut(n, t):
        if n not in plan.tp:
            return t
        ax, parts = plan.tp[n]
        return tp_slice(t, ax, m, i, parts)

    tx = state.tx
    tx.mu = {n: cut(n, v) for n, v in tx.mu.items()}
    tx.nu = {n: cut(n, v) for n, v in tx.nu.items()}
    tx.shards = plan.zero
    tx.mu = {n: v.narrow(*plan.zero[n]).clone() if n in plan.zero else v
             for n, v in tx.mu.items()}
    tx.nu = {n: v.narrow(*plan.zero[n]).clone() if n in plan.zero else v
             for n, v in tx.nu.items()}
    if state.ema_params is not None:
        state.ema_params = {n: cut(n, e).clone()
                            for n, e in state.ema_params.items()}
    state.plan = plan
    return state


def accum_value_and_grad(loss_fn: Callable, params: dict[str, torch.Tensor],
                         batch: dict, accum_steps: int):
    """(mean loss, mean fp32 grads) over ``accum_steps`` micro-batches cut
    from the leading axis of every tensor in ``batch``."""
    names = list(params)
    tensors = [params[n] for n in names]
    if accum_steps <= 1:
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, tensors)
        return loss.detach(), dict(zip(names, grads))
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} is not divisible by accum_steps "
                         f"{accum_steps}")
    mb = b // accum_steps
    loss_sum = torch.zeros((), device=tensors[0].device)
    g_sum = [torch.zeros_like(t, dtype=torch.float32) for t in tensors]
    for i in range(accum_steps):
        micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
        loss = loss_fn(micro)
        grads = torch.autograd.grad(loss, tensors)
        for acc, g in zip(g_sum, grads):
            acc.add_(g.float())
        loss_sum = loss_sum + loss.detach()
    inv = 1.0 / accum_steps
    return loss_sum * inv, {
        n: (g * inv).to(t.dtype) for n, g, t in zip(names, g_sum, tensors)
    }


def _sum_flat(tensors: list[torch.Tensor], mesh: Mesh, axis: str) -> None:
    """Sum ``tensors`` in place over ``axis`` through one fp32 buffer."""
    if not tensors or mesh.groups[axis] is None:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, mesh, axis)
    off = 0
    for t in tensors:
        t.copy_(flat[off : off + t.numel()].view_as(t))
        off += t.numel()


def _gather_owned(params: dict, plan: ShardPlan) -> None:
    """All-gather every ZeRO-sharded tensor's slices over the data group
    (one buffer a dtype) into the whole tensor on every data rank."""
    mesh, d = plan.mesh, plan.mesh.size("data")
    by_dtype: dict = {}
    for n in plan.zero:
        by_dtype.setdefault(params[n].dtype, []).append(n)
    for names in by_dtype.values():
        owned = [params[n].narrow(*plan.zero[n]) for n in names]
        flat = all_gather(torch.cat([o.reshape(-1) for o in owned]), mesh,
                          "data")
        ranks = flat.chunk(d)
        off = 0
        for n, o in zip(names, owned):
            ax = plan.zero[n][0]
            pieces = [r[off : off + o.numel()].view_as(o) for r in ranks]
            params[n].copy_(torch.cat(pieces, dim=ax))
            off += o.numel()


def make_train_step(loss_fn: Callable, accum_steps: int = 1,
                    ema_decay: float = 0.0,
                    check: Callable | None = None,
                    mesh: Mesh | None = None):
    """``step(state, batch) -> {"loss", "grad_norm", "lr"}``, updating
    ``state`` in place. ``loss_fn(batch)`` is a scalar tensor; ``batch``
    maps names to tensors on the device: with ``mesh``, this data rank's
    rows of the global batch (``parallel.mesh.shard_batch`` with the same
    ``accum_steps``), and ``state`` placed by :func:`shard_state` (the
    module's docstring says what the step does then). ``check(loss,
    grads)``, when given, sees the loss and the gradients before the update
    (``train.debug_nans``)."""
    n_data = 1 if mesh is None else mesh.size("data")

    def share(batch):
        return loss_fn(batch) / n_data if n_data > 1 else loss_fn(batch)

    @torch.no_grad()
    def reduce_grads(state, loss, grads):
        plan = state.plan
        _sum_flat([grads[n] for n in sorted(plan.partial)], mesh, "model")
        _sum_flat([loss.reshape(1), *grads.values()], mesh, "data")
        whole = [g for n, g in grads.items() if n not in plan.tp]
        cut = [g for n, g in grads.items() if n in plan.tp]
        sq_cut = (sq_norm(cut) if cut
                  else torch.zeros((), device=loss.device))
        sq_cut = all_reduce(sq_cut.reshape(1).float().clone(), mesh,
                            "model")[0]
        sq_whole = (sq_norm(whole) if whole
                    else torch.zeros((), device=loss.device))
        return torch.sqrt(sq_whole + sq_cut)

    def step(state: TrainState, batch: dict) -> dict:
        with sharded_loss(mesh):
            loss, grads = accum_value_and_grad(share, state.params, batch,
                                               accum_steps)
        grads = {n: g.contiguous() for n, g in grads.items()}
        if state.plan is not None:
            gnorm = reduce_grads(state, loss, grads)
        else:
            gnorm = global_norm(grads.values())
        if check is not None:
            check(loss, grads)
        lr = state.tx.step(grads, norm=gnorm)
        if state.plan is not None and state.plan.zero:
            with torch.no_grad():
                _gather_owned(state.params, state.plan)
        if state.ema_params is not None and ema_decay > 0.0:
            with torch.no_grad():
                for n, e in state.ema_params.items():
                    p = state.params[n]
                    e.copy_((ema_decay * e.float()
                             + (1.0 - ema_decay) * p.float()).to(e.dtype))
        state.step += 1
        return {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step


def make_eval_step(loss_fn: Callable, mesh: Mesh | None = None):
    """``eval_step(batch) -> loss``: the global batch's mean loss, without
    gradients, from this data rank's rows (as :func:`make_train_step`
    takes them)."""
    n_data = 1 if mesh is None else mesh.size("data")

    @torch.no_grad()
    def eval_step(batch: dict) -> torch.Tensor:
        with sharded_loss(mesh):
            loss = loss_fn(batch).float().reshape(1) / n_data
        return all_reduce(loss, mesh, "data")[0] if n_data > 1 else loss[0]

    return eval_step
