"""A (data, model) grid of ranks over ``torch.distributed``, and its collectives.

Counterpart of ``medical_image_analysis_tpu/parallel/mesh.py``. The JAX
package lays a ``jax.sharding.Mesh`` over devices and lets the compiler
place the collectives; here each rank is a process, and the grid names two
kinds of process group:

- ``data``: the ranks that hold the same slice of the model and different
  rows of the batch (data parallelism, ZeRO-1);
- ``model``: the ranks that hold different slices of the LLM's kernels and
  the same rows (tensor parallelism, :mod:`.tp`).

Rank ``r`` sits at ``(r // model, r % model)``, as JAX reshapes its device
list to ``(data, model)``: a model group is ``model`` consecutive ranks, so
with torchrun's numbering it stays on one host (:func:`make_hybrid_mesh`).

The collectives (:func:`all_reduce`, :func:`all_gather`, :func:`broadcast`)
are the only ones the port uses, so that one code path runs on gloo (CPU
tensors, or CUDA tensors of processes that share one card) and on NCCL (a
card a rank): gloo has no reduce-scatter. Each adds the bytes it puts in to
:data:`traffic`, and each is a no-op over a group of one.

A loss that averages over the batch computes each data rank's share of the
global batch's mean inside :func:`sharded_loss`: the train step divides
each rank's loss by the data ranks' number and sums the gradients, so a
mean over equal shards needs nothing more, a mean over a count that differs
between ranks (masked tokens) divides by :func:`loss_denominator`, and a
loss over the whole batch (CLIP's contrastive loss) gathers its rows with
:func:`gather_rows`, whose backward sums over the data ranks.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# bytes this process put into each kind of collective since the last reset
traffic = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
AXES = ("data", "model")


def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


class Mesh:
    """The (data, model) grid: ``shape`` and ``axis_names`` as the JAX
    mesh's, this rank's place in it (:meth:`index`) and its process group
    along each axis (None for a group of one). ``groups=False`` makes a
    grid without process groups, for what needs only a rank's place (its
    slices of a checkpoint: ``ckpt.hf_load.load_llm_params``)."""

    axis_names = AXES

    def __init__(self, data: int, model: int, rank: int = 0,
                 groups: bool = True):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.coords = {"data": rank // model, "model": rank % model}
        self.groups: dict = {"data": None, "model": None}
        members = {
            "data": [[d * model + m for d in range(data)]
                     for m in range(model)],
            "model": [[d * model + m for m in range(model)]
                      for d in range(data)],
        }
        for axis in AXES:
            for ranks in members[axis]:
                if len(ranks) < 2 or not groups:
                    continue
                # every rank creates every group, in the same order
                g = dist.new_group(ranks)
                if rank in ranks:
                    self.groups[axis] = g
        self.members = members

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def world(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank})")


def world_and_rank() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """(data, model) grid over every rank; ``data=-1`` takes what ``model``
    leaves. ``data * model`` must be the world size."""
    n, rank = world_and_rank()
    if data == -1:
        assert n % model == 0, f"model={model} does not divide {n} processes"
        data = n // model
    assert data * model == n, f"{data}x{model} != {n} processes"
    return Mesh(data, model, rank)


def make_hybrid_mesh(data: int = -1, model: int = 1) -> Mesh:
    """:func:`make_mesh` whose ``model`` groups stay on one host (their
    collectives on NVLink) and whose ``data`` groups span hosts. torchrun
    numbers a host's ranks consecutively (``LOCAL_WORLD_SIZE`` of them), so
    this holds where ``model`` divides them; on one host it is
    :func:`make_mesh`."""
    n, _ = world_and_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if local < n and local % model:
        raise ValueError(f"model={model} does not divide the {local} ranks "
                         "of a host: a model group would span hosts")
    return make_mesh(data, model)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = 1800.0) -> bool:
    """Join the job's process group: the JAX package's
    ``jax.distributed.initialize`` bootstrap, from the same variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``)
    or torchrun's (``MASTER_ADDR`` + ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) when the arguments are omitted. Returns False, doing nothing,
    for a single process.

    The backend is NCCL where every rank of a host has its own card
    (``LOCAL_WORLD_SIZE`` <= the cards; the rank then takes
    ``cuda:LOCAL_RANK``), else gloo (CPU tensors, or CUDA tensors of ranks
    that share a card). ``timeout_s`` bounds every collective's wait.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (os.environ["MASTER_ADDR"] + ":"
                + os.environ.get("MASTER_PORT", "1234"))
    n = num_processes or int(os.environ.get(
        "JAX_NUM_PROCESSES", os.environ.get("WORLD_SIZE", 1)))
    rank = (process_id if process_id is not None else int(os.environ.get(
        "JAX_PROCESS_ID", os.environ.get("RANK", 0))))
    if addr is None or n <= 1:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if own_card(n) else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


def own_card(n: int | None = None) -> bool:
    """Whether every rank of this host has a card of its own."""
    n = n or world_and_rank()[0]
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return torch.cuda.is_available() and local <= torch.cuda.device_count()


def rank_device(device) -> torch.device:
    """This rank's device for a run asked to go on ``device``: a CUDA
    request goes to ``cuda:LOCAL_RANK``, or onto the card the host's ranks
    share where they outnumber its cards (``LOCAL_RANK`` modulo the
    cards); the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    n, _ = world_and_rank()
    if n <= 1:
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, mesh: Mesh | None, axis: str):
    """Sum ``t`` in place over ``axis`` of ``mesh``; returns it."""
    g = None if mesh is None else mesh.groups[axis]
    if g is None:
        return t
    traffic["all_reduce"] += _nbytes(t)
    dist.all_reduce(t, group=g)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh | None, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` of ``mesh``, concatenated on ``dim``
    in rank order (equal shapes on every rank)."""
    g = None if mesh is None else mesh.groups[axis]
    if g is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    traffic["all_gather"] += _nbytes(t)
    dist.all_gather(parts, t, group=g)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, mesh: Mesh | None,
              axis: str | None = None) -> torch.Tensor:
    """``t`` of the first rank along ``axis`` (of every rank of the job
    where ``axis`` is None: rank 0's), in place."""
    if mesh is None or mesh.world == 1:
        return t
    if axis is None:
        g, src = None, 0
    else:
        g = mesh.groups[axis]
        if g is None:
            return t
        src = next(r for r in mesh.members[axis] if mesh.rank in r)[0]
    traffic["broadcast"] += _nbytes(t)
    dist.broadcast(t, src, group=g)
    return t


def broadcast_batch(mesh: Mesh | None, batch: dict) -> dict:
    """Rank 0's tensors of ``batch`` on every rank, in place: every rank
    reads a batch of the same shapes, and its values are rank 0's (a
    loader's random draws, the synthetic images' per-process hash seeds,
    cannot differ between ranks)."""
    if mesh is None or mesh.world == 1:
        return batch
    for v in batch.values():
        if isinstance(v, torch.Tensor):
            broadcast(v, mesh)
    return batch


def shard_rows(x, mesh: Mesh | None, accum_steps: int = 1):
    """This data rank's rows of a global batch array (numpy or torch) cut
    as the JAX step cuts it: ``accum_steps`` contiguous micro-batches, each
    sharded over ``data``; the rank's rows of each, in micro-batch order,
    so that the step's accumulation over its own rows meets the same
    micro-batches."""
    d = 1 if mesh is None else mesh.size("data")
    if d == 1:
        return x
    b = x.shape[0]
    if b % (accum_steps * d):
        raise ValueError(f"batch {b} is not divisible by accum_steps "
                         f"{accum_steps} x data {d}")
    mb, i = b // accum_steps, mesh.index("data")
    lmb = mb // d
    pieces = [x[k * mb + i * lmb : k * mb + (i + 1) * lmb]
              for k in range(accum_steps)]
    if isinstance(x, np.ndarray):
        return np.concatenate(pieces)
    return torch.cat(pieces)


def shard_batch(mesh: Mesh | None, batch: dict, accum_steps: int = 1) -> dict:
    """:func:`shard_rows` of every array of ``batch``; other values kept."""
    return {k: shard_rows(v, mesh, accum_steps)
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim else v
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# Losses over a sharded batch
# --------------------------------------------------------------------------

_LOSS_MESH: Mesh | None = None


@contextlib.contextmanager
def sharded_loss(mesh: Mesh | None):
    """Within the block, a loss sees its rows as this data rank's share of
    the global batch of ``mesh`` (see the module's docstring)."""
    global _LOSS_MESH
    prev = _LOSS_MESH
    _LOSS_MESH = mesh if mesh is not None and mesh.size("data") > 1 else None
    try:
        yield
    finally:
        _LOSS_MESH = prev


def loss_denominator(den: torch.Tensor, minimum: float | None = None):
    """The denominator of a mean whose count ``den`` differs between data
    ranks: ``max(den, minimum)`` alone, and inside :func:`sharded_loss` the
    global batch's ``max(sum of den over the data ranks, minimum)`` divided
    by their number (the step divides the loss by that number again)."""
    m = _LOSS_MESH
    if m is None:
        return den if minimum is None else torch.clamp(den, min=minimum)
    g = all_reduce(den.detach().float().clone(), m, "data")
    if minimum is not None:
        g = torch.clamp(g, min=minimum)
    return g / m.size("data")


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather(x, mesh, "data")

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.mesh, "data")
        i = ctx.mesh.index("data")
        return g[i * ctx.rows : (i + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Inside :func:`sharded_loss`, the global batch's rows of ``x`` (every
    data rank's, in rank order), differentiable: the backward sums the
    ranks' gradients and keeps this rank's rows. Outside it, ``x``."""
    m = _LOSS_MESH
    return x if m is None else _GatherRows.apply(x, m)
