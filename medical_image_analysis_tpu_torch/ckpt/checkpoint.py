"""Checkpoint files of the port: trainable-only deltas and full train states.

Counterpart of ``medical_image_analysis_tpu/ckpt/checkpoint.py`` in the
port's own format, ``torch.save`` of dicts of tensors named by flax path:

- a delta holds the trainable tensors and ``{config, epoch, step}``;
  :func:`merge_delta` copies its tensors over the named ones it finds.
  :func:`load_delta` also reads the JAX package's msgpack deltas (told
  apart by their first bytes: a torch zip starts ``PK``), through the
  port's own decoder (``ckpt/msgpack.py``): the tree is flattened to flax
  names (``ckpt/bridge.py:flatten``) without the ``params`` level, so
  ``base/params/...`` and ``lora/params/...`` of a LoRA run become the
  port's ``base/...`` and ``lora/...``, and every leaf is put in the
  port's layout (``ckpt/from_jax.py:to_port_layout``). Its frozen leaves
  are empty arrays, which :func:`merge_delta` skips. A JAX delta carries
  only the trainable tensors: the frozen ones are the run's, which the
  port reproduces only where they come from files (``model.
  llm_weights_dir``), not from JAX's random draws;
- a train state (``state_epoch<NNNNN>.pt``) holds every tensor of the run
  (frozen and trainable, LoRA adapters included), the optimizer state,
  the step and the EMA shadow; it is written atomically, and only the
  ``keep`` newest are kept. :func:`restore_train_state` also reads the JAX
  package's train states (``state_epoch<NNNNN>.msgpack``, :func:`
  _restore_jax_state`), and :func:`auto_resume_helper` finds the newest
  epoch among both kinds. The port writes only ``.pt``.

- a full checkpoint (:func:`save_full`, :func:`restore_full`: the JAX
  package's orbax ``StandardCheckpointer`` pair, here one ``torch.save``
  file that the port alone reads) holds a train state at any path. A
  state sharded over ranks is gathered first, so every grid saves the
  one-process file, and it restores onto any grid.

Files are loaded with ``weights_only=True``: they hold tensors, numbers,
strings and containers only.
"""

from __future__ import annotations

import json
import os
import re

import torch

from .bridge import flatten
from .from_jax import to_port_layout
from .msgpack import msgpack_restore

_STATE_RE = re.compile(r"state_epoch(\d+)\.pt$")
_ANY_STATE_RE = re.compile(r"state_epoch(\d+)\.(pt|msgpack)$")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_full(path: str, state, step: int | None = None) -> None:
    """Write ``state`` (a ``train.train_state.TrainState``, gathered where
    it is sharded: every rank must call this; or a dict of its
    ``state_dict``) to ``path`` atomically; rank 0 writes."""
    import torch.distributed as dist

    sd = state.state_dict() if hasattr(state, "state_dict") else state
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _save_atomic({"state": _cpu(sd), "step": None if step is None
                  else int(step)}, path)


def restore_full(path: str, target=None):
    """The state :func:`save_full` wrote: copied into ``target`` (a
    ``TrainState``, on any grid: each rank takes its parts) and returned,
    or as a dict of CPU tensors without one."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return obj["state"]
    target.load_state_dict(obj["state"])
    return target


def save_delta(path: str, params: dict[str, torch.Tensor],
               trainable_mask: dict[str, bool] | None = None,
               config: dict | None = None, epoch: int = 0, step: int = 0):
    """Trainable-only delta: ``{"model": {name: tensor}, "meta": {config,
    epoch, step}}``; names whose mask is False are left out."""
    model = {
        n: p for n, p in params.items()
        if trainable_mask is None or trainable_mask[n]
    }
    _save_atomic({"model": _cpu(model),
                  "meta": {"config": dict(config or {}), "epoch": int(epoch),
                           "step": int(step)}}, path)


def _port_name(name: str) -> str:
    """A JAX delta's flat name without its ``params`` level."""
    parts = name.split("/")
    if parts[0] in ("base", "lora") and parts[1:2] == ["params"]:
        del parts[1]
    elif parts[0] == "params":
        del parts[0]
    return "/".join(parts)


def from_jax_tree(tree: dict) -> dict:
    """A JAX tree of parameters (or of optimizer moments, which have the
    parameters' structure) as the port's tensors by name: flax names
    without the ``params`` level (:func:`_port_name`), each non-empty leaf
    in the port's layout (``to_port_layout``: a Dense kernel's moment is
    transposed as its kernel is). Empty dicts (optax's masked nodes)
    vanish; empty arrays (a delta's frozen leaves) stay empty."""
    out = {}
    for name, t in flatten(tree).items():
        if isinstance(t, torch.Tensor) and t.numel():
            t = to_port_layout(name.split("/"), t)
        out[_port_name(name)] = t
    return out


def read_jax_file(path: str):
    """A JAX package's msgpack file, decoded by the port's own reader."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _load_jax_delta(path: str) -> tuple[dict, dict]:
    meta = (obj := read_jax_file(path))["meta"]
    config = json.loads(bytes(meta["config"].tolist()).decode() or "{}")
    return from_jax_tree(obj["model"]), {
        "config": config, "epoch": int(meta["epoch"]),
        "step": int(meta["step"])}


def is_torch_file(path: str) -> bool:
    """A ``torch.save`` zip (it starts ``PK``), not a msgpack map."""
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def load_delta(path: str) -> tuple[dict, dict]:
    """Returns (tensors by name, meta {config, epoch, step}), from the
    port's own delta or a JAX package's msgpack one."""
    if not is_torch_file(path):
        return _load_jax_delta(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["model"], obj["meta"]


@torch.no_grad()
def merge_delta(params: dict[str, torch.Tensor], delta: dict) -> dict:
    """Copy every delta tensor into the tensor of the same name (in
    place, in its dtype and device); names absent from ``params`` are an
    error, names absent from ``delta`` keep their values, and zero-size
    leaves (a JAX delta's frozen tensors) are skipped."""
    delta = {n: v for n, v in delta.items() if v.numel()}
    unknown = sorted(set(delta) - set(params))
    if unknown:
        raise KeyError(f"merge_delta: unknown names {unknown[:5]}")
    for n, v in delta.items():
        params[n].copy_(v)
    return params


def delta_filename(epoch: int, step: int, scores: dict | None = None) -> str:
    """checkpoint_epoch{e}_step{s}_bleu{b}_cider{c}.pt"""
    scores = scores or {}
    b = scores.get("Bleu_4", 0.0)
    c = scores.get("CIDEr", 0.0)
    return f"checkpoint_epoch{epoch}_step{step}_bleu{b:.4f}_cider{c:.4f}.pt"


def save_train_state(save_dir: str, state: dict, epoch: int,
                     keep: int = 3) -> str:
    """Write ``state`` (a dict of tensors and numbers) for ``epoch``
    atomically; prune to the ``keep`` newest states."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"state_epoch{epoch:05d}.pt")
    _save_atomic({"state": _cpu(state), "epoch": int(epoch)}, path)
    states = sorted(f for f in os.listdir(save_dir) if _STATE_RE.search(f))
    for old in states[:-keep]:
        os.remove(os.path.join(save_dir, old))
    return path


def auto_resume_helper(save_dir: str) -> str | None:
    """The train state of the newest epoch in ``save_dir``, the port's
    ``.pt`` or the JAX package's ``.msgpack`` (the port's where both hold
    that epoch), or None."""
    if not os.path.isdir(save_dir):
        return None
    states = [(int(m.group(1)), m.group(2) == "pt", f)
              for f in os.listdir(save_dir)
              if (m := _ANY_STATE_RE.search(f))]
    return os.path.join(save_dir, max(states)[2]) if states else None


def _optax_nodes(tree, adam: list, counts: list) -> None:
    """Collect optax's ``ScaleByAdamState`` nodes (``count``, ``mu``,
    ``nu``) and the other ``count``-only states (the schedule's) of a
    serialised optimizer state, whatever chain, ``masked`` or
    ``set_to_zero`` wraps them (namedtuples and tuples serialise as dicts
    keyed by field name or ``"0"``, ``"1"``, ...)."""
    if not isinstance(tree, dict):
        return
    if {"count", "mu", "nu"} <= set(tree):
        adam.append(tree)
    elif set(tree) == {"count"}:
        counts.append(int(tree["count"]))
    else:
        for v in tree.values():
            _optax_nodes(v, adam, counts)


def _restore_jax_state(obj: dict) -> dict:
    """A JAX ``save_train_state`` blob (``{"state": {step, params,
    opt_state, ema_params}, "epoch"}``) as the port's train state: the
    trainable tensors are those with Adam moments (optax's ``masked``
    leaves none for the frozen ones), the others are ``frozen``; ``mu``,
    ``nu`` and the EMA shadow take their parameters' layouts; ``count`` is
    carried exactly (Adam's bias correction and the schedule read it)."""
    st = obj["state"]
    params = from_jax_tree(st["params"])
    adam, counts = [], []
    _optax_nodes(st["opt_state"], adam, counts)
    if len(adam) != 1:
        raise ValueError(f"JAX train state: {len(adam)} Adam states in "
                         "opt_state, expected 1")
    count = int(adam[0]["count"])
    if any(c != count for c in counts):
        raise ValueError(f"JAX train state: schedule counts {counts} differ "
                         f"from Adam's count {count}")
    mu, nu = from_jax_tree(adam[0]["mu"]), from_jax_tree(adam[0]["nu"])
    unknown = sorted(set(mu) - set(params))
    if unknown or mu.keys() != nu.keys():
        raise ValueError(f"JAX train state: moments without a parameter "
                         f"{unknown[:5]}")
    ema = st.get("ema_params")
    if isinstance(ema, dict):
        ema = {n: t for n, t in from_jax_tree(ema).items() if n in mu}
    return {
        "step": int(st["step"]),
        "params": {n: params[n] for n in mu},
        "frozen": {n: t for n, t in params.items() if n not in mu},
        "opt": {"count": count, "mu": mu, "nu": nu},
        "ema": ema,
    }


def restore_train_state(path: str) -> tuple[dict, int]:
    """Returns (state, epoch), tensors on the CPU, from the port's ``.pt``
    or the JAX package's ``.msgpack`` (:func:`_restore_jax_state`)."""
    if not is_torch_file(path):
        obj = read_jax_file(path)
        return _restore_jax_state(obj), int(obj["epoch"])
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["state"], int(obj["epoch"])
