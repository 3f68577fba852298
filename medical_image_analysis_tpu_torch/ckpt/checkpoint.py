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
  llm_weights_dir``), not from JAX's random draws. JAX train states
  (``state_epoch*.msgpack``, optax's layout) are ROADMAP.md, queue 1,
  item 9;
- a train state (``state_epoch<NNNNN>.pt``) holds every tensor of the run
  (frozen and trainable, LoRA adapters included), the optimizer state,
  the step and the EMA shadow; it is written atomically, and only the
  ``keep`` newest are kept. :func:`auto_resume_helper` finds the newest.

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


def _load_jax_delta(path: str) -> tuple[dict, dict]:
    with open(path, "rb") as f:
        obj = msgpack_restore(f.read())
    meta = obj["meta"]
    config = json.loads(bytes(meta["config"].tolist()).decode() or "{}")
    delta = {}
    for name, t in flatten(obj["model"]).items():
        if isinstance(t, torch.Tensor) and t.numel():
            t = to_port_layout(name.split("/"), t)
        delta[_port_name(name)] = t
    return delta, {"config": config, "epoch": int(meta["epoch"]),
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
    """The newest train state in ``save_dir``, or None."""
    if not os.path.isdir(save_dir):
        return None
    states = sorted(f for f in os.listdir(save_dir) if _STATE_RE.search(f))
    return os.path.join(save_dir, states[-1]) if states else None


def restore_train_state(path: str) -> tuple[dict, int]:
    """Returns (state, epoch), tensors on the CPU."""
    if not is_torch_file(path):
        raise NotImplementedError(
            f"{path}: the JAX package's train states (state_epoch*.msgpack, "
            "optax's layout) are not ported yet (ROADMAP.md, queue 1, "
            "item 9); resume from the port's state_epoch*.pt")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["state"], int(obj["epoch"])
