"""The port's train state written as the JAX package's ``save_train_state``
writes one, for the tests and ``chip_smoke.py``.

``write_jax_state`` turns a ``TrainState.state_dict()`` of the port into
``state_epoch<NNNNN>.msgpack`` in flax's msgpack layout: ``{"state":
{"step", "params", "opt_state", "ema_params"}, "epoch"}``, the parameters
under flax's ``params`` level and in flax's layouts (Dense kernels (in, out),
conv kernels HWIO), and ``opt_state`` as optax serialises the JAX
``train/optim.py:make_adamw`` chain (with the recipes' ``grad_clip``):
``clip_by_global_norm``'s empty state,
``adamw``'s ``count``/``mu``/``nu``, its decay mask's and the schedule's
states, each tuple and namedtuple a dict keyed ``"0"``, ``"1"``, ... or by
field; with ``masked=True`` the whole chain inside ``optax.masked`` and a
``set_to_zero`` beside it, the frozen tensors' moments empty nodes. A test
holds this writer against the JAX package's own ``save_train_state``.

It imports neither pytest nor the JAX package (the GPU machine has neither
JAX nor the ``msgpack`` package): the encoder below writes the subset of
msgpack that flax's ``msgpack_serialize`` writes for such a tree.
"""

import os
import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_SCALAR = 1, 3


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    if n <= fix_max and fix is not None:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0] is not None:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 1 << 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        else:
            out += b"\xd3" + struct.pack(">q", obj)
    elif isinstance(obj, str):
        data = obj.encode()
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        inner = bytearray()
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes()], inner)
        code = _EXT_SCALAR if isinstance(obj, np.generic) else _EXT_NDARRAY
        _pack_len(out, len(inner), None, -1, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code) + inner
    else:
        raise TypeError(f"msgpack writer: unsupported {type(obj)}")


def msgpack_bytes(obj) -> bytes:
    """``obj`` (dicts of str keys, lists, ints, str, bytes, None, numpy
    arrays and scalars) as flax's ``msgpack_serialize`` encodes it."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _flax_leaf(name: str, t) -> np.ndarray:
    """A port tensor in flax's layout: the inverse of the port's
    ``ckpt/from_jax.py:to_port_layout`` for Dense and conv kernels."""
    a = t.detach().cpu()
    a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    if name.rsplit("/", 1)[-1] == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        else:
            raise ValueError(f"{name}: no flax layout for a rank-{a.ndim} "
                             "kernel")
    return np.ascontiguousarray(a)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *parents, leaf = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return {"params": tree}


def jax_state_tree(state: dict, epoch: int, masked: bool = False) -> dict:
    """The blob that JAX ``save_train_state`` writes for the port's
    ``state`` (``TrainState.state_dict()``): see the module docstring."""
    params = {**state["params"], **state["frozen"]}
    names = sorted(params)
    flat = {n: _flax_leaf(n, params[n]) for n in names}

    def moments(src):
        return _nest({n: _flax_leaf(n, src[n]) if n in state["params"]
                      else {} for n in names})

    count = np.asarray(state["opt"]["count"], np.int32)
    adamw = {"0": {"count": count, "mu": moments(state["opt"]["mu"]),
                   "nu": moments(state["opt"]["nu"])},
             "1": {"inner_state": {}},  # add_decayed_weights' mask
             "2": {"count": count.copy()}}  # the schedule's
    chain = {"0": {}, "1": adamw}  # clip_by_global_norm, adamw
    opt = ({"0": {"inner_state": chain}, "1": {"inner_state": {}}}
           if masked else chain)
    ema = state["ema"]
    if ema is not None:  # the JAX shadow holds every tensor
        ema = _nest({n: _flax_leaf(n, ema[n] if n in ema else params[n])
                     for n in names})
    return {"state": {"step": np.asarray(state["step"], np.int32),
                      "params": _nest(flat), "opt_state": opt,
                      "ema_params": ema},
            "epoch": np.int64(epoch)}


def write_jax_state(save_dir: str, state: dict, epoch: int,
                    masked: bool = False) -> str:
    """Write ``state_epoch<epoch>.msgpack`` into ``save_dir``; returns its
    path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"state_epoch{epoch:05d}.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_bytes(jax_state_tree(state, epoch, masked)))
    return path
