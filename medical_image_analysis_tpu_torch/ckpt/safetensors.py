"""The port's own reader of safetensors checkpoints (no ``safetensors`` package).

Counterpart of ``SafetensorsIndex`` in ``medical_image_analysis_tpu/ckpt/
hf_load.py``, which reads the shards through the ``safetensors`` package.
A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (relative to
the end of the header), then the raw little-endian data.

:class:`SafetensorsIndex` is a lazy name -> tensor mapping over the shards
of a checkpoint directory: the shards named by
``model.safetensors.index.json`` where it exists, else every
``*.safetensors`` sorted by name. Each lookup maps the tensor's bytes from
an ``mmap`` of its shard and returns a CPU tensor made by
``torch.frombuffer`` over that map (read-only, in the file's dtype: bf16
stays bf16); nothing builds a whole state dict in host RAM. Pass ``device``
to copy a tensor straight onto a card, and ``part`` to read only a
tensor-parallel rank's slice of it (``parallel.tp.tp_slice``'s arguments);
``bytes_read`` counts the bytes of the tensors and slices copied out.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import warnings
from collections.abc import Mapping

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
    "I64": torch.int64,
}


def read_header(path: str) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def shard_files(model_dir: str) -> list[str]:
    """The checkpoint's shards: those of ``model.safetensors.index.json``
    (its ``weight_map``'s files, sorted), else every ``*.safetensors``."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(model_dir, n) for n in names]
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {model_dir}")
    return files


class SafetensorsIndex(Mapping):
    """Lazy name -> tensor view over one or more safetensors shards."""

    def __init__(self, model_dir: str):
        self.bytes_read = 0
        self._where: dict[str, tuple[str, dict, int]] = {}
        self._maps: dict[str, mmap.mmap] = {}
        for path in shard_files(model_dir):
            header, start = read_header(path)
            for name, info in header.items():
                if info["dtype"] not in DTYPES:
                    raise ValueError(
                        f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                        f"the reader takes {sorted(DTYPES)}")
                self._where[name] = (path, info, start)

    def _map(self, path: str) -> mmap.mmap:
        if path not in self._maps:
            with open(path, "rb") as f:
                self._maps[path] = mmap.mmap(f.fileno(), 0,
                                             access=mmap.ACCESS_READ)
        return self._maps[path]

    def tensor(self, key: str, device=None, part=None) -> torch.Tensor:
        """The tensor ``key``: a read-only view of the map on the CPU, or a
        copy on ``device``; with ``part`` = (axis, size, index, parts), that
        slice of it alone, copied out of the map."""
        path, info, start = self._where[key]
        dtype, shape = DTYPES[info["dtype"]], info["shape"]
        lo, hi = info["data_offsets"]
        count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        else:
            buf = memoryview(self._map(path))[start + lo:start + hi]
            with warnings.catch_warnings():  # the map is read-only
                warnings.simplefilter("ignore", UserWarning)
                t = torch.frombuffer(buf, dtype=dtype, count=count)
            t = t.reshape(shape)
        if part is not None:
            axis, size, index, parts = part
            blocks = t.chunk(parts, dim=axis)
            k = blocks[0].shape[axis] // size
            t = torch.cat([b.narrow(axis, index * k, k) for b in blocks],
                          dim=axis)
        self.bytes_read += t.numel() * t.element_size()
        return t if device is None else t.to(device)

    def __contains__(self, key) -> bool:  # without mapping the tensor
        return key in self._where

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in self._where:
            raise KeyError(key)
        return self.tensor(key)

    def __iter__(self):
        return iter(self._where)

    def __len__(self):
        return len(self._where)

    def close(self) -> None:
        """Drop the maps (tensors still viewing them keep them alive)."""
        self._maps.clear()
