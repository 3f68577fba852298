"""Packed pre-decoded image shards: decode once offline, read by memmap.

Counterpart of ``medical_image_analysis_tpu/data/packed.py``, in the same
file format, byte for byte, so that either package reads the other's
shards: ``index.json`` (``version`` ``"mia-packed-v1"``, ``size``,
``channels`` 3, ``count``, ``record_bytes``, ``shard_records``, ``ids``,
written by ``json.dump`` in that order) and ``shard-NNNNN.u8`` files of
fixed ``uint8 (size, size, 3)`` records in id order.

- :func:`pack_images` decodes and resizes each ``(id, bytes or path)``
  item once (:func:`decode_any`: JPEG/PNG through
  ``preprocessing.decode_scaled``, DICOM, told by its ``DICM`` magic,
  through the port's ``dicom.decode_dicom`` with the gray channel
  repeated);
- :class:`PackedDataset` maps the shards lazily (``numpy.memmap``); a
  record is a view and a batch one ``np.stack``;
- :func:`packed_image_loader` is a ``disk_image_loader`` in its place:
  each of a sample's image paths looked up by id (else by basename), as
  float32 ``(V, S, S, 3)`` through ``preprocessing.host_preprocess``.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from .preprocessing import decode_scaled, host_preprocess

_MAGIC = "mia-packed-v1"


def _record_shape(size: int) -> tuple[int, int, int]:
    return (size, size, 3)


def decode_any(data, size: int) -> np.ndarray:
    """bytes or a path -> uint8 (size, size, 3): JPEG/PNG through
    ``decode_scaled``, DICOM (by its magic) through ``decode_dicom``, its
    gray channel resized (bicubic) and repeated."""
    blob = data
    if isinstance(data, (str, os.PathLike)):
        with open(data, "rb") as f:
            blob = f.read()
    if len(blob) > 132 and blob[128:132] == b"DICM":
        import PIL.Image

        from .dicom import decode_dicom

        pil = PIL.Image.fromarray(decode_dicom(blob))
        if pil.size != (size, size):
            pil = pil.resize((size, size), PIL.Image.BICUBIC)
        return np.repeat(np.asarray(pil)[:, :, None], 3, axis=2)
    return decode_scaled(io.BytesIO(blob), size)


def pack_images(
    items: Iterable[tuple[str, object]],
    out_dir: str,
    size: int,
    shard_records: int = 1024,
    decode: Callable[[object, int], np.ndarray] | None = None,
) -> dict:
    """Decode and resize ``(id, bytes or path)`` items into fixed-record
    uint8 shards under ``out_dir``; returns the index written."""
    os.makedirs(out_dir, exist_ok=True)
    decode = decode or decode_any
    ids: list[str] = []
    f = None
    try:
        for sample_id, data in items:
            if f is None:
                shard = len(ids) // shard_records
                f = open(os.path.join(out_dir, f"shard-{shard:05d}.u8"), "wb")
            arr = decode(data, size)
            if arr.shape != _record_shape(size) or arr.dtype != np.uint8:
                raise ValueError(f"decode returned {arr.shape}/{arr.dtype}, "
                                 f"want {_record_shape(size)}/uint8")
            f.write(arr.tobytes())
            ids.append(str(sample_id))
            if len(ids) % shard_records == 0:
                f.close()
                f = None
    finally:
        if f is not None:
            f.close()
    index = {
        "version": _MAGIC,
        "size": size,
        "channels": 3,
        "count": len(ids),
        "record_bytes": int(np.prod(_record_shape(size))),
        "shard_records": shard_records,
        "ids": ids,
    }
    with open(os.path.join(out_dir, "index.json"), "w") as fj:
        json.dump(index, fj)
    return index


class PackedDataset:
    """Memmap reader of :func:`pack_images`' shards (either package's)."""

    def __init__(self, path: str):
        with open(os.path.join(path, "index.json")) as f:
            self.index = json.load(f)
        if self.index.get("version") != _MAGIC:
            raise ValueError(f"not a {_MAGIC} directory: {path}")
        self.path = path
        self.size = int(self.index["size"])
        self.count = int(self.index["count"])
        self.shard_records = int(self.index["shard_records"])
        self._id_to_i = {s: i for i, s in enumerate(self.index["ids"])}
        self._maps: dict[int, np.memmap] = {}

    def _shard(self, s: int) -> np.memmap:
        if s not in self._maps:
            n_in = min(self.shard_records, self.count - s * self.shard_records)
            self._maps[s] = np.memmap(
                os.path.join(self.path, f"shard-{s:05d}.u8"), dtype=np.uint8,
                mode="r", shape=(n_in, *_record_shape(self.size)))
        return self._maps[s]

    def __len__(self) -> int:
        return self.count

    def get(self, i: int) -> np.ndarray:
        """uint8 (S, S, 3), a view of the map."""
        s, r = divmod(i, self.shard_records)
        return self._shard(s)[r]

    def by_id(self, sample_id: str) -> np.ndarray:
        return self.get(self._id_to_i[sample_id])

    def has_id(self, sample_id: str) -> bool:
        return sample_id in self._id_to_i

    def batch(self, indices: Sequence[int]) -> np.ndarray:
        """uint8 (N, S, S, 3), one copy."""
        return np.stack([self.get(i) for i in indices])

    def iter_batches(self, batch_size: int, shuffle: bool = False,
                     seed: int = 0) -> Iterator[np.ndarray]:
        """Full batches in index order, or in ``seed``'s shuffle."""
        order = np.arange(self.count)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for lo in range(0, self.count - batch_size + 1, batch_size):
            yield self.batch(order[lo : lo + batch_size])


def packed_image_loader(path: str, input_size: int | None = None):
    """A ``disk_image_loader`` over packed shards: float32 ``(V, S, S, 3)``
    of a sample's image paths, each looked up by id, else by basename."""
    ds = PackedDataset(path)
    if input_size is not None and input_size != ds.size:
        raise ValueError(f"packed shards are {ds.size}px, loader asked "
                         f"{input_size}")

    def load(sample) -> np.ndarray:
        views = []
        for p in sample.image_paths:
            key = p if ds.has_id(p) else os.path.basename(p)
            views.append(host_preprocess(np.asarray(ds.by_id(key)), ds.size))
        return np.stack(views)

    return load
