"""The port's own decoder of flax's msgpack files (no ``msgpack`` or ``flax``).

Counterpart of ``flax.serialization.msgpack_restore``, for the subset that
``flax.serialization.msgpack_serialize`` writes and the JAX package's
``ckpt/checkpoint.py:save_delta`` uses:

- maps, arrays, str, bin, nil, booleans, ints and floats;
- ext 1, an ndarray: a nested msgpack array ``(shape, dtype name, bytes)``,
  read with ``torch.frombuffer`` into a CPU tensor; ``bfloat16``, which
  numpy cannot name, becomes ``torch.bfloat16``;
- ext 3, a numpy scalar: the same encoding, returned as a 0-d tensor;
- flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape",
  "chunks"}``, written for leaves above 2**30 bytes), joined again.

Anything else (ext 2, complex scalars; other ext codes; unknown type
bytes) raises ``ValueError``.
"""

from __future__ import annotations

import struct

import torch

DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H",
                                         0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def ext(self, code: int, n: int):
        if code not in (1, 3):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        inner = _Reader(self.take(n))
        shape, name, data = inner.value(raw=True)
        t = _array(tuple(shape), name.decode(), data)
        return t.reshape(()) if code == 3 else t


def _array(shape: tuple, name: str, data: bytes) -> torch.Tensor:
    if name not in DTYPES:
        raise ValueError(f"msgpack: unsupported array dtype {name!r}")
    dtype = DTYPES[name]
    if not data:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def msgpack_restore(data) -> object:
    """Decode one msgpack object (bytes or a buffer) as flax restores it."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes after the object")
    return _unchunk(out)
