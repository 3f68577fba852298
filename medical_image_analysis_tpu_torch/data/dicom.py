"""Minimal host-side DICOM decoder for chest X-rays (pure numpy).

A copy of ``medical_image_analysis_tpu/data/dicom.py``: the port imports
nothing of the JAX package, not even its numpy-only modules. Supported:
DICOM Part 10 files (128-byte preamble + ``DICM``) and bare datasets,
explicit and implicit VR little endian, with pixel data native
(1.2.840.10008.1.2{,.1}), RLE Lossless (1.2.840.10008.1.2.5: encapsulated
fragments, the 64-byte segment-offset header, PackBits byte planes MSB
first) or JPEG Lossless (1.2.840.10008.1.2.4.{57,70}, ITU T.81 process 14,
SOF3: LUT-decoded Huffman categories and vectorised predictor
reconstruction; SV1, all of syntax .70, and SV2 run as numpy cumsums).
8- and 16-bit MONOCHROME1/2 and RGB; MONOCHROME1 is inverted, the rescale
slope and intercept applied, then windowed (WindowCenter/Width where
present, else the full range) to uint8, the array that feeds
:func:`..preprocessing.decode_scaled`'s resize.
"""

from __future__ import annotations

import struct

import numpy as np

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC",
                      b"UR", b"UT", b"UN"}
_RLE_TS = "1.2.840.10008.1.2.5"
_IMPLICIT_TS = "1.2.840.10008.1.2"
# JPEG Lossless (process 14): .57 = any selection value, .70 = SV1
# (first-order prediction) — the most common PACS export syntax.
_JPEG_LL_TS = {"1.2.840.10008.1.2.4.57", "1.2.840.10008.1.2.4.70"}


class DicomError(ValueError):
    pass


def _read_elements(buf: bytes, start: int, explicit: bool):
    """Yield (group, elem, value_bytes, end_pos) for top-level elements."""
    pos = start
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if explicit and group != 0xFFFE:
            vr = buf[pos:pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        if length == 0xFFFFFFFF:
            # undefined length: encapsulated pixel data or sequence —
            # return the raw remainder; the caller parses fragments.
            yield group, elem, buf[pos:], n
            return
        yield group, elem, buf[pos:pos + length], pos + length
        pos += length


def _rle_unpack(seg: bytes, out_len: int) -> np.ndarray:
    """PackBits decode of one RLE segment (PS3.5 G.3.1)."""
    out = np.empty(out_len, np.uint8)
    i, o, n = 0, 0, len(seg)
    while i < n and o < out_len:
        h = seg[i]
        i += 1
        if h < 128:  # literal run of h+1 bytes
            cnt = h + 1
            out[o:o + cnt] = np.frombuffer(seg, np.uint8, cnt, i)
            i += cnt
            o += cnt
        elif h > 128:  # replicate next byte 257-h times
            cnt = 257 - h
            out[o:o + cnt] = seg[i]
            i += 1
            o += cnt
        # h == 128: no-op
    if o < out_len:
        raise DicomError(f"RLE segment underrun ({o} < {out_len})")
    return out


def _fragments(pixel_blob: bytes) -> list[bytes]:
    """Encapsulated pixel data -> fragments. Item tags (FFFE,E000); the
    first item is the Basic Offset Table, the rest the frame data."""
    pos = 0
    frags = []
    while pos + 8 <= len(pixel_blob):
        group, elem, length = struct.unpack_from("<HHI", pixel_blob, pos)
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            break
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError(f"unexpected tag in encapsulated data: "
                             f"({group:04x},{elem:04x})")
        frags.append(pixel_blob[pos:pos + length])
        pos += length
    if len(frags) < 2:
        raise DicomError("encapsulated pixel data has no frame fragment")
    return frags


def _decode_rle(pixel_blob: bytes, rows: int, cols: int,
                samples: int, bytes_per_sample: int) -> np.ndarray:
    frame = _fragments(pixel_blob)[1]
    n_segs = struct.unpack_from("<I", frame, 0)[0]
    offsets = struct.unpack_from("<15I", frame, 4)[:n_segs]
    if n_segs != samples * bytes_per_sample:
        raise DicomError(
            f"RLE segments {n_segs} != samples*bytes {samples}*"
            f"{bytes_per_sample}")
    npix = rows * cols
    planes = []
    for s, off in enumerate(offsets):
        end = offsets[s + 1] if s + 1 < n_segs else len(frame)
        planes.append(_rle_unpack(frame[off:end], npix))
    # byte planes are MSB first within each sample
    out = np.zeros((samples, npix), np.uint32)
    for s in range(samples):
        for b in range(bytes_per_sample):
            shift = 8 * (bytes_per_sample - 1 - b)
            out[s] += planes[s * bytes_per_sample + b].astype(np.uint32) << shift
    return out.reshape(samples, rows, cols)


# --------------------------------------------------------------------------
# JPEG Lossless (ITU T.81 process 14, SOF3)
# --------------------------------------------------------------------------


def _huff_lut(counts: list[int], symbols: list[int]):
    """Canonical JPEG Huffman table -> 16-bit-peek LUT of
    (symbol, code_length); one array lookup decodes any code."""
    lut = np.zeros(1 << 16, np.uint32)  # (sym << 8) | len
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            sym = symbols[k]
            k += 1
            lo = code << (16 - ln)
            hi = (code + 1) << (16 - ln)
            lut[lo:hi] = (sym << 8) | ln
            code += 1
        code <<= 1
    return lut


class _BitReader:
    """MSB-first bit reader over an un-stuffed entropy segment."""

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 48 and self.pos < len(self.data):
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        if self.nbits <= 48:  # pad past the end (spec: 1-fill)
            pad = 48 - self.nbits + 8
            self.acc = (self.acc << pad) | ((1 << pad) - 1)
            self.nbits += pad

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v


def _extend(v: int, ssss: int) -> int:
    """DIFF magnitude decode (T.81 F.2.2.1): category + bits -> signed."""
    if ssss == 0:
        return 0
    if ssss == 16:  # special: difference is -32768 (no extra bits)
        return 32768
    if v < (1 << (ssss - 1)):
        return v - (1 << ssss) + 1
    return v


def _decode_jpeg_lossless(frame: bytes) -> np.ndarray:
    """JPEG lossless (SOF3) scan -> int32 (rows, cols); single component.

    Supports selection values 1-7 (vectorized reconstruction for SV1/2 —
    SV1 is all of transfer syntax .70); no restart intervals.
    """
    if frame[:2] != b"\xff\xd8":
        raise DicomError("not a JPEG stream (no SOI)")
    pos = 2
    precision = rows = cols = None
    ncomp = 0
    tables: dict[int, np.ndarray] = {}
    psv = pt = None
    table_id = 0
    while pos + 4 <= len(frame):
        if frame[pos] != 0xFF:
            raise DicomError(f"bad marker alignment at {pos}")
        marker = frame[pos + 1]
        pos += 2
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        (seg_len,) = struct.unpack_from(">H", frame, pos)
        seg = frame[pos + 2 : pos + seg_len]
        if marker == 0xC3:  # SOF3
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", seg, 0)
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise DicomError(f"not a lossless JPEG (SOF {marker:02x})")
        elif marker == 0xC4:  # DHT (possibly several tables)
            o = 0
            while o < len(seg):
                tc_th = seg[o]
                counts = list(seg[o + 1 : o + 17])
                nsym = sum(counts)
                syms = list(seg[o + 17 : o + 17 + nsym])
                tables[tc_th & 0x0F] = _huff_lut(counts, syms)
                o += 17 + nsym
        elif marker == 0xDD:  # DRI
            (ri,) = struct.unpack_from(">H", seg, 0)
            if ri:
                raise DicomError("restart intervals not supported")
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            if ns != 1 or ncomp != 1:
                raise DicomError(
                    f"only single-component lossless supported "
                    f"(ns={ns}, nf={ncomp})"
                )
            table_id = seg[2] >> 4
            psv = seg[1 + 2 * ns]
            pt = seg[3 + 2 * ns] & 0x0F
            pos += seg_len
            break
        pos += seg_len
    if rows is None or psv is None:
        raise DicomError("missing SOF3/SOS")
    if psv < 1 or psv > 7:
        raise DicomError(f"bad selection value {psv}")

    # Un-stuff the entropy segment (FF 00 -> FF; stop at any marker).
    raw = bytearray()
    i = pos
    n = len(frame)
    while i < n:
        b = frame[i]
        if b == 0xFF:
            nxt = frame[i + 1] if i + 1 < n else 0xD9
            if nxt == 0x00:
                raw.append(0xFF)
                i += 2
                continue
            break
        raw.append(b)
        i += 1

    lut = tables[table_id]
    br = _BitReader(bytes(raw))
    npix = rows * cols
    diffs = np.empty(npix, np.int32)
    peek16 = br.peek16
    take = br.take
    for j in range(npix):
        e = int(lut[peek16()])
        ssss = e >> 8
        take(e & 0xFF)
        diffs[j] = _extend(take(ssss if ssss < 16 else 0), ssss)
    diffs = diffs.reshape(rows, cols)

    default = 1 << (precision - pt - 1)
    mask = 0xFFFF  # modulo-65536 arithmetic (T.81 H.1.2.1)
    if psv == 1:
        # first column: Rb chain; first row sample 0: default
        out = diffs.copy()
        out[:, 0] = np.cumsum(diffs[:, 0], dtype=np.int64) + default
        out = np.cumsum(out, axis=1, dtype=np.int64) & mask
    elif psv == 2:
        # row 0: Ra chain seeded by default; r>0 predict from above (Rb)
        out = diffs.copy()
        out[0, :] = np.cumsum(diffs[0, :], dtype=np.int64) + default
        out = np.cumsum(out, axis=0, dtype=np.int64) & mask
    else:
        out = np.zeros((rows, cols), np.int64)
        for r in range(rows):
            for c in range(cols):
                if r == 0 and c == 0:
                    pred = default
                elif r == 0:
                    pred = out[0, c - 1]
                elif c == 0:
                    pred = out[r - 1, 0]
                else:
                    ra, rb, rc = out[r, c - 1], out[r - 1, c], out[r - 1, c - 1]
                    pred = {
                        3: rc,
                        4: ra + rb - rc,
                        5: ra + ((rb - rc) >> 1),
                        6: rb + ((ra - rc) >> 1),
                        7: (ra + rb) >> 1,
                    }[psv]
                out[r, c] = (pred + diffs[r, c]) & mask
    if pt:
        out = out << pt
    return out.astype(np.int32)


def decode_dicom(data: bytes) -> np.ndarray:
    """DICOM bytes -> uint8 (H, W) or (H, W, 3) viewing-transformed image."""
    if data[128:132] == b"DICM":
        # File meta group is always explicit VR little endian.
        body_start = 132
        ts = None
        for group, elem, val, end in _read_elements(data, 132, True):
            if group != 0x0002:
                break
            if (group, elem) == (0x0002, 0x0010):
                ts = val.rstrip(b"\x00 ").decode()
            body_start = end
        explicit = ts != _IMPLICIT_TS
    else:
        body_start, ts = 0, None
        # sniff: explicit files have a valid VR at offset 4
        explicit = data[4:6].isalpha() and data[4:6].isupper()

    rows = cols = None
    samples, bits_alloc, pixel_rep = 1, 16, 0
    photometric = "MONOCHROME2"
    slope, intercept = 1.0, 0.0
    wc = ww = None
    pixel = None
    for group, elem, val, _end in _read_elements(data, body_start, explicit):
        tag = (group, elem)
        if tag == (0x0028, 0x0002):
            samples = struct.unpack("<H", val[:2])[0]
        elif tag == (0x0028, 0x0004):
            photometric = val.rstrip(b"\x00 ").decode()
        elif tag == (0x0028, 0x0010):
            rows = struct.unpack("<H", val[:2])[0]
        elif tag == (0x0028, 0x0011):
            cols = struct.unpack("<H", val[:2])[0]
        elif tag == (0x0028, 0x0100):
            bits_alloc = struct.unpack("<H", val[:2])[0]
        elif tag == (0x0028, 0x0103):
            pixel_rep = struct.unpack("<H", val[:2])[0]
        elif tag == (0x0028, 0x1050):
            wc = float(val.split(b"\\")[0])
        elif tag == (0x0028, 0x1051):
            ww = float(val.split(b"\\")[0])
        elif tag == (0x0028, 0x1052):
            intercept = float(val)
        elif tag == (0x0028, 0x1053):
            slope = float(val)
        elif tag == (0x7FE0, 0x0010):
            pixel = val
            break
    if pixel is None or rows is None or cols is None:
        raise DicomError("missing Rows/Columns/PixelData")

    bps = bits_alloc // 8
    if ts == _RLE_TS:
        arr = _decode_rle(pixel, rows, cols, samples, bps).astype(np.float32)
    elif ts in _JPEG_LL_TS:
        if samples != 1:
            raise DicomError("JPEG lossless: single-sample only")
        frame = b"".join(_fragments(pixel)[1:])
        dec = _decode_jpeg_lossless(frame)
        if dec.shape != (rows, cols):
            raise DicomError(
                f"JPEG frame {dec.shape} != dataset ({rows}, {cols})"
            )
        if pixel_rep == 1:  # signed stored values are mod-2^16 coded
            dec = dec.astype(np.uint16).view(np.int16) \
                if bps == 2 else dec.astype(np.uint8).view(np.int8)
        arr = dec.astype(np.float32)[None]
    else:
        dt = {1: np.uint8, 2: np.uint16}[bps]
        arr = np.frombuffer(pixel, dt, rows * cols * samples)
        if pixel_rep == 1:
            arr = arr.astype({1: np.int8, 2: np.int16}[bps])
        if samples > 1:  # interleaved (planar config 0)
            arr = arr.reshape(rows, cols, samples).transpose(2, 0, 1)
        else:
            arr = arr.reshape(1, rows, cols)
        arr = arr.astype(np.float32)

    arr = arr * slope + intercept
    if photometric == "MONOCHROME1":
        arr = arr.max() - arr
    if samples == 1:
        if wc is not None and ww is not None and ww > 0:
            lo, hi = wc - ww / 2.0, wc + ww / 2.0
        else:
            lo, hi = float(arr.min()), float(arr.max())
        arr = np.clip((arr[0] - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
        return np.round(arr * 255.0).astype(np.uint8)
    # RGB: already display values
    return np.clip(arr.transpose(1, 2, 0), 0, 255).astype(np.uint8)
