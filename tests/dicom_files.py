"""DICOM files for the tests and ``chip_smoke.py``: Part-10 datasets written
in numpy, explicit or implicit VR, native, RLE Lossless (PackBits byte
planes) or JPEG Lossless (a minimal single-component SOF3 encoder, any of
the predictors 1, 2, 4, 7).

The same makers as ``tests/test_dicom.py``'s, in a module of their own
that imports neither pytest nor the JAX package, so that the port's tests
and ``chip_smoke.py`` can write such files.
"""

import struct

import numpy as np

EXPLICIT_TS = "1.2.840.10008.1.2.1"
IMPLICIT_TS = "1.2.840.10008.1.2"
RLE_TS = "1.2.840.10008.1.2.5"


def _el(group, elem, vr, value: bytes) -> bytes:
    tag = struct.pack("<HH", group, elem)
    if vr in ("OB", "OW", "UN", "SQ", "UT"):
        return tag + vr.encode() + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return tag + vr.encode() + struct.pack("<H", len(value)) + value


def _el_implicit(group, elem, value: bytes) -> bytes:
    return struct.pack("<HH", group, elem) + struct.pack("<I", len(value)) + value


def _ds(x) -> bytes:
    s = f"{x}".encode()
    return s + b" " if len(s) % 2 else s


def _packbits(data: bytes) -> bytes:
    """PackBits encode (PS3.5 G.3.1)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            j = i + 1
            while (j < n and j - i < 128
                   and not (j + 1 < n and data[j + 1] == data[j])):
                j += 1
            out.append(j - i - 1)
            out.extend(data[i:j])
            i = j
    return bytes(out)


def make_dicom(pix16: np.ndarray, *, ts=EXPLICIT_TS, photometric="MONOCHROME2",
               wc=None, ww=None, slope=None, intercept=None) -> bytes:
    rows, cols = pix16.shape
    explicit = ts != IMPLICIT_TS
    el = (lambda g, e, vr, v: _el(g, e, vr, v)) if explicit else (
        lambda g, e, vr, v: _el_implicit(g, e, v))
    body = b""
    body += el(0x0028, 0x0002, "US", struct.pack("<H", 1))
    pm = photometric.encode()
    body += el(0x0028, 0x0004, "CS", pm + (b" " if len(pm) % 2 else b""))
    body += el(0x0028, 0x0010, "US", struct.pack("<H", rows))
    body += el(0x0028, 0x0011, "US", struct.pack("<H", cols))
    body += el(0x0028, 0x0100, "US", struct.pack("<H", 16))
    body += el(0x0028, 0x0103, "US", struct.pack("<H", 0))
    if wc is not None:
        body += el(0x0028, 0x1050, "DS", _ds(wc))
        body += el(0x0028, 0x1051, "DS", _ds(ww))
    if intercept is not None:
        body += el(0x0028, 0x1052, "DS", _ds(intercept))
        body += el(0x0028, 0x1053, "DS", _ds(slope))

    if ts == RLE_TS:
        raw = pix16.astype("<u2").tobytes()
        msb = _packbits(raw[1::2])
        lsb = _packbits(raw[0::2])
        if len(msb) % 2:
            msb += b"\x00"
        if len(lsb) % 2:
            lsb += b"\x00"
        header = struct.pack("<I", 2) + struct.pack(
            "<15I", 64, 64 + len(msb), *([0] * 13))
        frame = header + msb + lsb
        pd = struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + \
            struct.pack("<I", 0xFFFFFFFF)
        pd += struct.pack("<HHI", 0xFFFE, 0xE000, 0)  # empty BOT
        pd += struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
        pd += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
        body += pd
    else:
        body += el(0x7FE0, 0x0010, "OW", pix16.astype("<u2").tobytes())

    ts_b = ts.encode() + (b"\x00" if len(ts) % 2 else b"")
    meta = _el(0x0002, 0x0010, "UI", ts_b)
    return b"\x00" * 128 + b"DICM" + meta + body


JPEG_LL_SV1_TS = "1.2.840.10008.1.2.4.70"
JPEG_LL_TS = "1.2.840.10008.1.2.4.57"

# categories 0..16: sixteen 5-bit codes + one 6-bit (canonically valid)
_HUF_COUNTS = [0, 0, 0, 0, 16, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
_HUF_SYMS = list(range(17))


def _huff_codes():
    codes = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(_HUF_COUNTS[ln - 1]):
            codes[_HUF_SYMS[k]] = (code, ln)
            k += 1
            code += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v, nbits):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:  # byte stuffing
                    self.out.append(0x00)
                self.acc = 0
                self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def encode_jpeg_lossless(img: np.ndarray, precision=16, psv=1, pt=0):
    """Minimal single-component SOF3 encoder (test fixture)."""
    rows, cols = img.shape
    img = img.astype(np.int64)
    default = 1 << (precision - pt - 1)
    diffs = np.empty((rows, cols), np.int64)
    for r in range(rows):
        for c in range(cols):
            if r == 0 and c == 0:
                pred = default
            elif r == 0:
                pred = img[0, c - 1]
            elif c == 0:
                pred = img[r - 1, 0]
            elif psv == 1:
                pred = img[r, c - 1]
            elif psv == 2:
                pred = img[r - 1, c]
            elif psv == 4:
                pred = img[r, c - 1] + img[r - 1, c] - img[r - 1, c - 1]
            elif psv == 7:
                pred = (img[r, c - 1] + img[r - 1, c]) >> 1
            else:
                raise NotImplementedError(psv)
            d = int(img[r, c] - pred)
            # wrap to the mod-2^16 representative in [-32768, 32767]
            d = ((d + 32768) & 0xFFFF) - 32768
            diffs[r, c] = d
    codes = _huff_codes()
    bw = _BitWriter()
    for d in diffs.ravel():
        d = int(d)
        if d == -32768:
            code, ln = codes[16]
            bw.put(code, ln)
            continue
        ssss = 0 if d == 0 else int(abs(d)).bit_length()
        code, ln = codes[ssss]
        bw.put(code, ln)
        if ssss:
            v = d if d >= 0 else d + (1 << ssss) - 1
            bw.put(v & ((1 << ssss) - 1), ssss)
    scan = bw.flush()

    dht_payload = bytes([0]) + bytes(_HUF_COUNTS) + bytes(_HUF_SYMS)
    dht = b"\xff\xc4" + struct.pack(">H", 2 + len(dht_payload)) + dht_payload
    sof = b"\xff\xc3" + struct.pack(">HBHHB", 8 + 3, precision, rows,
                                    cols, 1) + bytes([1, 0x11, 0])
    sos = b"\xff\xda" + struct.pack(">HB", 6 + 2, 1) + bytes(
        [1, 0x00, psv, 0, pt])
    return b"\xff\xd8" + dht + sof + sos + scan + b"\xff\xd9"


def make_dicom_jll(pix16: np.ndarray, *, ts=JPEG_LL_SV1_TS, psv=1,
                   wc=None, ww=None) -> bytes:
    frame = encode_jpeg_lossless(pix16, psv=psv)
    if len(frame) % 2:
        frame += b"\x00"
    rows, cols = pix16.shape
    body = b""
    body += _el(0x0028, 0x0002, "US", struct.pack("<H", 1))
    body += _el(0x0028, 0x0004, "CS", b"MONOCHROME2 "[:12].rstrip() + b" ")
    body += _el(0x0028, 0x0010, "US", struct.pack("<H", rows))
    body += _el(0x0028, 0x0011, "US", struct.pack("<H", cols))
    body += _el(0x0028, 0x0100, "US", struct.pack("<H", 16))
    body += _el(0x0028, 0x0103, "US", struct.pack("<H", 0))
    if wc is not None:
        body += _el(0x0028, 0x1050, "DS", _ds(wc))
        body += _el(0x0028, 0x1051, "DS", _ds(ww))
    pd = struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + \
        struct.pack("<I", 0xFFFFFFFF)
    pd += struct.pack("<HHI", 0xFFFE, 0xE000, 0)
    pd += struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
    pd += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    body += pd
    ts_b = ts.encode() + (b"\x00" if len(ts) % 2 else b"")
    meta = _el(0x0002, 0x0010, "UI", ts_b)
    return b"\x00" * 128 + b"DICM" + meta + body
