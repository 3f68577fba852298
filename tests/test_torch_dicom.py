"""The port's DICOM decoder (a copy of the JAX package's) and
``decode_scaled``'s DICOM branch against the JAX package, on CPU.

Every transfer syntax of ``tests/test_dicom.py`` (explicit and implicit
VR native, RLE, JPEG Lossless SV1 and the other predictors), with window,
rescale and MONOCHROME1 inversion, written by ``tests/dicom_files.py``:
the decoded uint8 arrays equal the JAX decoder's exactly, and so do
``decode_scaled``'s (a ``.dcm`` path and a file object sniffed by its
magic). A truncated file raises in both.
"""

import io

import numpy as np
import pytest

import dicom_files as df
from medical_image_analysis_tpu.data import dicom as jax_dicom
from medical_image_analysis_tpu.data import preprocessing as jax_prep
from medical_image_analysis_tpu_torch.data import dicom, preprocessing


def _pix(seed=0, shape=(37, 29)):
    return np.random.default_rng(seed).integers(0, 4096, shape).astype(
        np.uint16)


def _grad():
    rng = np.random.default_rng(7)
    pix = (np.cumsum(rng.integers(-9, 10, (23, 31)), axis=1)
           + 2048).astype(np.uint16)
    pix[5, 5], pix[6, 6] = 0, 65535
    return pix


CASES = {
    "explicit_minmax": lambda: df.make_dicom(_pix()),
    "explicit_window_rescale": lambda: df.make_dicom(
        _pix(), wc=1500, ww=2000, slope=2, intercept=-100),
    "monochrome1": lambda: df.make_dicom(_pix(), photometric="MONOCHROME1"),
    "implicit": lambda: df.make_dicom(_pix(), ts=df.IMPLICIT_TS),
    "rle": lambda: df.make_dicom(_pix(), ts=df.RLE_TS),
    "rle_constant": lambda: df.make_dicom(
        np.full((16, 20), 777, np.uint16), ts=df.RLE_TS),
    "jll_sv1": lambda: df.make_dicom_jll(_pix()),
    "jll_sv1_exact": lambda: df.make_dicom_jll(_grad(), wc=32768, ww=65536),
    "jll_sv2": lambda: df.make_dicom_jll(_pix(), ts=df.JPEG_LL_TS, psv=2),
    "jll_sv4": lambda: df.make_dicom_jll(_pix(), ts=df.JPEG_LL_TS, psv=4),
    "jll_sv7": lambda: df.make_dicom_jll(_pix(), ts=df.JPEG_LL_TS, psv=7),
    "jll_constant": lambda: df.make_dicom_jll(
        np.full((9, 9), 1234, np.uint16), wc=1234, ww=100),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_jax(case):
    data = CASES[case]()
    got = dicom.decode_dicom(data)
    want = jax_dicom.decode_dicom(data)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_decode_scaled_dicom_equals_jax(tmp_path):
    data = df.make_dicom_jll(_pix(3, (48, 40)), wc=2000, ww=3000)
    path = tmp_path / "study.dcm"
    path.write_bytes(data)
    want = jax_prep.decode_scaled(str(path), 32)
    assert want.shape == (32, 32, 3)
    np.testing.assert_array_equal(preprocessing.decode_scaled(str(path), 32),
                                  want)
    np.testing.assert_array_equal(
        preprocessing.decode_scaled(io.BytesIO(data), 32), want)


def test_truncated_raises():
    bad = b"\x00" * 128 + b"DICM" + b"\x12\x34"
    with pytest.raises(Exception):
        jax_dicom.decode_dicom(bad)
    with pytest.raises(Exception):
        dicom.decode_dicom(bad)
