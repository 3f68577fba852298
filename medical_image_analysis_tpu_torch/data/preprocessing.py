"""Host-side image preprocessing (numpy + PIL).

Counterpart of ``medical_image_analysis_tpu/data/preprocessing.py``:
``host_preprocess`` (resize to ``input_size``, bicubic; rescale 1/255;
normalise with the ImageNet mean and std) and ``decode_scaled``. The port
keeps its own copy because the JAX file imports jax. DICOM decoding
(``data/dicom.py``) is not ported yet (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def host_preprocess(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (size, size, 3), normalized."""
    import PIL.Image

    if img.shape[:2] != (size, size):
        pil = PIL.Image.fromarray(img)
        pil = pil.resize((size, size), PIL.Image.BICUBIC)
        img = np.asarray(pil)
    arr = img.astype(np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def decode_scaled(fp, size: int, fast: bool = True) -> np.ndarray:
    """Decode an image file or file object to uint8 (size, size, 3).

    ``fast=True`` uses libjpeg's DCT-domain scaled decode
    (``PIL.Image.draft``) to the nearest power-of-2 scale >= size and
    resizes in the native mode before expanding to RGB; ``fast=False``
    decodes in full and leaves the resize to :func:`host_preprocess`.
    """
    import PIL.Image

    if isinstance(fp, str):
        is_dicom = fp.lower().endswith(".dcm")
    else:  # file-like: sniff the Part-10 magic at offset 128
        pos = fp.tell()
        fp.seek(128)
        is_dicom = fp.read(4) == b"DICM"
        fp.seek(pos)
    if is_dicom:
        raise NotImplementedError(
            "DICOM decoding (data/dicom.py) is not ported yet (ROADMAP.md, "
            "queue 1, item 9)"
        )
    with PIL.Image.open(fp) as pil:
        if fast:
            pil.draft(pil.mode if pil.mode in ("L", "RGB") else None,
                      (size, size))
            pil = pil.resize((size, size), PIL.Image.BICUBIC)
            if pil.mode != "RGB":
                pil = pil.convert("RGB")
            return np.asarray(pil, np.uint8)
        return np.asarray(pil.convert("RGB"), np.uint8)
