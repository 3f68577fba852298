"""Image preprocessing: host-side decoding and resizing, and the on-device path.

Counterpart of ``medical_image_analysis_tpu/data/preprocessing.py``:
``host_preprocess`` (resize to ``input_size``, bicubic; rescale 1/255;
normalise with the ImageNet mean and std), ``decode_scaled`` (JPEG/PNG
through PIL, ``.dcm`` through the port's copy of the DICOM decoder,
``data/dicom.py``) and :func:`device_preprocess`, the same normalisation
after a bilinear resize, on the tensors' device in torch. The port keeps
its own copy because the JAX file imports jax.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .dicom import decode_dicom

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
        # uncompressed, RLE or JPEG Lossless, windowed to uint8 (H, W), then
        # the same resize and RGB expansion
        if isinstance(fp, str):
            with open(fp, "rb") as f:
                data = f.read()
        else:
            data = fp.read()
        pil = PIL.Image.fromarray(decode_dicom(data))
        pil = pil.resize((size, size), PIL.Image.BICUBIC)
        if pil.mode != "RGB":
            pil = pil.convert("RGB")
        return np.asarray(pil, np.uint8)
    with PIL.Image.open(fp) as pil:
        if fast:
            pil.draft(pil.mode if pil.mode in ("L", "RGB") else None,
                      (size, size))
            pil = pil.resize((size, size), PIL.Image.BICUBIC)
            if pil.mode != "RGB":
                pil = pil.convert("RGB")
            return np.asarray(pil, np.uint8)
        return np.asarray(pil.convert("RGB"), np.uint8)


def device_preprocess(raw: torch.Tensor, size: int,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 (B, H, W, C) -> ``dtype`` (B, size, size, C) on ``raw``'s
    device: /255 in fp32, a bilinear resize, the ImageNet normalisation.

    The resize is ``jax.image.resize(..., "bilinear")``'s: half-pixel
    centres and a triangle filter that is widened by the scale when it
    downsamples (antialiasing) and not when it upsamples, with the weights
    of each output normalised over the pixels inside the image; that is
    ``F.interpolate(mode="bilinear", antialias=True)``.
    """
    x = raw.float() / 255.0
    b, h, w, c = x.shape
    if (h, w) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    mean = torch.as_tensor(IMAGENET_MEAN[:c], device=x.device)
    std = torch.as_tensor(IMAGENET_STD[:c], device=x.device)
    return ((x - mean) / std).to(dtype)
