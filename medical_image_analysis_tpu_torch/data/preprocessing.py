"""Host-side image preprocessing (numpy + PIL).

Counterpart of ``medical_image_analysis_tpu/data/preprocessing.py:
host_preprocess``: resize to ``input_size`` (bicubic), rescale 1/255,
normalise with the ImageNet mean and std. The port keeps its own copy
because the JAX file imports jax.
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
