"""Host-side image IO: decode and encode only.

Frames are resized to the model size at decode time (PIL bilinear, like the
reference's torchvision Resize((224, 384))); everything after runs on the
device. Same behaviour as ``vinet_tpu/io/images.py``.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

MODEL_H, MODEL_W = 224, 384


def load_frame(path: str, *, size=(MODEL_H, MODEL_W)) -> tuple[np.ndarray, tuple]:
    """Decode an RGB frame and resize it to size=(H, W). Returns (H x W x 3
    uint8, original (W, H) in PIL's convention)."""
    img = Image.open(path).convert("RGB")
    orig = img.size
    img = img.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8), orig


def save_map(arr: np.ndarray, path: str) -> None:
    """Save a saliency map as 8-bit grayscale with the reference's img_save
    quantisation (min-max normalise, then round(x*255 + 0.5)) in f64.

    uint8 input must already be normalised and quantised
    (ops/image.py::quantize_maps_u8) and is written as it is."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = a.astype(np.float64)
        mn, mx = a.min(), a.max()
        a = (a - mn) / (mx - mn) if mx > mn else np.zeros_like(a)
        a = np.clip(np.round(a * 255.0 + 0.5), 0, 255).astype(np.uint8)
    im = Image.fromarray(a)
    if path.lower().endswith((".jpg", ".jpeg")):
        im.save(path, quality=100)
    else:
        im.save(path)
