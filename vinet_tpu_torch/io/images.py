"""Host-side image IO: decode and encode only.

Frames are resized to the model size at decode time (PIL bilinear, like the
reference's torchvision Resize((224, 384))); train GT maps to the model size
with OpenCV's non-antialiased bilinear, written here in numpy; everything
after runs on the device. Same behaviour as ``vinet_tpu/io/images.py``.
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


def _linear_taps(n_in: int, n_out: int):
    """Source samples (i0, i1) and the weight of i1 for each of n_out samples
    of a length-n_in axis: half-pixel centres, edges clamped, in f64."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    frac[(i0 < 0) | (i0 >= n_in - 1)] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def _resize_linear(img: np.ndarray, size: tuple) -> np.ndarray:
    """(H, W) float64 -> size=(h, w): bilinear with half-pixel centres and no
    antialiasing, what OpenCV's cv2.resize(img, (w, h)) (INTER_LINEAR) gives
    for float64 input, within 1e-13."""
    x0, x1, fx = _linear_taps(img.shape[1], size[1])
    y0, y1, fy = _linear_taps(img.shape[0], size[0])
    rows = img[:, x0] * (1.0 - fx) + img[:, x1] * fx  # (H, w)
    return rows[y0] * (1.0 - fy)[:, None] + rows[y1] * fy[:, None]


def load_map(path: str, *, size=None) -> np.ndarray:
    """Decode a grayscale GT map to f32 in [0, 1]. size=(H, W) resizes it in
    f64 with OpenCV's bilinear (``_resize_linear``), as the reference's
    cv2.resize(gt, (384, 224)) does to train GT; None keeps the native size
    (validation). ``vinet_tpu/io/images.py::load_map`` without OpenCV."""
    gt = np.asarray(Image.open(path).convert("L"), dtype=np.float64)
    if size is not None:
        gt = _resize_linear(gt, size)
    if gt.max() > 1.0:
        gt = gt / 255.0
    return gt.astype(np.float32)


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
