"""MATLAB-compatible imresize (bicubic, antialiased) in numpy float64,
``vinet_tpu/metrics/imresize.py``.

Every MATLAB metric of the reference resizes the prediction to the GT's size
with ``imresize`` before scoring (code_for_Metrics/CC.m, NSS.m, KLdiv.m,
similarity.m, AUC_*.m, EMD.m, eval_diem.m). MATLAB's default is the Keys
cubic kernel (a = -0.5) with antialiasing on downscale: the kernel is
stretched to ``h(x) = scale * cubic(scale * x)`` so its support covers
4/scale input pixels. Output pixel x (1-based) samples input coordinate
u = x/scale + 0.5*(1 - 1/scale); weights are renormalised to sum to 1 and
border indices are clamped (replicate).

This coordinate mapping and antialiased kernel are PIL's BICUBIC resize on
float images, away from the borders (``tests/test_imresize.py``).
"""

from __future__ import annotations

import math

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    """Keys bicubic kernel, a = -0.5 (MATLAB imresize's default)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    f = (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
    f += (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2))
    return f


def _contributions(in_len: int, out_len: int, scale: float):
    """Weights and indices along one axis (imresize's ``contributions``):
    (weights (out_len, P), indices (out_len, P), 0-based and clamped)."""
    if scale < 1.0:  # antialias: stretch the kernel's support to 4/scale
        kernel = lambda x: scale * _cubic(scale * x)
        width = 4.0 / scale
    else:
        kernel = _cubic
        width = 4.0
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - width / 2.0)
    p = int(math.ceil(width)) + 2
    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]  # 1-based
    weights = kernel(u[:, None] - indices)
    weights = weights / weights.sum(axis=1, keepdims=True)
    indices = np.clip(indices, 1, in_len).astype(np.int64) - 1  # replicate the border
    keep = ~np.all(weights == 0.0, axis=0)
    return weights[:, keep], indices[:, keep]


def imresize(img, out_shape=None, scale=None) -> np.ndarray:
    """MATLAB ``imresize(img, [h w])`` or ``imresize(img, scale)`` of a 2-D
    double image, bicubic with antialiasing (the defaults). The scale form
    gives MATLAB's ceil(size * scale) output size."""
    img = np.asarray(img, dtype=np.float64)
    assert img.ndim == 2, img.shape
    if out_shape is None:
        assert scale is not None
        out_shape = (int(math.ceil(img.shape[0] * scale)),
                     int(math.ceil(img.shape[1] * scale)))
    out_h, out_w = int(out_shape[0]), int(out_shape[1])
    out = img
    if out_h != img.shape[0]:
        wts, idx = _contributions(img.shape[0], out_h, out_h / img.shape[0])
        out = np.einsum("op,opw->ow", wts, out[idx, :])
    if out_w != img.shape[1]:
        wts, idx = _contributions(img.shape[1], out_w, out_w / img.shape[1])
        out = np.einsum("op,hop->ho", wts, out[:, idx])
    return out
