"""Device-side image ops: ImageNet normalisation, resize to the native frame
size, the 11-tap Gaussian blur, min-max normalisation and uint8
quantisation of the maps.

Semantics of ``vinet_tpu/ops/image.py`` and of the resize in
``vinet_tpu/inference/engine.py`` (``jax.image.resize(..., "bilinear",
antialias=False)``), on torch tensors of any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics of every reference dataset transform.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=16)
def _imagenet_stats(dtype: torch.dtype, device: torch.device) -> tuple:
    """(mean, std) on device, made once: a fresh upload from host memory
    would wait for the device's queue to drain at every call."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the channel (last) axis; x already in [0, 1]."""
    mean, std = _imagenet_stats(x.dtype, x.device)
    return (x - mean) / std


def resize_bilinear(maps: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W) -> (B, height, width): bilinear, half-pixel centres, no
    antialiasing, edge samples clamped, for up- and downscaling alike (what
    cv2.resize(INTER_LINEAR) does to the reference's predicted maps)."""
    return F.interpolate(maps[:, None], size=(height, width), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> tuple:
    """cv2.getGaussianKernel: sigma <= 0 means 0.3*((k-1)*0.5-1)+0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(r**2) / (2.0 * sigma**2))
    return tuple((k / k.sum()).astype(np.float32).tolist())


@functools.lru_cache(maxsize=16)
def _reflect101_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source index of each sample of a BORDER_REFLECT_101 padding of length
    n by pad on each side; reflects repeatedly when pad >= n. Made once per
    (n, pad, device): a fresh upload would wait for the device's queue to
    drain at every blur."""
    idx = np.pad(np.arange(n), pad, mode="reflect")
    return torch.from_numpy(idx).to(device)


def gaussian_blur(x: torch.Tensor, *, ksize: int = 11, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes, cv2.GaussianBlur(img,
    (ksize, ksize), sigma) with its BORDER_REFLECT_101 edges; also for maps
    smaller than the kernel's reach."""
    k = _gaussian_kernel_1d(ksize, sigma)
    for axis in (x.dim() - 2, x.dim() - 1):
        n = x.shape[axis]
        xp = x.index_select(axis, _reflect101_index(n, ksize // 2, x.device))
        out = torch.zeros_like(x)
        for i, ki in enumerate(k):
            out = out + ki * xp.narrow(axis, i, n)
        x = out
    return x


def minmax_normalize(x: torch.Tensor, *, axes=None, eps: float = 0.0) -> torch.Tensor:
    """Min-max normalisation to [0, 1], over the whole tensor (axes None) or
    per sample over axes (the reference's normalize_map, its loss.py:41-51):
    (x - min) / (max - min + eps)."""
    if axes is None:
        mn, mx = x.amin(), x.amax()
    else:
        mn, mx = x.amin(dim=axes, keepdim=True), x.amax(dim=axes, keepdim=True)
    return (x - mn) / (mx - mn + eps)


def to_uint8_map(x: torch.Tensor) -> torch.Tensor:
    """The reference's img_save quantisation of a map already in [0, 1]:
    round(x*255 + 0.5) clamped to [0, 255], as uint8 (its utils.py:71)."""
    return torch.clamp(torch.round(x * 255.0 + 0.5), 0, 255).to(torch.uint8)


def quantize_maps_u8(maps: torch.Tensor) -> torch.Tensor:
    """Per-map min-max normalise, then round(x*255 + 0.5) clamped to uint8
    (the reference img_save quantisation, in f32). (B, H, W) -> uint8."""
    m = maps.float()
    mn = m.amin(dim=(1, 2), keepdim=True)
    mx = m.amax(dim=(1, 2), keepdim=True)
    nrm = torch.where(mx > mn, (m - mn) / (mx - mn), torch.zeros_like(m))
    return torch.clamp(torch.round(nrm * 255.0 + 0.5), 0, 255).to(torch.uint8)
