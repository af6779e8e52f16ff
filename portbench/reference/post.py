"""Plain reference of what the serving paths do around the model: the input
normalisation, and the map's resize to the native frame size, 11-tap
Gaussian blur and uint8 quantisation (the published ``generate_result.py``:
``cv2.resize`` INTER_LINEAR, ``cv2.GaussianBlur(map, (11, 11), 0)``, then
``img_save``'s min-max normalisation and ``round(x * 255 + 0.5)``).

This module imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def normalise(clip_u8: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (3, T, H, W) float32, ImageNet-normalised."""
    x = clip_u8.float() / 255.0
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x - mean) / std).permute(3, 0, 1, 2)


def gaussian_taps(ksize: int = 11) -> list:
    """cv2.getGaussianKernel(ksize, 0): sigma = 0.3 * ((ksize - 1) / 2 - 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    w = [math.exp(-((i - (ksize - 1) / 2) ** 2) / (2 * sigma * sigma)) for i in range(ksize)]
    return [v / sum(w) for v in w]


def post(maps: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """(B, h, w) float maps -> (B, H, W) uint8: bilinear resize with
    half-pixel centres, the separable blur with reflect-101 edges, min-max
    normalisation per map, round(x * 255 + 0.5) clamped."""
    x = F.interpolate(maps[:, None].float(), size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    k = torch.tensor(gaussian_taps(), device=x.device)
    r = k.numel() // 2
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))[:, 0]
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    x = torch.where(mx > mn, (x - mn) / (mx - mn), torch.zeros_like(x))
    return torch.clamp(torch.round(x * 255.0 + 0.5), 0, 255).to(torch.uint8)
