"""Device-side input preprocessing."""

from __future__ import annotations

import torch

from vinet_tpu_torch.ops.image import normalize_imagenet


def device_preprocess(clip_u8: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> f32 / 255 -> ImageNet-normalised, on the
    tensor's own device (``vinet_tpu/data/pipeline.py::device_preprocess``)."""
    return normalize_imagenet(clip_u8.float() / 255.0)
