"""The decoder's 2x spatial upsample (reference nn.Upsample((1,2,2), trilinear))."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_hw(x: torch.Tensor) -> torch.Tensor:
    """Upsample an NCDHW tensor by 2 in H and W; time untouched. Half-pixel
    centres with edge clamping, the semantics of
    ``vinet_tpu/ops/upsample.py::upsample2x_hw``."""
    return F.interpolate(x, scale_factor=(1, 2, 2), mode="trilinear", align_corners=False)
