"""S3D (separable-3D Inception) encoder producing a 4-level temporal pyramid.

``vinet_tpu/models/s3d.py`` in NCDHW. For a (B, 3, 32, 224, 384) clip the
pyramid is
    y3: (B,  192, 16, 56, 96)
    y2: (B,  480, 16, 28, 48)
    y1: (B,  832,  8, 14, 24)
    y0: (B, 1024,  4,  7, 12)
"""

from __future__ import annotations

import torch
from torch import nn

from vinet_tpu_torch.models.layers import BasicConv3d, SepConv3d

# Inception channel plan: in_ch -> (b0; b1_red->b1; b2_red->b2; pool->b3).
MIXED_PLAN = {
    "3b": (192, 64, 96, 128, 16, 32, 32),
    "3c": (256, 128, 128, 192, 32, 96, 64),
    "4b": (480, 192, 96, 208, 16, 48, 64),
    "4c": (512, 160, 112, 224, 24, 64, 64),
    "4d": (512, 128, 128, 256, 24, 64, 64),
    "4e": (512, 112, 144, 288, 32, 64, 64),
    "4f": (528, 256, 160, 320, 32, 128, 128),
    "5b": (832, 256, 160, 320, 32, 128, 128),
    "5c": (832, 384, 192, 384, 48, 128, 128),
}


class InceptionBlock(nn.Module):
    """1x1 | 1x1 -> sep3 | 1x1 -> sep3 | maxpool -> 1x1, channel-concatenated."""

    def __init__(self, name: str):
        super().__init__()
        i, b0, b1r, b1, b2r, b2, b3 = MIXED_PLAN[name]
        self.branch0 = nn.Sequential(BasicConv3d(i, b0, 1))
        self.branch1 = nn.Sequential(BasicConv3d(i, b1r, 1), SepConv3d(b1r, b1, 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(i, b2r, 1), SepConv3d(b2r, b2, 3, 1, 1))
        self.branch3 = nn.Sequential(nn.MaxPool3d(3, 1, 1), BasicConv3d(i, b3, 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=1)


class S3DBackbone(nn.Module):
    """Four stages with pools between them; forward returns [y0, y1, y2, y3]
    (deepest first)."""

    def __init__(self):
        super().__init__()
        self.base1 = nn.Sequential(
            SepConv3d(3, 64, 7, 2, 3),
            nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
            BasicConv3d(64, 64, 1),
            SepConv3d(64, 192, 3, 1, 1),
        )
        self.maxp2 = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.base2 = nn.Sequential(InceptionBlock("3b"), InceptionBlock("3c"))
        self.maxp3 = nn.MaxPool3d(3, 2, 1)
        self.base3 = nn.Sequential(*(InceptionBlock(n) for n in ("4b", "4c", "4d", "4e", "4f")))
        self.maxt4 = nn.MaxPool3d((2, 1, 1), (2, 1, 1))
        self.maxp4 = nn.MaxPool3d((1, 2, 2), (1, 2, 2))
        self.base4 = nn.Sequential(InceptionBlock("5b"), InceptionBlock("5c"))

    def forward(self, x):
        """x: (B, 3, T, H, W) normalised clip -> [y0, y1, y2, y3]."""
        y3 = self.base1(x)
        y2 = self.base2(self.maxp2(y3))
        y1 = self.base3(self.maxp3(y2))
        y0 = self.base4(self.maxp4(self.maxt4(y1)))
        return [y0, y1, y2, y3]
