"""S3D (separable-3D Inception) encoder producing a 4-level temporal pyramid.

``vinet_tpu/models/s3d.py`` in NCDHW. For a (B, 3, 32, 224, 384) clip the
pyramid is
    y3: (B,  192, 16, 56, 96)
    y2: (B,  480, 16, 28, 48)
    y1: (B,  832,  8, 14, 24)
    y0: (B, 1024,  4,  7, 12)

Every pool is ``ops/maxpool.py::MaxPool3d``: the index-free kernel on the
card outside autograd, ``F.max_pool3d`` otherwise. ``run_in_time`` runs the
backbone's modules with time stride 1, in the streaming and live paths' time
forms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.models.layers import BasicConv3d, SepConv3d
from vinet_tpu_torch.ops import maxpool, stemconv
from vinet_tpu_torch.ops.maxpool import MaxPool3d

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
        self.branch3 = nn.Sequential(MaxPool3d(3, 1, 1), BasicConv3d(i, b3, 1))

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
            MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
            BasicConv3d(64, 64, 1),
            SepConv3d(64, 192, 3, 1, 1),
        )
        self.maxp2 = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.base2 = nn.Sequential(InceptionBlock("3b"), InceptionBlock("3c"))
        self.maxp3 = MaxPool3d(3, 2, 1)
        self.base3 = nn.Sequential(*(InceptionBlock(n) for n in ("4b", "4c", "4d", "4e", "4f")))
        self.maxt4 = MaxPool3d((2, 1, 1), (2, 1, 1))
        self.maxp4 = MaxPool3d((1, 2, 2), (1, 2, 2))
        self.base4 = nn.Sequential(InceptionBlock("5b"), InceptionBlock("5c"))

    def forward(self, x):
        """x: (B, 3, T, H, W) normalised clip -> [y0, y1, y2, y3]."""
        y3 = self.base1(x)
        y2 = self.base2(self.maxp2(y3))
        y1 = self.base3(self.maxp3(y2))
        y0 = self.base4(self.maxp4(self.maxt4(y1)))
        return [y0, y1, y2, y3]


def run_in_time(mod: nn.Module, x: torch.Tensor, form: str):
    """Apply a backbone module with every time stride 1, in one of two time
    forms: ``"dense"`` keeps the module's own time padding (the streaming
    timelines), ``"valid"`` drops it (the live segments), so the output
    loses the module's time radius at each end. Returns (y, radius), the
    radius in input positions. The leaves take the routes of the modules'
    forwards (``stemconv.sep_spatial``, ``maxpool.max_pool3d``)."""
    if form not in ("dense", "valid"):
        raise ValueError(f"form must be 'dense' or 'valid', got {form!r}")
    dense = form == "dense"
    if isinstance(mod, SepConv3d):
        conv = mod.conv_t
        y = F.conv3d(stemconv.sep_spatial(mod, x), conv.weight, conv.bias, stride=(1, 1, 1),
                     padding=(conv.padding[0] if dense else 0, 0, 0))
        return torch.relu(mod.bn_t(y)), conv.padding[0]
    if isinstance(mod, nn.MaxPool3d):
        k, s, p = (v if isinstance(v, tuple) else (v,) * 3
                   for v in (mod.kernel_size, mod.stride, mod.padding))
        if not (k[0] == 1 or p[0] or k[0] == 2):
            raise ValueError(f"no valid time form for a max pool {k} with padding {p}")
        return maxpool.max_pool3d(x, k, (1, *s[1:]), (p[0] if dense else 0, *p[1:])), p[0]
    if isinstance(mod, (BasicConv3d, nn.Conv3d)):  # no time extent: the forms change nothing
        conv = mod.conv if isinstance(mod, BasicConv3d) else mod
        if (conv.kernel_size[0], conv.stride[0], conv.padding[0]) != (1, 1, 0):
            raise ValueError(f"no time form for a conv with time kernel, stride and padding "
                             f"{(conv.kernel_size[0], conv.stride[0], conv.padding[0])}")
        return mod(x), 0
    if isinstance(mod, nn.Sequential):
        r = 0
        for layer in mod:
            x, ri = run_in_time(layer, x, form)
            r += ri
        return x, r
    if isinstance(mod, InceptionBlock):
        outs = [run_in_time(b, x, form) for b in (mod.branch0, mod.branch1, mod.branch2,
                                                  mod.branch3)]
        rmax = max(r for _, r in outs)
        cut = [0 if dense else rmax - r for _, r in outs]  # to the widest radius
        return torch.cat([y[:, :, c: y.shape[2] - c] for (y, _), c in zip(outs, cut)],
                         dim=1), rmax
    raise TypeError(f"run_in_time: unhandled module {type(mod).__name__}")
