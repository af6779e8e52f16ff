"""Plain PyTorch reference of ViNet and AViNet (bilinear fusion), the
benchmark's yardstick for ``correct``.

Written from the published architecture (Jain et al., ViNet, IROS 2021,
arXiv:2012.06170; github.com/samyak0210/ViNet ``model.py:72-112`` for ViNet,
``model.py:191-249`` for AViNet): the S3D backbone, the hierarchical decoder
with its time-axis skips and trilinear 2x upsamples, SoundNet-8 and the
bilinear fusion of the max-pooled y0 with SoundNet's three features a channel.
Every op is a stock ``torch`` op in float32 on NCDHW tensors; BatchNorm runs
on its running statistics (eval mode), eps 1e-3 in the visual net and 1e-5 in
SoundNet. Parameter names are the published checkpoints', so one state_dict
loads here and into the program alike. Departure: SoundNet's (k, 1) Conv2d
kernels are Conv1d here (the same weights without the unit axis).

``quant.on = True`` rounds every convolution's and the bilinear map's input
and weight to int8 levels (symmetric, one scale a tensor, absmax / 127)
before the float32 product, with the gradient passed straight through the
rounding: the control one precision step below the bf16 that the program
runs in.

This module imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

MIXED_PLAN = {  # in, b0, b1 reduce, b1, b2 reduce, b2, b3
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
# SoundNet-8: (out channels, kernel, stride, padding, max pool after)
SOUNDNET_PLAN = ((16, 64, 2, 32, 8), (32, 32, 2, 16, 8), (64, 16, 2, 8, None),
                 (128, 8, 2, 4, None), (256, 4, 2, 2, 4), (512, 4, 2, 2, None),
                 (1024, 4, 2, 2, None))


def int8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to 255 symmetric levels of its own absmax (a zero tensor
    stays zero)."""
    scale = t.abs().amax().clamp_min(torch.finfo(t.dtype).tiny) / 127.0
    return torch.round(t / scale).clamp(-127, 127) * scale


class Quant:
    """Holder of the control's switch, shared by every layer of one model."""

    def __init__(self):
        self.on = False

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return t
        return t + (int8_round(t.detach()) - t).detach()  # straight-through


def qconv(q: Quant, c: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """c applied to x, its input and weight passed through q."""
    fn = F.conv3d if isinstance(c, nn.Conv3d) else F.conv1d
    return fn(q(x), q(c.weight), c.bias, c.stride, c.padding)


class Basic(nn.Module):
    def __init__(self, q, i, o, k, s=1, p=0):
        super().__init__()
        self.conv = nn.Conv3d(i, o, k, s, p, bias=False)
        self.bn = nn.BatchNorm3d(o, eps=1e-3)
        self.q = q

    def forward(self, x):
        return torch.relu(self.bn(qconv(self.q, self.conv, x)))


class Sep(nn.Module):
    def __init__(self, q, i, o, k, s=1, p=0):
        super().__init__()
        self.conv_s = nn.Conv3d(i, o, (1, k, k), (1, s, s), (0, p, p), bias=False)
        self.bn_s = nn.BatchNorm3d(o, eps=1e-3)
        self.conv_t = nn.Conv3d(o, o, (k, 1, 1), (s, 1, 1), (p, 0, 0), bias=False)
        self.bn_t = nn.BatchNorm3d(o, eps=1e-3)
        self.q = q

    def forward(self, x):
        x = torch.relu(self.bn_s(qconv(self.q, self.conv_s, x)))
        return torch.relu(self.bn_t(qconv(self.q, self.conv_t, x)))


class Mixed(nn.Module):
    def __init__(self, q, name):
        super().__init__()
        i, b0, b1r, b1, b2r, b2, b3 = MIXED_PLAN[name]
        self.branch0 = nn.Sequential(Basic(q, i, b0, 1))
        self.branch1 = nn.Sequential(Basic(q, i, b1r, 1), Sep(q, b1r, b1, 3, 1, 1))
        self.branch2 = nn.Sequential(Basic(q, i, b2r, 1), Sep(q, b2r, b2, 3, 1, 1))
        self.branch3 = nn.Sequential(nn.MaxPool3d(3, 1, 1), Basic(q, i, b3, 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class Backbone(nn.Module):
    def __init__(self, q):
        super().__init__()
        self.base1 = nn.Sequential(Sep(q, 3, 64, 7, 2, 3),
                                   nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                                   Basic(q, 64, 64, 1), Sep(q, 64, 192, 3, 1, 1))
        self.maxp2 = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.base2 = nn.Sequential(Mixed(q, "3b"), Mixed(q, "3c"))
        self.maxp3 = nn.MaxPool3d(3, 2, 1)
        self.base3 = nn.Sequential(*[Mixed(q, n) for n in ("4b", "4c", "4d", "4e", "4f")])
        self.maxt4 = nn.MaxPool3d((2, 1, 1), (2, 1, 1))
        self.maxp4 = nn.MaxPool3d((1, 2, 2), (1, 2, 2))
        self.base4 = nn.Sequential(Mixed(q, "5b"), Mixed(q, "5c"))

    def forward(self, x):
        y3 = self.base1(x)
        y2 = self.base2(self.maxp2(y3))
        y1 = self.base3(self.maxp3(y2))
        y0 = self.base4(self.maxp4(self.maxt4(y1)))
        return y0, y1, y2, y3


def up2x(x):
    """nn.Upsample(scale_factor=(1, 2, 2), mode="trilinear")."""
    return F.interpolate(x, scale_factor=(1, 2, 2), mode="trilinear", align_corners=False)


class Decoder(nn.Module):
    """The clip-32, three-skip decoder (the reference's DecoderConvUp)."""

    def __init__(self, q):
        super().__init__()
        c = lambda i, o, kt, sp=True, bias=False: nn.Conv3d(  # noqa: E731
            i, o, (kt, 3, 3) if sp else (kt, 1, 1), (kt, 1, 1), (0, 1, 1) if sp else 0,
            bias=bias)
        self.convtsp1 = nn.Sequential(c(1024, 832, 1))
        self.convtsp2 = nn.Sequential(c(832, 480, 3))
        self.convtsp3 = nn.Sequential(c(480, 192, 5))
        tail = [c(192, 64, 5), nn.ReLU(), nn.Identity(), c(64, 32, 2), nn.ReLU(),
                nn.Identity(), c(32, 32, 2, sp=False), nn.ReLU(), c(32, 1, 1, sp=False, bias=True)]
        self.convtsp4 = nn.Sequential(*tail)
        self.q = q

    def conv(self, seq, i, x):
        return qconv(self.q, seq[i], x)

    def forward(self, y0, y1, y2, y3):
        z = up2x(torch.relu(self.conv(self.convtsp1, 0, y0)))
        z = up2x(torch.relu(self.conv(self.convtsp2, 0, torch.cat([z, y1], 2))))
        z = up2x(torch.relu(self.conv(self.convtsp3, 0, torch.cat([z, y2], 2))))
        t = self.convtsp4
        z = up2x(torch.relu(self.conv(t, 0, torch.cat([z, y3], 2))))
        z = up2x(torch.relu(self.conv(t, 3, z)))
        z = torch.relu(self.conv(t, 6, z))
        z = torch.sigmoid(self.conv(t, 8, z))
        return z[:, 0, 0]  # (B, 1, 1, H, W) -> (B, H, W)


class RefViNet(nn.Module):
    def __init__(self, quant: Quant | None = None):
        super().__init__()
        self.quant = quant or Quant()
        self.backbone = Backbone(self.quant)
        self.decoder = Decoder(self.quant)

    def forward(self, x):
        """x (B, 3, T, H, W) normalised -> (B, H, W) maps in [0, 1]."""
        return self.decoder(*self.backbone(x))


class SoundNet(nn.Module):
    def __init__(self, q):
        super().__init__()
        i = 1
        for n, (o, k, s, p, _) in enumerate(SOUNDNET_PLAN, start=1):
            setattr(self, f"conv{n}", nn.Conv1d(i, o, k, s, p))
            setattr(self, f"batchnorm{n}", nn.BatchNorm1d(o, eps=1e-5))
            i = o
        self.q = q
        self.conv8_objs = nn.Conv1d(1024, 1000, 8, 2)  # kept for the checkpoint, not applied
        self.conv8_scns = nn.Conv1d(1024, 401, 8, 2)

    def forward(self, x):
        """x (B, 1, L) waveform -> (B, 1024, 3) for L = 70560."""
        for n, (*_, pool) in enumerate(SOUNDNET_PLAN, start=1):
            x = qconv(self.q, getattr(self, f"conv{n}"), x)
            x = torch.relu(getattr(self, f"batchnorm{n}")(x))
            if pool:
                x = F.max_pool1d(x, pool, pool)
        return x


class Bilinear(nn.Module):
    """nn.Bilinear's weights (out, in1, in2) and bias, over a channel axis."""

    def __init__(self, q, in1, in2, out):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, in1, in2))
        self.bias = nn.Parameter(torch.empty(out))
        self.q = q

    def forward(self, x1, x2):
        return torch.einsum("bci,oij,bcj->bco", self.q(x1), self.q(self.weight),
                            self.q(x2)) + self.bias


class RefAViNet(nn.Module):
    """AViNet with bilinear fusion and no refinement encoder."""

    def __init__(self, y0_tdhw=(4, 7, 12)):
        super().__init__()
        self.quant = Quant()
        self.y0_tdhw = tuple(y0_tdhw)
        self.visual_model = RefViNet(self.quant)
        self.audionet = SoundNet(self.quant)
        t, h, w = self.y0_tdhw
        pooled = ((t - 4) // 2 + 1) * h * ((w - 1) // 2 + 1)
        self.bilinear = Bilinear(self.quant, pooled, 3, t * h * w)

    def forward(self, x, audio):
        """x (B, 3, T, H, W) normalised, audio (B, L) waveforms -> (B, H, W)."""
        y0, y1, y2, y3 = self.visual_model.backbone(x)
        return self.decode(self.fuse(y0, audio), y1, y2, y3)

    def fuse(self, y0, audio):
        b = y0.shape[0]
        a = self.audionet(audio.reshape(b, 1, -1))
        pooled = F.max_pool3d(y0, (4, 1, 1), (2, 1, 2))
        return self.bilinear(pooled.flatten(2), a).reshape(b, -1, *self.y0_tdhw)

    def decode(self, fused, y1, y2, y3):
        return self.visual_model.decoder(fused, y1, y2, y3)
