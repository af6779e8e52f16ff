"""Saliency decoder family: one module parameterised by a kernel plan.

``vinet_tpu/models/decoder.py`` in NCDHW, with the reference's Sequential
names (``convtsp1.0`` ... ``convtsp4.8``). Each stage is Conv3d + ReLU + 2x
upsample; skips concatenate on the TIME axis (z first, then the skip).

The tail runs conv4 -> ReLU -> upsample -> conv5 -> ReLU; then, for plans
with conv6, the head fused with the last 2x upsample
(``ops/saliency_head.py::saliency_head_up2x``: the CUDA kernel on the card,
its plain version on the CPU) on that coarse z5, cast to the compute dtype,
so the upsampled z5 is never formed, as in the JAX package's phase-folded
tail; for plans without conv6, upsample -> conv7 -> sigmoid.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vinet_tpu_torch.ops import saliency_head as head
from vinet_tpu_torch.ops.upsample import upsample2x_hw


@dataclasses.dataclass(frozen=True)
class DecoderPlan:
    """Temporal kernel plan. (kt_i, st_i) are the time kernel/stride of stage
    i; the spatial part is k3/s1/p1 for stages 1-5. conv6 is the optional
    temporal-collapse conv (32ch, (kt,1,1)); conv7 is the 1x1x1 head."""

    skips: tuple  # subset of (1, 2, 3): which pyramid levels concat on time
    kt2: int
    st2: int
    kt3: int
    st3: int
    kt4: int
    st4: int
    kt5: int
    st5: int
    conv6: tuple | None  # (kt, st, use_bias) or None


# Plans keyed by (num_hier, clip_size), one per reference decoder class.
DECODER_PLANS = {
    (3, 32): DecoderPlan((1, 2, 3), 3, 3, 5, 5, 5, 5, 2, 2, (2, 2, False)),  # DecoderConvUp
    (3, 16): DecoderPlan((1, 2, 3), 3, 3, 5, 5, 5, 5, 2, 2, None),  # DecoderConvUp16
    (3, 8): DecoderPlan((1, 2, 3), 3, 3, 5, 5, 5, 5, 1, 1, None),  # DecoderConvUp8
    (3, 48): DecoderPlan((1, 2, 3), 3, 3, 5, 5, 5, 5, 2, 2, (3, 3, True)),  # DecoderConvUp48
    (0, 32): DecoderPlan((), 1, 1, 1, 1, 1, 1, 2, 2, (2, 2, False)),  # DecoderConvUpNoHier
    (1, 32): DecoderPlan((1,), 3, 3, 1, 1, 1, 1, 2, 2, (2, 2, False)),  # DecoderConvUp1Hier
    (2, 32): DecoderPlan((1, 2), 3, 3, 5, 5, 1, 1, 2, 2, (2, 2, False)),  # DecoderConvUp2Hier
}


def decoder_plan(num_hier: int = 3, clip_size: int = 32) -> DecoderPlan:
    key = (num_hier, clip_size) if num_hier == 3 else (num_hier, 32)
    if key not in DECODER_PLANS:
        raise ValueError(f"no decoder plan for num_hier={num_hier}, clip_size={clip_size}")
    return DECODER_PLANS[key]


class Upsample2x(nn.Module):
    def forward(self, x):
        return upsample2x_hw(x)


def _conv(i, o, kt, st, *, spatial=True, bias=False):
    if spatial:
        return nn.Conv3d(i, o, (kt, 3, 3), (st, 1, 1), (0, 1, 1), bias=bias)
    return nn.Conv3d(i, o, (kt, 1, 1), (st, 1, 1), 0, bias=bias)


class Decoder(nn.Module):
    def __init__(self, plan: DecoderPlan):
        super().__init__()
        p = self.plan = plan
        self.convtsp1 = nn.Sequential(_conv(1024, 832, 1, 1), nn.ReLU(), Upsample2x())
        self.convtsp2 = nn.Sequential(_conv(832, 480, p.kt2, p.st2), nn.ReLU(), Upsample2x())
        self.convtsp3 = nn.Sequential(_conv(480, 192, p.kt3, p.st3), nn.ReLU(), Upsample2x())
        tail = [_conv(192, 64, p.kt4, p.st4), nn.ReLU(), Upsample2x(),
                _conv(64, 32, p.kt5, p.st5), nn.ReLU(), Upsample2x()]
        if p.conv6 is not None:
            kt, st, use_bias = p.conv6
            tail += [_conv(32, 32, kt, st, spatial=False, bias=use_bias), nn.ReLU()]
        tail += [_conv(32, 1, 1, 1, spatial=False, bias=True), nn.Sigmoid()]
        self.convtsp4 = nn.Sequential(*tail)

    def forward(self, pyramid):
        """pyramid: [y0, y1, y2, y3] NCDHW. Returns (B, H, W) in [0, 1]."""
        y0, y1, y2, y3 = pyramid
        skips = self.plan.skips
        z = self.convtsp1(y0)
        if 1 in skips:
            z = torch.cat([z, y1.to(z.dtype)], dim=2)
        z = self.convtsp2(z)
        if 2 in skips:
            z = torch.cat([z, y2.to(z.dtype)], dim=2)
        z = self.convtsp3(z)
        if 3 in skips:
            z = torch.cat([z, y3.to(z.dtype)], dim=2)
        z = self.convtsp4[:5](z)  # conv4, relu, up, conv5, relu
        if self.plan.conv6 is not None:
            conv6, conv7 = self.convtsp4[6], self.convtsp4[8]
            out = head.saliency_head_up2x(z.contiguous(), conv6.weight, conv6.bias,
                                          conv7.weight, conv7.bias)
            return out.to(z.dtype)
        z = self.convtsp4[5:](z)  # up, conv7, sigmoid
        return z[:, 0, 0]
