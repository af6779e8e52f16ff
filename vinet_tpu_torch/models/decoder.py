"""Saliency decoder family: one module parameterised by a kernel plan.

``vinet_tpu/models/decoder.py`` in NCDHW, with the reference's Sequential
names (``convtsp1.0`` ... ``convtsp4.8``). Each stage is Conv3d + ReLU + 2x
upsample; skips concatenate on the TIME axis (z first, then the skip).

The tail is the JAX package's phase-folded one (``Decoder._phase_tail``):
conv4 -> ReLU, then conv5 folded with conv4's 2x upsample
(``ops/phasefold.py::conv_after_up2x``, one coarse-grid conv, so the
upsampled conv4 output is never formed; faster than upsample then conv5 on
the H100, ``PERF.md``) -> ReLU gives the coarse z5, and the head fused with
the last 2x upsample (``ops/saliency_head.py::saliency_head_up2x``: the CUDA
kernel on the card, its plain version on the CPU) maps z5 to the map, cast
to the compute dtype. Plans without conv6 take the same head with conv6 the
identity (kt 1, no bias): z5 = ReLU(conv5) >= 0 and the upsample's weights
are non-negative, so ReLU(I·up(z5)) = up(z5) and the kernel computes
sigmoid(conv7(up(z5))) exactly; their z5 has T 1.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vinet_tpu_torch.ops import saliency_head as head
from vinet_tpu_torch.ops.phasefold import FoldedConvUp2x
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
        self._fold5 = None  # (key, weights kept alive, FoldedConvUp2x) of conv5

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
        return self.tail(self.convtsp4[:2](z))  # conv4, relu

    def tail(self, z4):
        """relu(conv4) (B, 64, T, h, w) -> (B, 4h, 4w) maps in z4's dtype:
        conv5 folded with the 2x upsample before it, ReLU, then the head."""
        return self.head(torch.relu(self._conv5_folded()(z4, stride_t=self.plan.st5)))

    def _conv5_folded(self) -> FoldedConvUp2x:
        """conv5 folded with its upsample. Without autograd the fold is kept
        while conv5's tensors stay as they are (folding on every call costs
        as much as it saves, PERF.md); the kept tensors hold their storage,
        so a new tensor never takes their address and key. Inference
        tensors (made under torch.inference_mode) count no versions, so
        their fold is made anew on every call."""
        conv5 = self.convtsp4[3]
        tensors = [t for t in (conv5.weight, conv5.bias) if t is not None]
        if torch.is_grad_enabled() or any(t.is_inference() for t in tensors):
            return FoldedConvUp2x(conv5.weight, conv5.bias)
        key = [(t.data_ptr(), t._version, t.dtype, t.device) for t in tensors]
        if self._fold5 is None or self._fold5[0] != key:
            self._fold5 = (key, [t.detach() for t in tensors],
                           FoldedConvUp2x(conv5.weight, conv5.bias))
        return self._fold5[2]

    def head(self, z5):
        """relu(conv5) at the coarse grid (B, 32, T, h, w) -> (B, 2h, 2w)
        maps in z5's dtype, through the head fused with the last upsample."""
        if self.plan.conv6 is not None:
            conv6, conv7 = self.convtsp4[6], self.convtsp4[8]
            w6, b6 = conv6.weight, conv6.bias
        else:  # the identity conv6; z5's T is 1 in both plans without conv6
            conv7 = self.convtsp4[6]
            w6, b6 = torch.eye(32, device=z5.device).reshape(32, 32, 1, 1, 1), None
        out = head.saliency_head_up2x(z5.contiguous(), w6, b6, conv7.weight, conv7.bias)
        return out.to(z5.dtype)
