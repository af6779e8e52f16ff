"""Plain PyTorch reference of TASEDv2, the benchmark's yardstick for the
``tased`` configuration's ``correct``.

Written from the published architecture (Min & Corso, TASED-Net, ICCV 2019,
arXiv:1908.05786; as ``TASEDv2`` in github.com/samyak0210/ViNet
``model_utils.py:5-126``): the S3D encoder of ``reference/models.py``
(``Backbone``, reused as it is), whose y0 (B, 1024, T/8, H/32, W/32) the
decoder ``convtsp1`` ... ``convtsp4`` brings to the input's size:

- ``convtsp1``: a 1x1x1 conv 1024 -> 1024, BatchNorm, ReLU, then a
  ConvTranspose3d (1, 4, 4)/(1, 2, 2) padding (0, 1, 1) 1024 -> 832,
  BatchNorm, ReLU;
- ``convtsp2``, ``convtsp3``: such transposed convs 832 -> 480 -> 192, each
  with BatchNorm and ReLU;
- ``convtsp4``: one more 192 -> 64, a (2, 1, 1)/(2, 1, 1) conv 64 -> 64, a
  1x1x1 transposed conv 64 -> 4, a (2, 1, 1)/(2, 1, 1) conv 4 -> 4 (each
  with BatchNorm and ReLU; time 4 -> 2 -> 1), a last transposed conv 4 -> 4
  to the input's size, a 1x1x1 conv 4 -> 1 with bias, and a sigmoid.

Every op is a stock ``torch`` op in float32 on NCDHW tensors, the transposed
convs ``F.conv_transpose3d``; BatchNorm runs on its running statistics (eval
mode), eps 1e-3, unfolded. Parameter names are the reference's, at the top
level (``base1`` ... ``base4``, ``convtspN.i``), so the program's TASEDv2
state_dict loads here strictly. ``quant.on = True`` rounds every
convolution's input and weight, the transposed ones' too, to int8 levels as
``reference/models.py::Quant`` does: the control.

Departures from the reference repository: its ``maxp4`` asks for pooling
indices and ignores them, so plain pooling here; the decoder's (B, 1, 1,
H, W) output is returned as (B, H, W) maps, as the benchmark's other
references return theirs.

This module imports nothing of the program.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from portbench.reference.models import Backbone, Quant, qconv

EPS, MOMENTUM = 1e-3, 0.001


def _bn(c: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=EPS, momentum=MOMENTUM)


def _ct(i: int, o: int) -> list:
    return [nn.ConvTranspose3d(i, o, (1, 4, 4), (1, 2, 2), (0, 1, 1), bias=False), _bn(o),
            nn.ReLU()]


def _conv(i: int, o: int, k, s=1) -> list:
    return [nn.Conv3d(i, o, k, s, bias=False), _bn(o), nn.ReLU()]


def layer(q: Quant, m: nn.Module, x):
    """m applied to x; a conv's or a transposed conv's input and weight
    through q."""
    if isinstance(m, nn.ConvTranspose3d):
        return F.conv_transpose3d(q(x), q(m.weight), m.bias, m.stride, m.padding)
    if isinstance(m, nn.Conv3d):
        return qconv(q, m, x)
    return m(x)


class RefTASED(Backbone):
    """S3D's stages at the top level (``Backbone``) and the four decoder
    stages."""

    def __init__(self, quant: Quant | None = None):
        q = quant or Quant()
        super().__init__(q)
        self.quant = q
        self.convtsp1 = nn.Sequential(*_conv(1024, 1024, 1), *_ct(1024, 832))
        self.convtsp2 = nn.Sequential(*_ct(832, 480))
        self.convtsp3 = nn.Sequential(*_ct(480, 192))
        self.convtsp4 = nn.Sequential(
            *_ct(192, 64), *_conv(64, 64, (2, 1, 1), (2, 1, 1)),
            nn.ConvTranspose3d(64, 4, 1, 1, 0, bias=False), _bn(4), nn.ReLU(),
            *_conv(4, 4, (2, 1, 1), (2, 1, 1)),
            nn.ConvTranspose3d(4, 4, (1, 4, 4), (1, 2, 2), (0, 1, 1), bias=False),
            nn.Conv3d(4, 1, 1, 1, 0, bias=True), nn.Sigmoid())

    def stages(self) -> tuple:
        return self.convtsp1, self.convtsp2, self.convtsp3, self.convtsp4

    def forward(self, x):
        """x (B, 3, 32, H, W) normalised -> (B, H, W) maps in [0, 1]."""
        z = super().forward(x)[0]
        for stage in self.stages():
            for m in stage:
                z = layer(self.quant, m, z)
        return z[:, 0, 0]
