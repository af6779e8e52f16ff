"""Building blocks with the reference's attribute names.

``BasicConv3d`` (conv -> bn -> relu) and ``SepConv3d`` (spatial conv_s ->
bn_s -> relu, temporal conv_t -> bn_t -> relu), BatchNorm at eps 1e-3 and
momentum 0.001, as in ``vinet_tpu/models/layers.py::basic_conv3d`` and
``sep_conv3d``. ``fold_bn`` absorbs each BatchNorm into its conv for
inference: the conv gains a bias and the BatchNorm becomes ``nn.Identity``.

SoundNet's 1-D layers (``vinet_tpu/models/layers.py:79-95``) are
``nn.Conv1d`` and ``nn.MaxPool1d`` (floor mode) on NCL, and ``batchnorm1d``,
BatchNorm at torch's defaults eps 1e-5 and momentum 0.1 (the reference's
SoundNet BatchNorm); ``fold_conv_bn`` folds any conv with its BatchNorm, at
the BatchNorm's own eps.
"""

from __future__ import annotations

import torch
from torch import nn

from vinet_tpu_torch.ops import stemconv
from vinet_tpu_torch.ops.norm import BN_EPS, fold_bn_into_conv

BN_MOMENTUM = 0.001
SOUND_BN_EPS, SOUND_BN_MOMENTUM = 1e-5, 0.1  # torch's defaults, SoundNet's


def _bn(ch: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def fold_conv_bn(conv: nn.Module, bn: nn.Module) -> nn.Module:
    """Fold bn into conv (3-D or 1-D) in place, at bn's own eps; return the
    module that replaces bn."""
    if isinstance(bn, nn.Identity):
        return bn
    w, b = fold_bn_into_conv(conv.weight, conv.bias, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var, eps=bn.eps)
    with torch.no_grad():
        conv.weight.copy_(w)
    conv.bias = nn.Parameter(b.to(conv.weight.dtype))
    return nn.Identity()


class BasicConv3d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel, stride, padding, bias=False)
        self.bn = _bn(out_ch)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))

    def fold_bn(self):
        self.bn = fold_conv_bn(self.conv, self.bn)


class SepConv3d(nn.Module):
    """Factorised 3-D conv: (1,k,k) spatial then (k,1,1) temporal. The
    spatial half takes ``ops/stemconv.py::sep_spatial``'s route (the stem's
    kernel on the card once its BatchNorm is folded)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv_s = nn.Conv3d(in_ch, out_ch, (1, kernel, kernel), (1, stride, stride),
                                (0, padding, padding), bias=False)
        self.bn_s = _bn(out_ch)
        self.conv_t = nn.Conv3d(out_ch, out_ch, (kernel, 1, 1), (stride, 1, 1),
                                (padding, 0, 0), bias=False)
        self.bn_t = _bn(out_ch)

    def forward(self, x):
        x = stemconv.sep_spatial(self, x)
        return torch.relu(self.bn_t(self.conv_t(x)))

    def fold_bn(self):
        self.bn_s = fold_conv_bn(self.conv_s, self.bn_s)
        self.bn_t = fold_conv_bn(self.conv_t, self.bn_t)


def batchnorm1d(ch: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(ch, eps=SOUND_BN_EPS, momentum=SOUND_BN_MOMENTUM)
