"""SoundNet audio encoder, ``vinet_tpu/models/soundnet.py`` in NCL.

Seven conv -> BatchNorm -> ReLU [-> max pool] blocks with the reference's
names (``convN``, ``batchnormN``, ``maxpoolN``). The reference phrases them
as Conv2d with (k, 1) kernels over a (B, 1, L, 1) waveform; here every conv
is an ``nn.Conv1d`` on (B, 1, L) (``io/weights.py`` takes both weight
forms). For the 70 560-sample excerpt the lengths are 35281 -> 4410 -> 2206
-> 275 -> 138 -> 70 -> 36 -> 9 -> 5 -> 3, so the output is (B, 1024, 3).
The classifier heads ``conv8_objs`` and ``conv8_scns`` are kept as
parameters so checkpoints round-trip, but are not applied.
"""

from __future__ import annotations

import torch
from torch import nn

from vinet_tpu_torch.models.layers import batchnorm1d, fold_conv_bn

# (name, out_ch, kernel, stride, padding, maxpool after)
SOUNDNET_PLAN = (
    ("conv1", 16, 64, 2, 32, 8),
    ("conv2", 32, 32, 2, 16, 8),
    ("conv3", 64, 16, 2, 8, None),
    ("conv4", 128, 8, 2, 4, None),
    ("conv5", 256, 4, 2, 2, 4),
    ("conv6", 512, 4, 2, 2, None),
    ("conv7", 1024, 4, 2, 2, None),
)


class SoundNet(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 1
        for name, out_ch, k, s, p, pool in SOUNDNET_PLAN:
            n = name[len("conv"):]
            setattr(self, name, nn.Conv1d(in_ch, out_ch, k, s, p))
            setattr(self, f"batchnorm{n}", batchnorm1d(out_ch))
            if pool is not None:
                setattr(self, f"maxpool{n}", nn.MaxPool1d(pool, pool))
            in_ch = out_ch
        self.conv8_objs = nn.Conv1d(1024, 1000, 8, 2)
        self.conv8_scns = nn.Conv1d(1024, 401, 8, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1, L) waveform -> (B, 1024, L') features."""
        for name, *_, pool in SOUNDNET_PLAN:
            n = name[len("conv"):]
            x = torch.relu(getattr(self, f"batchnorm{n}")(getattr(self, name)(x)))
            if pool is not None:
                x = getattr(self, f"maxpool{n}")(x)
        return x

    def fold_bn(self):
        for name, *_ in SOUNDNET_PLAN:
            bn = f"batchnorm{name[len('conv'):]}"
            setattr(self, bn, fold_conv_bn(getattr(self, name), getattr(self, bn)))
