"""Inference-time BatchNorm folding.

Inference-mode BatchNorm is ``nn.BatchNorm3d(eps=1e-3)`` in eval mode:
``y = (x - running_mean) * weight / sqrt(running_var + eps) + bias``, the
semantics of ``vinet_tpu/ops/norm.py::batchnorm_apply``.
"""

from __future__ import annotations

import torch

BN_EPS = 1e-3  # every BatchNorm of the visual net (reference BasicConv3d/SepConv3d)


def fold_bn_into_conv(w: torch.Tensor, b: torch.Tensor | None, bn_weight: torch.Tensor,
                      bn_bias: torch.Tensor, running_mean: torch.Tensor,
                      running_var: torch.Tensor, *, eps: float = BN_EPS):
    """Fold an inference-mode BatchNorm into the conv before it.

    w: (Cout, Cin, kT, kH, kW). Returns f32 (w', b') such that
    conv(x, w') + b' == bn(conv(x, w) + b)."""
    inv = bn_weight.float() * torch.rsqrt(running_var.float() + eps)  # (Cout,)
    w_f = w.float() * inv.view(-1, *([1] * (w.dim() - 1)))
    b0 = torch.zeros_like(running_mean, dtype=torch.float32) if b is None else b.float()
    b_f = (b0 - running_mean.float()) * inv + bn_bias.float()
    return w_f, b_f
