"""BatchNorm: inference-time folding and the running-statistics override.

Inference-mode BatchNorm is ``nn.BatchNorm3d(eps=1e-3)`` in eval mode:
``y = (x - running_mean) * weight / sqrt(running_var + eps) + bias``, the
semantics of ``vinet_tpu/ops/norm.py::batchnorm_apply``.

Training-mode BatchNorm is ``nn.BatchNorm3d(eps=1e-3, momentum=0.001)`` in
train mode, which follows ``batchnorm_train``'s conventions: it normalises
with the biased batch variance and updates the running variance with the
unbiased one, ``new = (1 - momentum) * old + momentum * batch``
(``tests/test_torch_training.py`` holds it against the JAX function).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

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


def batchnorms(module: nn.Module) -> dict:
    """{name: BatchNorm} of every BatchNorm of module, in module order."""
    return {name: m for name, m in module.named_modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)}


@contextlib.contextmanager
def override_momentum(module: nn.Module, momentum: float):
    """Set the running-statistics update fraction of every BatchNorm of
    module for the duration of the block, and restore each one's own on exit
    (``vinet_tpu/ops/norm.py::override_momentum``). momentum=1.0 makes a
    train-mode forward leave exactly this batch's mean and unbiased variance
    in the running statistics: the primitive of BN recalibration
    (``training/trainer.py::recalibrate_bn``)."""
    bns = list(batchnorms(module).values())
    saved = [bn.momentum for bn in bns]
    try:
        for bn in bns:
            bn.momentum = momentum
        yield module
    finally:
        for bn, m in zip(bns, saved):
            bn.momentum = m
