"""BatchNorm: inference-time folding and the running-statistics override.

Inference-mode BatchNorm is ``nn.BatchNorm3d(eps=1e-3)`` in eval mode:
``y = (x - running_mean) * weight / sqrt(running_var + eps) + bias``, the
semantics of ``vinet_tpu/ops/norm.py::batchnorm_apply``.

Training-mode BatchNorm is ``nn.BatchNorm3d(eps=1e-3, momentum=0.001)`` in
train mode, which follows ``batchnorm_train``'s conventions: it normalises
with the biased batch variance and updates the running variance with the
unbiased one, ``new = (1 - momentum) * old + momentum * batch``
(``tests/test_torch_training.py`` holds it against the JAX function).

Under data parallelism JAX shards the batch and leaves ``batchnorm_train``
as it is, so its statistics are those of the global batch.
``SyncBatchNorm`` takes them so over a process group: the per-channel sum
and count, then the centred sum of squares about the global mean (the
two-pass precision of one process), each all-reduced
(``parallel/collectives.py``), through which the backward flows; the running
statistics use the global count. ``sync_batchnorms`` swaps it in for every
BatchNorm of a model. It runs the same code on gloo and NCCL, which
``nn.SyncBatchNorm`` does not (it refuses CPU tensors).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from vinet_tpu_torch.parallel.collectives import all_reduce

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


class SyncBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm whose training-mode statistics are those of the global batch
    of a process group (the module docstring); eval mode uses the running
    statistics, as any BatchNorm. Input (N, C, ...), any rank >= 2."""

    def __init__(self, num_features: int, eps: float, momentum: float | None, group):
        super().__init__(num_features, eps, momentum)
        self.group = group

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected (N, C, ...) input, got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        acc = torch.promote_types(x.dtype, torch.float32)
        dims = [0, *range(2, x.dim())]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(acc)
        count = torch.tensor([x.numel() // x.shape[1]], dtype=torch.float64, device=x.device)
        sums = all_reduce(torch.cat([xf.sum(dims).double(), count]), self.group)
        n = sums[-1]
        mean = (sums[:-1] / n).to(acc)
        xc = xf - mean.view(shape)
        var = (all_reduce(xc.square().sum(dims).double(), self.group) / n).to(acc)
        y = xc * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.to(acc).view(shape) + self.bias.to(acc).view(shape)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = 1.0 / float(self.num_batches_tracked) if self.momentum is None else self.momentum
            total = float(n)
            unbiased = var * (total / max(total - 1.0, 1.0))
            self.running_mean.mul_(1.0 - m).add_(m * mean.to(self.running_mean.dtype))
            self.running_var.mul_(1.0 - m).add_(m * unbiased.to(self.running_var.dtype))
        return y.to(x.dtype)


def sync_batchnorms(model: nn.Module, group) -> nn.Module:
    """Replace every BatchNorm of model in place with a ``SyncBatchNorm``
    over group that holds the same parameters and statistics (the same
    tensors, under the same names); returns model. group None (one data
    rank) leaves model as it is."""
    if group is None:
        return model
    for name, bn in batchnorms(model).items():
        if isinstance(bn, SyncBatchNorm):
            continue
        new = SyncBatchNorm(bn.num_features, bn.eps, bn.momentum, group)
        new.weight, new.bias = bn.weight, bn.bias
        new.running_mean, new.running_var = bn.running_mean, bn.running_var
        new.num_batches_tracked = bn.num_batches_tracked
        new.train(bn.training)
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent), leaf, new)
    return model
