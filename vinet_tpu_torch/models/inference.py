"""Inference-time preparation: BatchNorm folding and the low-precision cast.

Run ``fold_batchnorms`` after the weights are loaded: loading needs the
reference names, folding removes the BatchNorms.
"""

from __future__ import annotations

import torch
from torch import nn


def fold_batchnorms(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm into its conv in place (exact at f32): each conv
    gains a bias and its BatchNorm becomes nn.Identity. Returns model."""
    for m in model.modules():
        fold = getattr(m, "fold_bn", None)
        if fold is not None:
            fold()
    return model


def cast_floating(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating-point parameters and buffers to dtype (bf16 inference)."""
    return model.to(dtype)
