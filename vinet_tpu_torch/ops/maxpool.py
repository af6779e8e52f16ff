"""Max pooling over (T, H, W) without indices: ``F.max_pool3d(x, kernel,
stride, padding)`` with dilation 1 and floor-mode output sizes. Two
versions:

- ``F.max_pool3d`` itself, the plain version;
- the hand-written CUDA kernel ``csrc/maxpool3d.cu`` for Hopper, bf16 and
  f32: the same values bit for bit, with no index written. It replaces no
  TPU kernel (the JAX package leaves pooling to XLA); PyTorch's CUDA pool
  writes an int64 index beside every output whether or not anything reads
  it, and ran S3D's pools at about 13 % of the card's bandwidth.

``max_pool3d`` is the route, decided on what the call can see: a CUDA tensor
of bf16 or f32 outside autograd launches the kernel, which never falls back
and raises on what it does not take; a tensor in an autograd graph keeps
``F.max_pool3d``, whose backward needs the indices (the train step); a CPU
tensor, or another dtype, takes ``F.max_pool3d``. ``MaxPool3d`` is
``nn.MaxPool3d`` with its forward on that route (dilation 1, floor mode, no
indices; any other setting keeps the module's own forward). It has no
parameters, so state dicts are those of ``nn.MaxPool3d``.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.ops import build

launches = 0  # kernel launches by max_pool3d_cuda; a run may reset it to 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _triple(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def out_size(shape, kernel, stride, padding) -> tuple:
    """(T_out, H_out, W_out) of a pool of x (B, C, T, H, W): floor mode,
    dilation 1; raise where ``F.max_pool3d`` would."""
    if len(shape) != 5:
        raise ValueError(f"need x (B, C, T, H, W), got {tuple(shape)}")
    out = []
    for n, k, s, p in zip(shape[2:], kernel, stride, padding):
        if k < 1 or s < 1 or p < 0 or 2 * p > k:
            raise ValueError(f"need kernel >= 1, stride >= 1 and 0 <= padding <= kernel / 2, "
                             f"got {kernel}, {stride}, {padding}")
        out.append((n + 2 * p - k) // s + 1)
    if min(out) < 1:
        raise ValueError(f"x {tuple(shape)} is smaller than the window {kernel} with padding "
                         f"{padding}")
    return tuple(out)


def _library() -> ctypes.CDLL:
    lib = build.load("maxpool3d")
    lib.maxpool3d.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    lib.maxpool3d.restype = ctypes.c_int
    return lib


def max_pool3d_cuda(x: torch.Tensor, kernel, stride=None, padding=0) -> torch.Tensor:
    """Launch the CUDA kernel on x's device, on PyTorch's current stream; x
    bf16 or f32 (B, C, T, H, W), copied first if not contiguous."""
    global launches
    build.refuse_autograd("max_pool3d_cuda", x)
    k = _triple(kernel)
    s = k if stride is None else _triple(stride)
    p = _triple(padding)
    to, ho, wo = out_size(x.shape, k, s, p)
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"max_pool3d_cuda needs a CUDA tensor, got {x.device}")
    b, c, t, h, w = x.shape
    if max(t * h * w, to * ho * wo, b * c) >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} is too large for the kernel's 32-bit indices")
    x = x.contiguous()
    out = torch.empty((b, c, to, ho, wo), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().maxpool3d(x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], b * c, t, h, w,
                              to, ho, wo, *k, *s, *p, stream)
    if rc == -1:
        raise ValueError(f"no tiling of x {tuple(x.shape)} for the window {k} fits shared memory")
    if rc != 0:
        raise RuntimeError(f"maxpool3d kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def kernel_takes(x: torch.Tensor) -> bool:
    """Whether the kernel would take x on the card: bf16 or f32, and no
    autograd graph would record through it."""
    return x.dtype in _DTYPES and not (torch.is_grad_enabled() and x.requires_grad)


def routes(x: torch.Tensor) -> bool:
    """Whether a pool of x takes the kernel: a CUDA tensor it takes."""
    return x.device.type == "cuda" and kernel_takes(x)


def max_pool3d(x: torch.Tensor, kernel, stride=None, padding=0) -> torch.Tensor:
    """``F.max_pool3d(x, kernel, stride, padding)``, through the kernel where
    the route applies (``routes``)."""
    if routes(x):
        return max_pool3d_cuda(x, kernel, stride, padding)
    return F.max_pool3d(x, kernel, stride, padding)


class MaxPool3d(nn.MaxPool3d):
    """``nn.MaxPool3d`` whose forward takes ``max_pool3d``'s route when it
    has the kernel's form (dilation 1, floor mode, no indices)."""

    def forward(self, x):
        if (_triple(self.dilation) == (1, 1, 1) and not self.ceil_mode
                and not self.return_indices):
            return max_pool3d(x, self.kernel_size, self.stride, self.padding)
        return super().forward(x)
