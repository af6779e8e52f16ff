"""The decoder's 2x spatial upsample (reference nn.Upsample((1,2,2), trilinear)),
alone and after the ReLU that precedes it in every decoder stage.

``upsample2x_hw`` is the upsample alone: the training graph's ``Upsample2x``
modules and the head's plain version. ``relu_up2x`` is ``relu`` then the
upsample, in two versions:

- ``relu_up2x_plain``: ``torch.relu`` then ``upsample2x_hw``;
- the hand-written CUDA kernel ``csrc/up2x.cu`` for Hopper, bf16 and f32:
  the ReLU as each input is staged, the arithmetic in f32, one rounding to
  x's dtype. It replaces no TPU kernel (the JAX package leaves the upsample
  to XLA); PyTorch's ``upsample_trilinear3d`` starts one thread per output
  (t, h, w) position, each looping over every (b, c) plane, and ran the
  decoder's upsamples at under 1 % of their byte bound.

``relu_up2x`` is the route, decided on what the call can see: a CUDA tensor
of bf16 or f32 outside autograd and outside autocast launches the kernel,
which never falls back and raises on what it does not take (the inference
paths in bf16, the eval step's f32 forward); a tensor in an autograd graph
keeps the plain version and its backward (the train step); inside an
autocast region the plain version gives the dtype and values autocast
gives; a CPU tensor, or another dtype, takes the plain version.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vinet_tpu_torch.ops import build
from vinet_tpu_torch.ops.dconv import trailing_contiguous

launches = 0  # kernel launches by relu_up2x_cuda; a run may reset it to 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def upsample2x_hw(x: torch.Tensor) -> torch.Tensor:
    """Upsample an NCDHW tensor by 2 in H and W; time untouched. Half-pixel
    centres with edge clamping, the semantics of
    ``vinet_tpu/ops/upsample.py::upsample2x_hw``."""
    return F.interpolate(x, scale_factor=(1, 2, 2), mode="trilinear", align_corners=False)


def relu_up2x_plain(x: torch.Tensor) -> torch.Tensor:
    """``upsample2x_hw(torch.relu(x))`` for x (B, C, T, H, W)."""
    return upsample2x_hw(torch.relu(x))


def _library() -> ctypes.CDLL:
    lib = build.load("up2x")
    lib.relu_up2x.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                              + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    lib.relu_up2x.restype = ctypes.c_int
    return lib


def relu_up2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on x's device, on PyTorch's current stream; x
    bf16 or f32 (B, C, T, H, W), out (B, C, T, 2H, 2W) contiguous in x's
    dtype. x's B, C and T strides are read as they are; x is copied only
    where its H and W are not contiguous."""
    global launches
    build.refuse_autograd("relu_up2x_cuda", x)
    if x.dim() != 5:
        raise ValueError(f"need x (B, C, T, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"relu_up2x_cuda needs a CUDA tensor, got {x.device}")
    b, c, t, h, w = x.shape
    if b * c * t >= 2**31 or 4 * h * w >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} is too large for the kernel's 32-bit indices")
    out = torch.empty((b, c, t, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, _ = trailing_contiguous(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().relu_up2x(x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], b, c, t, h, w,
                              x.stride(0), x.stride(1), x.stride(2), stream)
    if rc == -1:
        raise ValueError(f"no unit of x {tuple(x.shape)} fits shared memory")
    if rc != 0:
        raise RuntimeError(f"relu_up2x kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def kernel_takes(x: torch.Tensor) -> bool:
    """Whether the kernel would take x on the card: bf16 or f32, no autograd
    graph that would record through it, and autocast off for x's device."""
    return (x.dtype in _DTYPES and not (torch.is_grad_enabled() and x.requires_grad)
            and not torch.is_autocast_enabled(x.device.type))


def routes(x: torch.Tensor) -> bool:
    """Whether ``relu_up2x(x)`` takes the kernel: a CUDA tensor it takes."""
    return x.device.type == "cuda" and kernel_takes(x)


def relu_up2x(x: torch.Tensor) -> torch.Tensor:
    """``upsample2x_hw(torch.relu(x))``, through the kernel where the route
    applies (``routes``)."""
    if routes(x):
        return relu_up2x_cuda(x)
    return relu_up2x_plain(x)
