"""Temporal ``(kt, 1, 1)`` convolution over a T-major slab, as one K = kt*C
product per output tap: int8 -> int32, bf16 -> f32.

With ``x`` the zero-padded slab ``(T_pad, M, C)`` and ``w`` ``(kt, C, CO)``,
``out[to, m, :] = sum_k x[stride * to + k, m, :] @ w[k]`` for ``to`` in
``[0, (T_pad - kt) // stride + 1)``. Two versions:

- ``tconv_plain``: plain PyTorch, one product per tap, exact for int8 (int64
  on the CPU, float64 on a card) and f32 for bf16;
- the hand-written CUDA kernel ``csrc/tconv.cu`` for Hopper (tensor cores,
  ``csrc/gemm_core.cuh``), which replaces the TPU kernel
  ``scripts/exp_int8_mxu_r5.py:154`` ``pallas_tconv`` (``pallas_call`` at
  ``:162``, body ``_tconv_kernel`` at ``:136``).

The kernel takes ``w`` K-major, as ``(CO, kt, C)`` (``int8_mm.k_major``): a
``w`` that is a permuted view of a contiguous ``(CO, kt, C)`` tensor passes
without a copy, a contiguous ``(kt, C, CO)`` one is copied once. Its fast
variant needs ``C * element size`` to be a multiple of 16 bytes (every
``conv_t`` of the model); any other C runs a masked variant.

``tconv`` takes the plain version for CPU tensors only. For a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel has no
backward: the CUDA entry raises when autograd would record through it.
``launches`` counts the kernel's launches. Every ``SepConv3d.conv_t`` of the int8 model runs on it
(``ops/quant.py``).
"""

from __future__ import annotations

import ctypes

import torch

from vinet_tpu_torch.ops import build
from vinet_tpu_torch.ops.int8_mm import ACC, k_major

launches = 0  # kernel launches by tconv; a run may reset it to 0


def _check(x, w, stride) -> int:
    """Validate; return the number of output taps."""
    if x.dtype not in ACC or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be int8 or both bfloat16, got {x.dtype}, {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f"need x (T_pad, M, C) and w (kt, C, CO), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if stride < 1 or x.shape[0] < w.shape[0]:
        raise ValueError(f"need stride >= 1 and T_pad >= kt, got stride {stride}, "
                         f"T_pad {x.shape[0]}, kt {w.shape[0]}")
    if x.shape[1] >= 2**31 or w.shape[0] * w.shape[1] >= 2**31:
        raise ValueError(f"M and kt*C must be below 2**31, got {tuple(x.shape)}, {tuple(w.shape)}")
    return (x.shape[0] - w.shape[0]) // stride + 1


def tconv_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (T_pad, M, C), w (kt, C, CO) -> (T_out, M, CO): int8 -> int32,
    exactly; bf16 -> f32."""
    t_out = _check(x, w, stride)
    if x.dtype == torch.bfloat16:
        wide = torch.float32
    else:
        wide = torch.int64 if x.device.type == "cpu" else torch.float64
    span = stride * (t_out - 1) + 1
    out = None
    for k in range(w.shape[0]):
        part = x[k:k + span:stride].to(wide) @ w[k].to(wide)
        out = part if out is None else out.add_(part)
    return out.to(ACC[x.dtype])


def _library() -> ctypes.CDLL:
    lib = build.load("tconv")
    for fn in (lib.tconv_s8, lib.tconv_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def tconv_cuda(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on x's device, on PyTorch's current stream."""
    global launches
    build.refuse_autograd("tconv_cuda", x, w)
    if x.device.type != "cuda":
        raise ValueError(f"tconv_cuda needs CUDA tensors, got {x.device}")
    t_out = _check(x, w, stride)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _, m, c = x.shape
    kt, _, co = w.shape
    wt = k_major(w)
    out = torch.empty((t_out, m, co), dtype=ACC[x.dtype], device=x.device)
    if m == 0 or co == 0:
        return out
    lib = _library()
    fn = lib.tconv_s8 if x.dtype == torch.int8 else lib.tconv_bf16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), t_out, m, c, kt, co, stride, stream)
    if rc != 0:
        raise RuntimeError(f"tconv kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def tconv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The temporal convolution: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return tconv_plain(x, w, stride)
    return tconv_cuda(x, w, stride)
