"""Fused saliency head: conv6 + ReLU + conv7 + sigmoid at full map resolution.

Two versions of one function, ``(B, 32, kt, H, W)`` NCDHW -> ``(B, H, W)`` f32:

- ``saliency_head_plain``: plain PyTorch in f32, the semantics of
  ``vinet_tpu/ops/pallas_head.py::saliency_head_reference``;
- the hand-written CUDA kernel ``csrc/saliency_head.cu`` for Hopper, which
  replaces the TPU kernel ``saliency_head_pallas``.

``saliency_head`` takes the plain version for CPU tensors only. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``launches``
counts the kernel's launches, so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from vinet_tpu_torch.ops import build

C = 32  # conv5 / conv6 channels
MAX_KT = 8

launches = 0  # kernel launches by saliency_head; a run may reset it to 0


def saliency_head_plain(z, w6, b6, w7, b7):
    """z (B, 32, kt, H, W); w6 (32, 32, kt, 1, 1) conv6 weight; b6 (32,) or
    None; w7 (1, 32, 1, 1, 1) conv7 weight; b7 (1,). Returns (B, H, W) f32."""
    h = torch.einsum("bcthw,dct->bhwd", z.float(), w6.float()[..., 0, 0])
    if b6 is not None:
        h = h + b6.float()
    h = torch.relu(h)
    y = torch.einsum("bhwd,d->bhw", h, w7.float().reshape(-1)) + b7.float().reshape(())
    return torch.sigmoid(y)


def _check(z, w6, b6, w7, b7) -> int:
    if z.dim() != 5 or z.shape[1] != C:
        raise ValueError(f"z must be (B, {C}, kt, H, W), got {tuple(z.shape)}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"z must be bfloat16 or float32, got {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous NCDHW")
    kt = z.shape[2]
    if not 1 <= kt <= MAX_KT:
        raise ValueError(f"kt must be in [1, {MAX_KT}], got {kt}")
    if z.shape[0] > 65535:
        raise ValueError(f"batch {z.shape[0]} exceeds the kernel grid's 65535")
    if tuple(w6.shape) != (C, C, kt, 1, 1):
        raise ValueError(f"w6 must be ({C}, {C}, {kt}, 1, 1), got {tuple(w6.shape)}")
    if b6 is not None and tuple(b6.shape) != (C,):
        raise ValueError(f"b6 must be ({C},), got {tuple(b6.shape)}")
    if w7.numel() != C or b7.numel() != 1:
        raise ValueError(f"w7 must hold {C} values and b7 one, got {tuple(w7.shape)}, "
                         f"{tuple(b7.shape)}")
    for name, t in (("w6", w6), ("b6", b6), ("w7", w7), ("b7", b7)):
        if t is not None and t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
    return kt


def _library() -> ctypes.CDLL:
    lib = build.load("saliency_head")
    for fn in (lib.saliency_head_bf16, lib.saliency_head_f32):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def saliency_head_cuda(z, w6, b6, w7, b7):
    """Launch the CUDA kernel on z's device, on PyTorch's current stream."""
    global launches
    if z.device.type != "cuda":
        raise ValueError(f"saliency_head_cuda needs a CUDA tensor, got {z.device}")
    kt = _check(z, w6, b6, w7, b7)
    b, _, _, h, w = z.shape
    # weights as small f32 buffers; they stay alive until the kernel has run
    # because the caching allocator reuses memory in stream order
    w6f = w6.reshape(C, C, kt).float().contiguous()
    b6f = None if b6 is None else b6.float().contiguous()
    w7f = w7.reshape(C).float().contiguous()
    b7f = b7.reshape(1).float().contiguous()
    out = torch.empty((b, h, w), dtype=torch.float32, device=z.device)
    lib = _library()
    fn = lib.saliency_head_bf16 if z.dtype == torch.bfloat16 else lib.saliency_head_f32
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = fn(z.data_ptr(), w6f.data_ptr(), None if b6f is None else b6f.data_ptr(),
            w7f.data_ptr(), b7f.data_ptr(), out.data_ptr(), b, kt, h * w, stream)
    if rc != 0:
        raise RuntimeError(f"saliency_head kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def saliency_head(z, w6, b6, w7, b7):
    """The decoder's head: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (B, H, W) f32."""
    if z.device.type == "cpu":
        return saliency_head_plain(z, w6, b6, w7, b7)
    return saliency_head_cuda(z, w6, b6, w7, b7)
