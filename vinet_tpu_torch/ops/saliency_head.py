"""Fused saliency head: conv6 + ReLU + conv7 + sigmoid, in two input modes.

Two versions of each of two functions, f32 maps out:

- full resolution, ``(B, 32, kt, H, W)`` NCDHW -> ``(B, H, W)``:
  ``saliency_head_plain``, plain PyTorch in f32 with the semantics of
  ``vinet_tpu/ops/pallas_head.py::saliency_head_reference``, and the CUDA
  kernel behind ``saliency_head_cuda``, which replaces the TPU kernel
  ``saliency_head_pallas``;
- fused with the decoder's last 2x upsample, ``z5 (B, 32, kt, h, w)`` ->
  ``(B, 2h, 2w)``, equal to ``saliency_head(upsample2x_hw(z5), ...)``:
  ``saliency_head_up2x_plain`` (the upsample in f32, as the kernel never
  rounds the upsampled activation) and the kernel behind
  ``saliency_head_up2x_cuda``, the counterpart of the JAX package's
  phase-folded head (``vinet_tpu/models/decoder.py::Decoder._phase_tail``).
  The decoder's main path runs this one.

Both kernels are one template in ``csrc/saliency_head.cu`` for Hopper.
``saliency_head`` and ``saliency_head_up2x`` take the plain version for CPU
tensors only. For a CUDA tensor they launch the kernel or raise; they never
fall back. The kernel has no backward, like the Pallas head: the CUDA entries
raise when autograd would record through them (training runs the decoder's
plain graph, ``models/decoder.py``). ``launches`` counts every launch of the head kernel and
``launches_up2x`` those of the fused mode, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from vinet_tpu_torch.ops import build
from vinet_tpu_torch.ops.upsample import upsample2x_hw

C = 32  # conv5 / conv6 channels
MAX_KT = 8
TILE_H = 8  # rows of the kernel's tile: the grid's second dimension counts them
MAX_GRID_Y = 65535

launches = 0  # launches of the head kernel, both modes; a run may reset it to 0
launches_up2x = 0  # launches of the fused mode; a run may reset it to 0


def saliency_head_plain(z, w6, b6, w7, b7):
    """z (B, 32, kt, H, W); w6 (32, 32, kt, 1, 1) conv6 weight; b6 (32,) or
    None; w7 (1, 32, 1, 1, 1) conv7 weight; b7 (1,). Returns (B, H, W) f32."""
    h = torch.einsum("bcthw,dct->bhwd", z.float(), w6.float()[..., 0, 0])
    if b6 is not None:
        h = h + b6.float()
    h = torch.relu(h)
    y = torch.einsum("bhwd,d->bhw", h, w7.float().reshape(-1)) + b7.float().reshape(())
    return torch.sigmoid(y)


def saliency_head_up2x_plain(z5, w6, b6, w7, b7):
    """The head on upsample2x_hw(z5), the upsample in f32. z5 (B, 32, kt, h,
    w); returns (B, 2h, 2w) f32."""
    return saliency_head_plain(upsample2x_hw(z5.float()), w6, b6, w7, b7)


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
    if -(-z.shape[3] // TILE_H) > MAX_GRID_Y:
        raise ValueError(f"height {z.shape[3]} exceeds the kernel grid's {MAX_GRID_Y} tiles")
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
    for fn in (lib.saliency_head_bf16, lib.saliency_head_f32, lib.saliency_head_up2x_bf16,
               lib.saliency_head_up2x_f32):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(z, w6, b6, w7, b7, up: bool):
    """Launch one mode of the kernel on z's device, on PyTorch's current
    stream; returns the (B, H, W) or (B, 2H, 2W) f32 maps."""
    global launches, launches_up2x
    entry = "saliency_head_up2x_cuda" if up else "saliency_head_cuda"
    build.refuse_autograd(entry, z, w6, b6, w7, b7)
    kt = _check(z, w6, b6, w7, b7)
    if z.device.type != "cuda":
        raise ValueError(f"{entry} needs a CUDA tensor, got {z.device}")
    b, _, _, h, w = z.shape
    # weights as small f32 buffers; they stay alive until the kernel has run
    # because the caching allocator reuses memory in stream order
    w6f = w6.reshape(C, C, kt).float().contiguous()
    b6f = None if b6 is None else b6.float().contiguous()
    w7f = w7.reshape(C).float().contiguous()
    b7f = b7.reshape(1).float().contiguous()
    scale = 2 if up else 1
    out = torch.empty((b, scale * h, scale * w), dtype=torch.float32, device=z.device)
    lib = _library()
    name = "saliency_head_up2x_" if up else "saliency_head_"
    fn = getattr(lib, name + ("bf16" if z.dtype == torch.bfloat16 else "f32"))
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = fn(z.data_ptr(), w6f.data_ptr(), None if b6f is None else b6f.data_ptr(),
            w7f.data_ptr(), b7f.data_ptr(), out.data_ptr(), b, kt, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: cudaError {rc}")
    launches += 1
    launches_up2x += up
    return out


def saliency_head_cuda(z, w6, b6, w7, b7):
    """The full-resolution kernel on z (B, 32, kt, H, W) -> (B, H, W) f32."""
    return _launch(z, w6, b6, w7, b7, up=False)


def saliency_head_up2x_cuda(z5, w6, b6, w7, b7):
    """The fused kernel on z5 (B, 32, kt, h, w) -> (B, 2h, 2w) f32."""
    return _launch(z5, w6, b6, w7, b7, up=True)


def saliency_head(z, w6, b6, w7, b7):
    """The head at full resolution: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (B, H, W) f32."""
    if z.device.type == "cpu":
        return saliency_head_plain(z, w6, b6, w7, b7)
    return saliency_head_cuda(z, w6, b6, w7, b7)


def saliency_head_up2x(z5, w6, b6, w7, b7):
    """The decoder's head, fused with its last 2x upsample: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Returns (B, 2h, 2w)
    f32."""
    if z5.device.type == "cpu":
        return saliency_head_up2x_plain(z5, w6, b6, w7, b7)
    return saliency_head_up2x_cuda(z5, w6, b6, w7, b7)
