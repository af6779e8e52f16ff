"""Matrix product ``a @ b`` with a wide accumulator: int8 -> int32, bf16 -> f32.

Two versions of one function, ``(M, K) @ (K, N) -> (M, N)``:

- ``int8_mm_plain``: plain PyTorch, exact for int8 (int64 on the CPU; float64
  on a card, which has no integer GEMM and is exact while K * 127**2 < 2**53)
  and f32 for bf16;
- the hand-written CUDA kernel ``csrc/int8_mm.cu`` for Hopper (tensor cores,
  ``csrc/gemm_core.cuh``), which replaces the TPU kernel
  ``scripts/exp_int8_mxu_r5.py:64`` ``pallas_mm`` (``pallas_call`` at ``:68``,
  body ``_mm_kernel`` at ``:58``).

The kernel takes ``b`` K-major, as ``(N, K)`` row-major (``k_major``): a ``b``
that is the transposed view of a contiguous ``(N, K)`` tensor passes without a
copy, a contiguous ``(K, N)`` one is copied once. Its fast variant needs
``K * element size`` to be a multiple of 16 bytes; any other K runs a masked
variant of the same kernel.

``int8_mm`` takes the plain version for CPU tensors only. For a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel has no
backward: the CUDA entry raises when autograd would record through it.
``launches`` counts the kernel's launches, so a run can show that its main
path went through it.
The int8 convolutions of ``ops/quant.py`` are products of this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from vinet_tpu_torch.ops import build

ACC = {torch.int8: torch.int32, torch.bfloat16: torch.float32}

launches = 0  # kernel launches by int8_mm; a run may reset it to 0


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N): int8 -> int32, exactly; bf16 -> f32."""
    _check(a, b)
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float()
    wide = torch.int64 if a.device.type == "cpu" else torch.float64
    return (a.to(wide) @ b.to(wide)).to(torch.int32)


def _check(a, b) -> None:
    if a.dtype not in ACC or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be int8 or both bfloat16, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a (M, K) and b (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if max(a.shape[0], a.shape[1], b.shape[1]) >= 2**31:
        raise ValueError(f"dimensions must be below 2**31, got {tuple(a.shape)}, {tuple(b.shape)}")


def k_major(b: torch.Tensor) -> torch.Tensor:
    """The kernels' B operand: b with its last dimension (N) moved to the
    front, contiguous, so that each column's K values are contiguous ((K, N)
    -> (N, K); tconv's (kt, C, CO) -> (CO, kt, C)). A view of such a tensor
    is returned as it is; any other b is copied once."""
    bt = b.permute(b.dim() - 1, *range(b.dim() - 1))
    return bt if bt.is_contiguous() else bt.contiguous()


def k_major_view(b: torch.Tensor) -> torch.Tensor:
    """b's values as a view of a contiguous K-major tensor, the form in which
    the model passes B: ``k_major`` of it is that tensor, not a copy."""
    return k_major(b).permute(*range(1, b.dim()), 0)


def _library() -> ctypes.CDLL:
    lib = build.load("int8_mm")
    for fn in (lib.int8_mm_s8, lib.int8_mm_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def int8_mm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a's device, on PyTorch's current stream."""
    global launches
    build.refuse_autograd("int8_mm_cuda", a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_mm_cuda needs CUDA tensors, got {a.device}")
    _check(a, b)
    if not a.is_contiguous():
        raise ValueError("a must be contiguous row-major")
    (m, k), n = a.shape, b.shape[1]
    bt = k_major(b)
    out = torch.empty((m, n), dtype=ACC[a.dtype], device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    fn = lib.int8_mm_s8 if a.dtype == torch.int8 else lib.int8_mm_bf16
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"int8_mm kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. int8 -> int32, bf16 -> f32."""
    if a.device.type == "cpu":
        return int8_mm_plain(a, b)
    return int8_mm_cuda(a, b)
