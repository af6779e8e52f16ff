"""S3D's stem spatial convolution with its bias and ReLU:
``relu(F.conv3d(x, w, bias, stride=(1, 2, 2), padding=(0, 3, 3)))`` for x
(B, 3, T, H, W) and w (64, 3, 1, 7, 7). Two versions:

- ``stemconv_plain``: ``F.conv3d`` then ``relu``, in x's dtype;
- the hand-written CUDA kernel ``csrc/stemconv.cu`` for Hopper, bf16 only:
  the tensor cores with f32 sums, the bias added in f32, the ReLU and one
  rounding to bf16. It replaces no TPU kernel (the JAX package leaves this
  convolution to XLA); cuDNN has no bf16 kernel for 3 input channels and
  runs it in f32 at about 3 % of its byte bound.

``stemconv`` takes the plain version for CPU tensors only. For a CUDA tensor
it launches the kernel or raises; it never falls back. The kernel has no
backward: the CUDA entry raises when autograd would record through it.
``launches`` counts the kernel's launches.

``sep_spatial`` is the route of a ``SepConv3d``'s spatial half,
``relu(bn_s(conv_s(x)))``, decided on what the call can see (``routes``):
the stem's form (``conv_s`` an ``nn.Conv3d`` itself, kernel (1, 7, 7),
stride (1, 2, 2), padding (0, 3, 3), 3 input and 64 output channels), its
BatchNorm folded, a CUDA bf16 x and no autograd graph take the kernel. Every
other call keeps the module's expression: f32, the CPU, a train step, an
unfolded BatchNorm, the int8 path's ``QuantConv3d``, and every other
``SepConv3d`` of S3D (16 input channels or more).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.ops import build
from vinet_tpu_torch.ops.dconv import trailing_contiguous

launches = 0  # kernel launches by stemconv_cuda; a run may reset it to 0

CIN, COUT, TAPS = 3, 64, 7
STRIDE, PADDING = (1, 2, 2), (0, 3, 3)


def out_hw(h: int, w: int) -> tuple:
    """(H_out, W_out) of the stem's spatial convolution."""
    return tuple((n + 2 * p - TAPS) // s + 1 for n, s, p in zip((h, w), STRIDE[1:], PADDING[1:]))


def _check(x, w, bias) -> tuple:
    """Validate; return the output's (H_out, W_out)."""
    if x.dim() != 5 or x.shape[1] != CIN or tuple(w.shape) != (COUT, CIN, 1, TAPS, TAPS):
        raise ValueError(f"need x (B, {CIN}, T, H, W) and w ({COUT}, {CIN}, 1, {TAPS}, {TAPS}), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (COUT,):
        raise ValueError(f"bias must be ({COUT},), got {tuple(bias.shape)}")
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.shape[3] < 1 or x.shape[4] < 1:
        raise ValueError(f"x {tuple(x.shape)} has no pixels")
    return out_hw(x.shape[3], x.shape[4])


def stemconv_plain(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, 3, T, H, W), w (64, 3, 1, 7, 7), bias (64,) or None -> (B, 64,
    T, H_out, W_out): ``F.conv3d`` then ``relu``, in x's dtype."""
    _check(x, w, bias)
    return torch.relu(F.conv3d(x, w, bias, stride=STRIDE, padding=PADDING))


def _library() -> ctypes.CDLL:
    lib = build.load("stemconv")
    lib.stemconv_bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                  + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    lib.stemconv_bf16.restype = ctypes.c_int
    return lib


def stemconv_cuda(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on x's device, on PyTorch's current stream;
    bf16 in and out. x's B, C and T strides are read as they are; x is
    copied only where its H and W are not contiguous."""
    global launches
    build.refuse_autograd("stemconv_cuda", x, w, bias)
    ho, wo = _check(x, w, bias)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or (
            bias is not None and bias.dtype != torch.bfloat16):
        raise TypeError(f"x, w and bias must be bfloat16, got {x.dtype}, {w.dtype}, "
                        f"{None if bias is None else bias.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"stemconv_cuda needs CUDA tensors, got {x.device}")
    b, _, t, h, wd = x.shape
    if b * t * -(-ho // 4) * -(-wo // 64) >= 2**31:  # the kernel's tiles of 4 x 64 outputs
        raise ValueError(f"x {tuple(x.shape)} is too large for the kernel's 32-bit tile count")
    out = torch.empty((b, COUT, t, ho, wo), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    x, _ = trailing_contiguous(x)
    w = w.contiguous()
    bias = None if bias is None else bias.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().stemconv_bf16(x.data_ptr(), w.data_ptr(),
                                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                                  b, t, h, wd, ho, wo, x.stride(0), x.stride(1), x.stride(2),
                                  stream)
    if rc != 0:
        raise RuntimeError(f"stemconv kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def stemconv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """The convolution with its bias and ReLU: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return stemconv_plain(x, w, bias)
    return stemconv_cuda(x, w, bias)


def stem_form(sep: nn.Module) -> bool:
    """Whether SepConv3d ``sep``'s spatial half is the kernel's function:
    ``conv_s`` an ``nn.Conv3d`` itself with the stem's kernel, stride,
    padding and channels, and ``bn_s`` folded into it."""
    conv = sep.conv_s
    return (type(conv) is nn.Conv3d and isinstance(sep.bn_s, nn.Identity)
            and conv.in_channels == CIN and conv.out_channels == COUT
            and tuple(conv.kernel_size) == (1, TAPS, TAPS) and tuple(conv.stride) == STRIDE
            and tuple(conv.padding) == PADDING and tuple(conv.dilation) == (1, 1, 1)
            and conv.groups == 1 and conv.padding_mode == "zeros")


def kernel_takes(sep: nn.Module, x: torch.Tensor) -> bool:
    """Whether the kernel would take the spatial half of ``sep`` on x on the
    card: the stem's form, x and the parameters bf16, and no autograd graph
    that would record through them."""
    if not stem_form(sep):
        return False
    params = (x, sep.conv_s.weight, sep.conv_s.bias)
    return (all(p is None or p.dtype == torch.bfloat16 for p in params)
            and not (torch.is_grad_enabled()
                     and any(p is not None and p.requires_grad for p in params)))


def routes(sep: nn.Module, x: torch.Tensor) -> bool:
    """Whether the spatial half of ``sep`` on x takes the kernel: a CUDA x
    it takes."""
    return x.device.type == "cuda" and kernel_takes(sep, x)


def sep_spatial(sep: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``relu(sep.bn_s(sep.conv_s(x)))``, the spatial half of a SepConv3d,
    through the kernel where ``routes(sep, x)``."""
    if routes(sep, x):
        return stemconv(x, sep.conv_s.weight, sep.conv_s.bias)
    return torch.relu(sep.bn_s(sep.conv_s(x)))
