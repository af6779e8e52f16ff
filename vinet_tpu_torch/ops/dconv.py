"""The decoder's ``(kt, 3, 3)`` convolutions: spatial stride 1, spatial
padding 1 (zeros) or 0 (VALID), any temporal stride and padding, an
optional bias. Two versions:

- ``dconv_plain``: ``F.conv3d``, in x's dtype;
- the hand-written CUDA kernel ``csrc/dconv.cu`` for Hopper, bf16 only: an
  implicit GEMM on the tensor cores with f32 sums, the bias added and one
  rounding to bf16. It replaces no TPU kernel (the JAX package leaves these
  convolutions to XLA); cuDNN runs them at about 2 % of the card's peak.

The kernel reads x channels-last and the weight K-major, ``(C_out, kt, 3, 3,
C_in)``, and writes NCDHW. The wrapper copies x on every call, with the
library's tiled transpose (``channels_last``); the weight's copy is kept
(``kmajor``), so an inference weight is copied once. It needs ``C_in % 8 ==
0``, as every conv of the decoder has, and x under 2^31 elements.

``dconv`` takes the plain version for CPU tensors only. For a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel has no
backward: the CUDA entry raises when autograd would record through it.
``launches`` counts the kernel's launches.

``conv3d`` and ``conv_module`` are the decoder's route, decided on what the
call can see: a bf16 tensor outside autograd goes to ``dconv``; a float32
one, or one in an autograd graph (training), keeps ``F.conv3d``, since the
kernel has neither that type nor a backward. ``conv_module`` routes only an
``nn.Conv3d`` itself (``type(conv) is nn.Conv3d``): a module that replaces
it, such as the int8 path's ``QuantConv3d``, runs its own forward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakTensorKeyDictionary

from vinet_tpu_torch.ops import build

launches = 0  # kernel launches by dconv; a run may reset it to 0

# kmajor's copies: by the tensor that owns a weight's storage (a view's
# base), its (version, address) when they were made, and a copy per view
_kmajor = WeakTensorKeyDictionary()


def _check(x, w, bias, stride_t: int, pad_t: int, padding: int) -> tuple:
    """Validate; return the output's (T_out, H_out, W_out)."""
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[3:]) != (3, 3) or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (B, C, T, H, W) and w (C_out, C, kt, 3, 3), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got {tuple(bias.shape)}")
    if padding not in (0, 1) or stride_t < 1 or pad_t < 0:
        raise ValueError(f"need padding 0 or 1, stride_t >= 1, pad_t >= 0, got {padding}, "
                         f"{stride_t}, {pad_t}")
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    _, _, t, h, wd = x.shape
    t_out = (t + 2 * pad_t - w.shape[2]) // stride_t + 1
    h_out, w_out = h + 2 * padding - 2, wd + 2 * padding - 2
    if t_out < 1 or h_out < 1 or w_out < 1:
        raise ValueError(f"x {tuple(x.shape)} is smaller than the kernel {tuple(w.shape[2:])}")
    return t_out, h_out, w_out


def dconv_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
                stride_t: int = 1, pad_t: int = 0, padding: int = 1) -> torch.Tensor:
    """x (B, C, T, H, W), w (C_out, C, kt, 3, 3), bias (C_out,) or None ->
    (B, C_out, T_out, H_out, W_out): ``F.conv3d`` in x's dtype."""
    _check(x, w, bias, stride_t, pad_t, padding)
    return F.conv3d(x, w, bias, stride=(stride_t, 1, 1), padding=(pad_t, padding, padding))


def _library() -> ctypes.CDLL:
    lib = build.load("dconv")
    lib.dconv_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.to_channels_last_bf16.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                          + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
    for fn in (lib.dconv_bf16, lib.to_channels_last_bf16):
        fn.restype = ctypes.c_int
    return lib


def trailing_contiguous(x: torch.Tensor) -> tuple:
    """(x, P) for x (B, C, T, H, W): x itself when its last two dims are laid
    out contiguously, as in a slice along T or a timeline's gathered windows
    (T outside C), else a contiguous copy; and P = H * W."""
    _, _, _, h, w = x.shape
    if (w > 1 and x.stride(4) != 1) or (h > 1 and x.stride(3) != w):
        x = x.contiguous()
    return x, h * w


def channels_last(x: torch.Tensor, lib, stream) -> torch.Tensor:
    """x (B, C, T, H, W) bf16 on the card -> (B, T, H, W, C) contiguous, by
    the library's tiled transpose, which reads any strides of B, C and T:
    over (b, t) planes of H * W positions where T lies outside C (a
    timeline's gathered windows), else over T * H * W positions a b, which
    its 64-position tiles fill better. C % 8 == 0."""
    b, c, t, h, w = x.shape
    x, size = trailing_contiguous(x)
    out = torch.empty((b, t, h, w, c), dtype=x.dtype, device=x.device)
    planes, st = t, x.stride(2)
    if t == 1 or st == size:  # T runs on from H and W: one plane of T * H * W positions
        planes, size, st = 1, t * size, 0
    rc = lib.to_channels_last_bf16(x.data_ptr(), out.data_ptr(), b, planes, c, size, x.stride(0),
                                   x.stride(1), st, stream)
    if rc != 0:
        raise RuntimeError(f"dconv channels-last copy of {tuple(x.shape)} failed: cudaError {rc}")
    return out


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """w (C_out, C, kt, 3, 3) -> (C_out, kt, 3, 3, C) contiguous, the
    kernel's weight layout. The copy is kept while w's storage stays as it
    is: an in-place write moves the version counter its views share, a new
    ``.data`` the address, and either makes the copies anew; they go with
    the tensor that owns the storage. An inference tensor counts no
    versions, so its copy is made on every call."""
    if w.is_inference():
        return w.permute(0, 2, 3, 4, 1).contiguous()
    base = w if w._base is None else w._base
    stamp = (w._version, base.data_ptr())
    kept, views = _kmajor.get(base, (None, None))
    if kept != stamp:
        views = {}
        _kmajor[base] = (stamp, views)
    key = (w.data_ptr(), tuple(w.shape), tuple(w.stride()), w.dtype)
    if key not in views:
        views[key] = w.detach().permute(0, 2, 3, 4, 1).contiguous()
    return views[key]


def dconv_cuda(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
               stride_t: int = 1, pad_t: int = 0, padding: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on x's device, on PyTorch's current stream;
    bf16 in and out."""
    global launches
    build.refuse_autograd("dconv_cuda", x, w, bias)
    t_out, h_out, w_out = _check(x, w, bias, stride_t, pad_t, padding)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bfloat16, got {x.dtype}, {w.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"dconv_cuda needs CUDA tensors, got {x.device}")
    b, c, t, h, wd = x.shape
    if c % 8:
        raise ValueError(f"the kernel needs C_in % 8 == 0, got {c}")
    n, _, kt = w.shape[:3]
    if x.numel() >= 2**31 or b * t_out * h_out * w_out >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} is too large for the kernel's 32-bit offsets")
    out = torch.empty((b, n, t_out, h_out, w_out), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xc = channels_last(x, lib, stream)  # (B, T, H, W, C)
    wt = kmajor(w)  # (C_out, kt, 3, 3, C)
    bf = None if bias is None else bias.float().contiguous()
    rc = lib.dconv_bf16(xc.data_ptr(), wt.data_ptr(), None if bf is None else bf.data_ptr(),
                        out.data_ptr(), b, t, h, wd, c, n, kt, stride_t, pad_t, padding, stream)
    if rc != 0:
        raise RuntimeError(f"dconv kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def dconv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
          stride_t: int = 1, pad_t: int = 0, padding: int = 1) -> torch.Tensor:
    """The convolution: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return dconv_plain(x, w, bias, stride_t=stride_t, pad_t=pad_t, padding=padding)
    return dconv_cuda(x, w, bias, stride_t=stride_t, pad_t=pad_t, padding=padding)


def routes(x: torch.Tensor, *params) -> bool:
    """Whether a decoder conv of x takes ``dconv``: a bf16 x outside
    autograd (no graph would record through x or the parameters)."""
    if x.dtype != torch.bfloat16:
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in (x, *params)))


def conv3d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
           stride_t: int = 1, pad_t: int = 0, padding: int = 1) -> torch.Tensor:
    """``F.conv3d(x, w, bias, stride=(stride_t, 1, 1), padding=(pad_t,
    padding, padding))`` for a (kt, 3, 3) w, through ``dconv`` where the
    route applies (``routes``)."""
    if routes(x, w, bias):
        return dconv(x, w, bias, stride_t=stride_t, pad_t=pad_t, padding=padding)
    return F.conv3d(x, w, bias, stride=(stride_t, 1, 1), padding=(pad_t, padding, padding))


def conv_module(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """conv(x) for a decoder conv module, through ``dconv`` when the module
    is an ``nn.Conv3d`` itself with the kernel's form ((kt, 3, 3), spatial
    stride 1, spatial zero padding 0 or 1) and the route applies."""
    if (type(conv) is nn.Conv3d and tuple(conv.kernel_size[1:]) == (3, 3)
            and tuple(conv.stride[1:]) == (1, 1) and conv.padding[1] == conv.padding[2] in (0, 1)
            and conv.padding_mode == "zeros" and tuple(conv.dilation) == (1, 1, 1)
            and conv.groups == 1 and routes(x, conv.weight, conv.bias)):
        return dconv(x, conv.weight, conv.bias, stride_t=conv.stride[0], pad_t=conv.padding[0],
                     padding=conv.padding[1])
    return conv(x)
