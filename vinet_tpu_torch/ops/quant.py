"""int8 inference quantization: per-channel weights, calibrated activations.

The scheme of ``vinet_tpu/ops/quant.py``, on ``nn.Conv3d``'s NCDHW layout:

* weights: symmetric per-output-channel int8, ``scale = max(absmax/127,
  1e-12)`` over the channel's taps, rounded half to even and clipped to +-127;
* activations: symmetric per-tensor int8 with a static scale, calibrated by
  running the f32 model on representative clips while a forward pre-hook on
  every ``nn.Conv3d`` records its input's absmax, keyed by the module's
  qualified name;
* ``QuantConv3d`` replaces a calibrated conv in place (same name): quantize
  the input, accumulate int8 products in int32, then ``acc * (w_scale *
  x_scale) + bias`` in f32, returned in the input's dtype.

Where the int32 accumulator comes from depends on the tensor's device. On
the CPU it is ``F.conv3d`` in float64 on the int8 values, exact at the
model's sizes (the largest K is 27 * 832 = 22,464, and 22,464 * 127**2 <
2**31). On a card every product goes through one of the two hand-written
kernels (``conv_acc_gemm``): ``(kt, 1, 1)`` convs through ``tconv`` on the
T-major padded slab, everything else through ``int8_mm``, a ``1x1x1`` conv
directly on the channels-last activations and any other shape on an im2col
gather (data movement only) whose K is padded with zeros to a multiple of 16. The card route runs on CPU tensors too, through
the kernels' plain versions, so the tests rehearse it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.ops.int8_mm import int8_mm
from vinet_tpu_torch.ops.tconv import tconv

QMAX = 127
SCALE_MIN = 1e-12
K_ALIGN = 16  # int8_mm copies 16-byte chunks of A's rows: its fast variant needs K % 16 == 0


@contextlib.contextmanager
def calibration(model: nn.Module):
    """Record every nn.Conv3d input's absmax while active. Yields the records,
    {qualified module name: absmax}, the largest over all calls."""
    records: dict = {}

    def hook(name):
        def pre(module, args):
            amax = float(args[0].detach().abs().max())
            records[name] = max(records.get(name, 0.0), amax)
        return pre

    handles = [m.register_forward_pre_hook(hook(name)) for name, m in model.named_modules()
               if isinstance(m, nn.Conv3d)]
    try:
        yield records
    finally:
        for h in handles:
            h.remove()


def quantize_weight(w: torch.Tensor):
    """(O, I, kt, kh, kw) weight -> (int8 weight, per-out-channel f32 scale)."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    scale = torch.clamp(absmax / float(QMAX), min=SCALE_MIN)
    wq = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return wq, scale.reshape(-1)


def activation_scale(amax: float) -> torch.Tensor:
    """A calibrated absmax -> the f32 per-tensor scale (computed in float64,
    then rounded once to f32, as the JAX package does)."""
    return torch.tensor(max(amax / float(QMAX), SCALE_MIN), dtype=torch.float32)


def quantize_activation(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """f32/bf16 activation -> int8 with the static per-tensor scale:
    round(x * (1 / x_scale)) in f32, half to even, clipped to +-127."""
    inv = torch.ones_like(x_scale, dtype=torch.float32) / x_scale.float()
    xq = torch.mul(x.float(), inv).round_().clamp_(-QMAX, QMAX)
    return xq.to(torch.int8)


def conv_acc_plain(xq, w_q, stride, padding) -> torch.Tensor:
    """int32 accumulator of an int8 conv by F.conv3d in float64: exact while
    every sum stays below 2**53 (and the int32 result below 2**31)."""
    acc = F.conv3d(xq.double(), w_q.double(), stride=stride, padding=padding)
    return acc.to(torch.int32)


def conv_acc_gemm(xq, w_q, stride, padding) -> torch.Tensor:
    """int32 accumulator of an int8 conv through the int8_mm and tconv
    kernels. xq (B, C, T, H, W) int8 in any memory format, w_q (O, C, kt, kh,
    kw) int8. Returns (B, O, To, Ho, Wo), a view of a channels-last result.
    Each weight is built K-major, the layout the kernels read, so the
    wrappers pass it on without a copy."""
    b, c, t, h, w = xq.shape
    o, _, kt, kh, kw = w_q.shape
    (st, sh, sw), (pt, ph, pw) = stride, padding
    x = xq.permute(0, 2, 3, 4, 1)  # (B, T, H, W, C): free for a channels-last xq
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        if (kt, st, pt) == (1, 1, 0):  # 1x1x1: one product over B*T*H*W rows
            acc = int8_mm(x.reshape(-1, c).contiguous(), w_q.reshape(o, c).t())
            return acc.view(b, t, h, w, o).permute(0, 4, 1, 2, 3)
        slab = x.new_zeros((t + 2 * pt, b, h, w, c))  # T-major, zero-padded in T
        slab[pt:pt + t] = x.permute(1, 0, 2, 3, 4)
        wt = w_q[:, :, :, 0, 0].permute(0, 2, 1).contiguous()  # (O, kt, C)
        acc = tconv(slab.view(t + 2 * pt, b * h * w, c), wt.permute(1, 2, 0), st)
        return acc.view(-1, b, h, w, o).permute(1, 4, 0, 2, 3)
    # im2col: K ordered (dt, dh, dw, c), the weight's (kt, kh, kw, C) order,
    # padded with zeros to a multiple of K_ALIGN
    xp = F.pad(x, (0, 0, pw, pw, ph, ph, pt, pt))
    patches = xp.unfold(1, kt, st).unfold(2, kh, sh).unfold(3, kw, sw)  # (B,To,Ho,Wo,C,kt,kh,kw)
    to, ho, wo = patches.shape[1:4]
    k = kt * kh * kw * c
    kp = -(-k // K_ALIGN) * K_ALIGN
    cols = x.new_empty((b, to, ho, wo, kp))
    cols[..., :k].unflatten(-1, (kt, kh, kw, c)).copy_(patches.permute(0, 1, 2, 3, 5, 6, 7, 4))
    cols[..., k:].zero_()
    wt = F.pad(w_q.permute(0, 2, 3, 4, 1).reshape(o, k), (0, kp - k))  # (O, Kp)
    acc = int8_mm(cols.view(-1, kp), wt.t())
    return acc.view(b, to, ho, wo, o).permute(0, 4, 1, 2, 3)


def int8_conv3d(x, w_q, w_scale, x_scale, bias, *, stride, padding) -> torch.Tensor:
    """``vinet_tpu/ops/quant.py::int8_conv3d`` in NCDHW: quantize x with the
    calibrated scale, int8 conv accumulating int32, dequantize and add the
    bias in f32, return in x's dtype (f32 for other input types)."""
    out_dtype = x.dtype if x.dtype in (torch.bfloat16, torch.float32) else torch.float32
    xq = quantize_activation(x, x_scale)
    route = conv_acc_plain if x.device.type == "cpu" else conv_acc_gemm
    acc = route(xq, w_q, tuple(stride), tuple(padding))
    y = acc.float() * (w_scale.float() * x_scale.float()).view(1, -1, 1, 1, 1)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1, 1)
    return y.to(out_dtype)


class QuantConv3d(nn.Module):
    """An int8 nn.Conv3d: buffers w_q (int8, OIDHW), w_scale (O,), x_scale
    (a 0-d tensor) and bias (O,) or None. Casting the module to bf16 rounds
    the scales and the bias, as the JAX package's final cast does."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, bias: bool):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.register_buffer("w_q", torch.zeros((out_channels, in_channels, *kernel_size),
                                                dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_channels))
        self.register_buffer("x_scale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(out_channels) if bias else None)

    @classmethod
    def like(cls, conv: nn.Conv3d) -> QuantConv3d:
        """An unquantized shell with conv's geometry, for loading a state_dict."""
        if conv.groups != 1 or conv.dilation != (1, 1, 1) or conv.padding_mode != "zeros":
            raise ValueError("only plain convs (groups 1, dilation 1, zero padding) quantize")
        return cls(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                   conv.padding, conv.bias is not None)

    @classmethod
    def from_conv(cls, conv: nn.Conv3d, amax: float) -> QuantConv3d:
        """Quantize conv's weight per output channel; x_scale from the
        calibrated input absmax."""
        q = cls.like(conv).to(conv.weight.device)
        wq, scale = quantize_weight(conv.weight)
        q.w_q.copy_(wq)
        q.w_scale.copy_(scale)
        q.x_scale.copy_(activation_scale(amax))
        if conv.bias is not None:
            q.bias.copy_(conv.bias.detach().float())
        return q

    def forward(self, x):
        return int8_conv3d(x, self.w_q, self.w_scale, self.x_scale, self.bias,
                           stride=self.stride, padding=self.padding)


def replace_module(model: nn.Module, name: str, new: nn.Module) -> None:
    """Put new in place of the submodule at the qualified name."""
    parent, _, attr = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, attr, new)


def quantize_convs(model: nn.Module, records: dict, *, skip=()) -> None:
    """Replace every nn.Conv3d with a record > 0, not named in skip, by its
    QuantConv3d, in place."""
    names = [name for name, m in model.named_modules()
             if isinstance(m, nn.Conv3d) and records.get(name, 0.0) > 0 and name not in skip]
    for name in names:
        replace_module(model, name, QuantConv3d.from_conv(model.get_submodule(name),
                                                          records[name]))
