"""AViNet: audio-visual saliency with bilinear fusion and an optional
self-attention refinement, ``vinet_tpu/models/avinet.py::AViNet`` in NCDHW
(the reference's VideoAudioSaliencyModel).

The fusion block (``AViNet.fuse``): y0 (B, 1024, T0, H0, W0) is max-pooled
with kernel (4, 1, 1) and stride (2, 1, 2) into P visual features a channel
(42 for 32 x 224 x 384 clips), SoundNet gives 3 audio features a channel,
and ``Bilinear`` (``nn.Bilinear``-shaped weights (T0·H0·W0, P, 3)) maps each
channel's pair to T0·H0·W0 = 336 values, laid back out as y0's geometry in
torch's flatten order. ``use_transformer`` adds conv_in_1x1 (1024 -> C),
the encoder over the C channels as tokens of size 336, and conv_out_1x1.
The visual decoder then runs on [fused, y1, y2, y3] and ends in the head.

The constructor does no file IO (the reference loads soundnet8_final.pth in
its __init__); weights load through ``io/weights.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vinet_tpu_torch.models.soundnet import SoundNet
from vinet_tpu_torch.models.transformer import TransformerEncoder
from vinet_tpu_torch.models.vinet import ViNet

AUDIO_FEATURES = 3  # SoundNet's output length for a 70 560-sample excerpt


def y0_geometry(clip_size: int, input_hw: tuple) -> tuple:
    """y0's (T, H, W): T/8, H/32, W/32; (4, 7, 12) for 32 x 224 x 384."""
    return (clip_size // 8, input_hw[0] // 32, input_hw[1] // 32)


def pooled_len(t_: int, h_: int, w_: int) -> int:
    """Features a channel after MaxPool3d((4, 1, 1), stride (2, 1, 2))."""
    return ((t_ - 4) // 2 + 1) * h_ * ((w_ - 1) // 2 + 1)


class Bilinear(nn.Module):
    """torch's nn.Bilinear over a channel axis: out[b, c, o] = sum_ij
    W[o, i, j] x1[b, c, i] x2[b, c, j] + bias[o], accumulated in f32 with the
    f32 bias added before the cast to x1's dtype (``avinet.py:59-62``)."""

    def __init__(self, in1: int, in2: int, out: int):
        super().__init__()
        bound = 1.0 / math.sqrt(in1)
        self.weight = nn.Parameter(torch.empty(out, in1, in2).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out).uniform_(-bound, bound))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """x1 (B, C, I), x2 (B, C, J) -> (B, C, O): one GEMM over the outer
        products, (B·C, I·J) x (I·J, O), in f32."""
        outer = (x1.float()[..., :, None] * x2.float()[..., None, :]).flatten(2)
        w = self.weight.float().flatten(1)  # (O, I·J)
        return (torch.matmul(outer, w.t()) + self.bias.float()).to(x1.dtype)


class AViNet(nn.Module):
    def __init__(self, use_transformer: bool = False, transformer_in_channel: int = 32,
                 num_encoder_layers: int = 3, nhead: int = 4, num_hier: int = 3,
                 clip_size: int = 32, input_hw: tuple = (224, 384)):
        super().__init__()
        self.use_transformer = use_transformer
        self.clip_size = clip_size
        self.y0_tdhw = y0_geometry(clip_size, tuple(input_hw))
        self.tokens = math.prod(self.y0_tdhw)
        self.visual_model = ViNet(num_hier, clip_size)
        self.audionet = SoundNet()
        self.maxpool = nn.MaxPool3d((4, 1, 1), stride=(2, 1, 2))
        self.bilinear = Bilinear(pooled_len(*self.y0_tdhw), AUDIO_FEATURES, self.tokens)
        if use_transformer:
            c = transformer_in_channel
            self.conv_in_1x1 = nn.Conv3d(1024, c, 1, bias=True)
            self.transformer = TransformerEncoder(self.tokens, nhead, num_encoder_layers,
                                                  hidden_size=self.tokens, max_len=c)
            self.conv_out_1x1 = nn.Conv3d(c, 1024, 1, bias=True)

    def fuse(self, y0: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """y0 (B, 1024, T0, H0, W0) and audio (B, L, 1) waveforms (cast to
        y0's dtype) -> the fused y0 the decoder takes, same shape."""
        b = y0.shape[0]
        a = self.audionet(audio.to(y0.dtype).reshape(b, 1, -1))  # (B, 1024, 3)
        fused = self.bilinear(self.maxpool(y0).flatten(2), a)  # (B, 1024, tokens)
        fused = fused.reshape(b, -1, *self.y0_tdhw)
        if self.use_transformer:
            z = self.conv_in_1x1(fused)
            z = self.transformer(z.flatten(2))  # the C channels are the tokens
            fused = self.conv_out_1x1(z.reshape(b, -1, *self.y0_tdhw))
        return fused

    def forward(self, x: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3) normalised clip, audio (B, L, 1) -> (B, H, W)."""
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        y0, y1, y2, y3 = self.visual_model.backbone(x)
        return self.visual_model.decoder([self.fuse(y0, audio), y1, y2, y3])
