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

``AViNetFusion`` (``vinet_tpu/models/avinet.py::AViNetFusion``, the
reference's VideoAudioSaliencyFusionModel) fuses by attention instead: y0
projected to C channels by conv_in_1x1 gives T0·H0·W0 video tokens (336),
SoundNet's output projected by audio_conv_1x1 gives 3 audio tokens, and the
joint encoder (feat C, max_len tokens + 3, its table 339 x C) runs over all
of them; the audio tokens' mean, broadcast over y0's geometry, is
concatenated to the video tokens channel-wise (2C = 1024 at C 512) for the
decoder.

In training mode (``train()``) SoundNet's BatchNorm trains at momentum 0.1
and eps 1e-5, the visual net's at 0.001 and 1e-3, the decoder runs its plain
training graph, and the encoders draw their dropout from the ``generator``
handed to ``forward`` (none: no dropout; ``models/transformer.py``). In eval
mode the decoder ends in the head kernel on the card.

The constructors do no file IO (the reference loads soundnet8_final.pth in
its __init__); weights load through ``io/weights.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vinet_tpu_torch.models.soundnet import SoundNet
from vinet_tpu_torch.models.transformer import TransformerEncoder, no_autocast
from vinet_tpu_torch.models.vinet import ViNet
from vinet_tpu_torch.ops.maxpool import MaxPool3d

AUDIO_FEATURES = 3  # SoundNet's output length for a 70 560-sample excerpt


def y0_geometry(clip_size: int, input_hw: tuple) -> tuple:
    """y0's (T, H, W): T/8, H/32, W/32; (4, 7, 12) for 32 x 224 x 384."""
    return (clip_size // 8, input_hw[0] // 32, input_hw[1] // 32)


def pooled_len(t_: int, h_: int, w_: int) -> int:
    """Features a channel after MaxPool3d((4, 1, 1), stride (2, 1, 2))."""
    return ((t_ - 4) // 2 + 1) * h_ * ((w_ - 1) // 2 + 1)


class Bilinear(nn.Module):
    """torch's nn.Bilinear over a channel axis: out[b, c, o] = sum_ij
    W[o, i, j] x1[b, c, i] x2[b, c, j] + bias[o], accumulated in f32 (f64
    for f64) with the bias added there before the cast to the compute dtype
    (``avinet.py:59-62``). The compute dtype is x1's, or autocast's where
    autocast is on: the inputs and the weights are rounded to it, as the JAX
    package's bf16 train step casts its parameters, and autocast, which
    would round the outer products to bf16 for the GEMM, is off inside."""

    def __init__(self, in1: int, in2: int, out: int):
        super().__init__()
        bound = 1.0 / math.sqrt(in1)
        self.weight = nn.Parameter(torch.empty(out, in1, in2).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out).uniform_(-bound, bound))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """x1 (B, C, I), x2 (B, C, J) -> (B, C, O): one GEMM over the outer
        products, (B·C, I·J) x (I·J, O), in f32."""
        dev = x1.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x1.dtype
        acc = torch.promote_types(dtype, torch.float32)

        def exact(t):  # rounded to the compute dtype, then held exactly in acc
            return t.to(dtype).to(acc)

        with no_autocast(x1.device):
            outer = (exact(x1)[..., :, None] * exact(x2)[..., None, :]).flatten(2)
            w = exact(self.weight).flatten(1)  # (O, I·J)
            return (torch.matmul(outer, w.t()) + exact(self.bias)).to(dtype)


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
        self.maxpool = MaxPool3d((4, 1, 1), stride=(2, 1, 2))
        self.bilinear = Bilinear(pooled_len(*self.y0_tdhw), AUDIO_FEATURES, self.tokens)
        if use_transformer:
            c = transformer_in_channel
            self.conv_in_1x1 = nn.Conv3d(1024, c, 1, bias=True)
            self.transformer = TransformerEncoder(self.tokens, nhead, num_encoder_layers,
                                                  hidden_size=self.tokens, max_len=c)
            self.conv_out_1x1 = nn.Conv3d(c, 1024, 1, bias=True)

    def fuse(self, y0: torch.Tensor, audio: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """y0 (B, 1024, T0, H0, W0) and audio (B, L, 1) waveforms (cast to
        y0's dtype) -> the fused y0 the decoder takes, same shape; the
        encoder's dropout (training mode) from generator."""
        b = y0.shape[0]
        a = self.audionet(audio.to(y0.dtype).reshape(b, 1, -1))  # (B, 1024, 3)
        fused = self.bilinear(self.maxpool(y0).flatten(2), a)  # (B, 1024, tokens)
        fused = fused.reshape(b, -1, *self.y0_tdhw)
        if self.use_transformer:
            z = self.conv_in_1x1(fused)
            z = self.transformer(z.flatten(2), generator)  # the C channels are the tokens
            fused = self.conv_out_1x1(z.reshape(b, -1, *self.y0_tdhw))
        return fused

    def forward(self, x: torch.Tensor, audio: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, T, H, W, 3) normalised clip, audio (B, L, 1) -> (B, H, W)."""
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        y0, y1, y2, y3 = self.visual_model.backbone(x)
        return self.visual_model.decoder([self.fuse(y0, audio, generator), y1, y2, y3])


class AViNetFusion(nn.Module):
    def __init__(self, transformer_in_channel: int = 512, num_encoder_layers: int = 3,
                 nhead: int = 4, num_hier: int = 3, clip_size: int = 32,
                 input_hw: tuple = (224, 384)):
        super().__init__()
        c = transformer_in_channel
        self.clip_size = clip_size
        self.y0_tdhw = y0_geometry(clip_size, tuple(input_hw))
        self.tokens = math.prod(self.y0_tdhw)
        self.visual_model = ViNet(num_hier, clip_size)
        self.audionet = SoundNet()
        self.conv_in_1x1 = nn.Conv3d(1024, c, 1, bias=True)
        self.audio_conv_1x1 = nn.Conv1d(1024, c, 1, bias=True)
        self.transformer = TransformerEncoder(c, nhead, num_encoder_layers, hidden_size=c,
                                              max_len=self.tokens + AUDIO_FEATURES)

    def forward(self, x: torch.Tensor, audio: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, T, H, W, 3) normalised clip, audio (B, L, 1) -> (B, H, W)."""
        b = x.shape[0]
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        y0, y1, y2, y3 = self.visual_model.backbone(x)
        a = self.audio_conv_1x1(self.audionet(audio.to(y0.dtype).reshape(b, 1, -1)))  # (B, C, 3)
        v = self.conv_in_1x1(y0).flatten(2)  # (B, C, tokens)
        tokens = self.transformer(torch.cat([v, a.to(v.dtype)], 2).transpose(1, 2), generator)
        vid = tokens[:, : self.tokens].transpose(1, 2).reshape(b, -1, *self.y0_tdhw)
        aud = tokens[:, self.tokens:].mean(1)[:, :, None, None, None].expand_as(vid)
        return self.visual_model.decoder([torch.cat([vid, aud], 1), y1, y2, y3])
