"""TASEDv2: the TASED-Net-style encoder-decoder of the reference's
model_utils.py:5-126, ``vinet_tpu/models/tased.py::TASEDv2`` in NCDHW.

The S3D encoder's stages (``models/s3d.py``) at the top level, as the
reference names them (``base1`` ... ``base4``), give y0 (B, 1024, T/8,
H/32, W/32); the decoder ``convtsp1`` ... ``convtsp4`` upsamples it with
ConvTranspose3d (1, 4, 4)/(1, 2, 2) + BatchNorm + ReLU stacks, collapses time
with two strided (2, 1, 1) convs and ends in a sigmoid map. Clip 32 is
required: y0 has T = 4 and the two strided convs bring it to 1. The
reference's maxp4 asks for pooling indices and ignores them; plain pooling
here, as in the JAX package. BatchNorm is the visual net's (eps 1e-3,
momentum 0.001), on batch statistics in ``train()``.

The transposed convolutions are ``nn.ConvTranspose3d``: the counterpart of
``vinet_tpu/ops/conv.py::conv_transpose3d``, which is an XLA convolution
with input dilation, not a Pallas kernel, so no hand-written kernel is due.
Their weights are torch's (I, O, kT, kH, kW); the JAX package stores (kT, kH,
kW, I, O) (``io/weights.py::TASED_TRANSPOSED``).

Inference (``inference/engine.py::prepared_copy``) folds every BatchNorm:
S3D's through its blocks' ``fold_bn``, the decoder's eight through
``DecoderStage.fold_bn``, which puts each into the conv or ConvTranspose3d
before it (a ConvTranspose3d's scale on its weight's dim 1) as a bias and
leaves ``nn.Identity`` in its place, so the stages keep the reference's
indices and a bf16 copy runs no BatchNorm. A ConvTranspose3d with a bias,
one whose BatchNorm is folded, is the folded route; ``folded_calls`` counts
its calls. In bf16 outside autograd the S3D stages take the stem and pool
kernels, as ViNet's do. The decoder runs inside the span ``tased.decode``
(``utils/trace.py``; attrs ``rows``, its request the enclosing span's).

``forward`` takes the port's ViNet layout, a normalised (B, T, H, W, 3)
clip, and returns (B, H, W) maps in [0, 1].
"""

from __future__ import annotations

from torch import nn

from vinet_tpu_torch.models.layers import _bn, fold_conv_bn
from vinet_tpu_torch.models.s3d import S3DBackbone
from vinet_tpu_torch.utils import trace

TASED_CLIP = 32

folded_calls = 0  # calls of a ConvTranspose3d with its BatchNorm folded; a run may reset it


def _ct_block(in_ch: int, out_ch: int) -> tuple:
    return (nn.ConvTranspose3d(in_ch, out_ch, (1, 4, 4), (1, 2, 2), (0, 1, 1), bias=False),
            _bn(out_ch), nn.ReLU())


def _conv_bn_relu(in_ch: int, out_ch: int, kernel, stride=1) -> tuple:
    return nn.Conv3d(in_ch, out_ch, kernel, stride, bias=False), _bn(out_ch), nn.ReLU()


class DecoderStage(nn.Sequential):
    """One of the reference's decoder ``nn.Sequential``s, under its indices,
    whose BatchNorms fold into the layer before each."""

    def forward(self, x):
        global folded_calls
        for layer in self:
            if isinstance(layer, nn.ConvTranspose3d) and layer.bias is not None:
                folded_calls += 1
            x = layer(x)
        return x

    def fold_bn(self):
        for i in range(1, len(self)):
            if isinstance(self[i], nn.BatchNorm3d):
                self[i] = fold_conv_bn(self[i - 1], self[i])


class TASEDv2(S3DBackbone):
    """The S3D stages and their pools (inherited, at the top level as the
    reference names them) and the four decoder stages."""

    def __init__(self):
        super().__init__()
        self.convtsp1 = DecoderStage(*_conv_bn_relu(1024, 1024, 1), *_ct_block(1024, 832))
        self.convtsp2 = DecoderStage(*_ct_block(832, 480))
        self.convtsp3 = DecoderStage(*_ct_block(480, 192))
        self.convtsp4 = DecoderStage(
            *_ct_block(192, 64),
            *_conv_bn_relu(64, 64, (2, 1, 1), (2, 1, 1)),
            nn.ConvTranspose3d(64, 4, 1, 1, 0, bias=False), _bn(4), nn.ReLU(),
            *_conv_bn_relu(4, 4, (2, 1, 1), (2, 1, 1)),
            nn.ConvTranspose3d(4, 4, (1, 4, 4), (1, 2, 2), (0, 1, 1), bias=False),
            nn.Conv3d(4, 1, 1, 1, 0, bias=True), nn.Sigmoid())

    def forward(self, x):
        """x: (B, 32, H, W, 3) normalised clip -> (B, H, W) map."""
        if x.shape[1] != TASED_CLIP:
            raise ValueError(f"TASEDv2 takes {TASED_CLIP}-frame clips, got {x.shape[1]}")
        z = super().forward(x.permute(0, 4, 1, 2, 3).contiguous())[0]
        with trace.span("tased.decode", rows=z.shape[0]):
            for stage in (self.convtsp1, self.convtsp2, self.convtsp3, self.convtsp4):
                z = stage(z)
        return z[:, 0, 0]
