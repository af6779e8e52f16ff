"""ViNet: S3D encoder + hierarchical upsampling decoder.

``vinet_tpu/models/vinet.py``: num_hier in {0,1,2,3} and clip_size in
{8,16,32,48} select the decoder plan. ``forward`` takes the JAX package's
layout, a normalised (B, T, H, W, 3) clip, and returns (B, H, W) maps in
[0, 1]; inside, the model runs NCDHW.
"""

from __future__ import annotations

from torch import nn

from vinet_tpu_torch.models.decoder import Decoder, decoder_plan
from vinet_tpu_torch.models.s3d import S3DBackbone


class ViNet(nn.Module):
    def __init__(self, num_hier: int = 3, clip_size: int = 32):
        super().__init__()
        self.num_hier = num_hier
        self.clip_size = clip_size
        self.backbone = S3DBackbone()
        self.decoder = Decoder(decoder_plan(num_hier, clip_size))

    def forward(self, x):
        """x: (B, T, H, W, 3) normalised clip -> (B, H, W) map."""
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        return self.decoder(self.backbone(x))
