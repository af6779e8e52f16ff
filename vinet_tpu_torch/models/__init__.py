from vinet_tpu_torch.models.avinet import AViNet, AViNetFusion, Bilinear
from vinet_tpu_torch.models.decoder import DECODER_PLANS, Decoder, DecoderPlan, decoder_plan
from vinet_tpu_torch.models.inference import cast_floating, fold_batchnorms
from vinet_tpu_torch.models.s3d import MIXED_PLAN, InceptionBlock, S3DBackbone
from vinet_tpu_torch.models.soundnet import SoundNet
from vinet_tpu_torch.models.tased import TASEDv2
from vinet_tpu_torch.models.transformer import (MultiheadAttention, Seq2SeqTransformer,
                                                TransformerDecoderLayer, TransformerEncoder,
                                                TransformerEncoderLayer)
from vinet_tpu_torch.models.vinet import ViNet

__all__ = [
    "AViNet",
    "AViNetFusion",
    "Bilinear",
    "DECODER_PLANS",
    "Decoder",
    "DecoderPlan",
    "decoder_plan",
    "cast_floating",
    "fold_batchnorms",
    "MIXED_PLAN",
    "InceptionBlock",
    "MultiheadAttention",
    "S3DBackbone",
    "Seq2SeqTransformer",
    "SoundNet",
    "TASEDv2",
    "TransformerDecoderLayer",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "ViNet",
]
