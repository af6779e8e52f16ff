"""Shared CLI plumbing: model flags, model building with weights, sharding."""

from __future__ import annotations

import torch

from vinet_tpu_torch.io.weights import load_weights
from vinet_tpu_torch.models import ViNet


def add_model_args(parser):
    parser.add_argument("--clip_size", type=int, default=32)
    parser.add_argument("--num_hier", type=int, default=3)
    parser.add_argument("--input_h", type=int, default=224,
                        help="model input height (reference fixed 224)")
    parser.add_argument("--input_w", type=int, default=384,
                        help="model input width (reference fixed 384)")


def model_input_size(args) -> tuple:
    return (args.input_h, args.input_w)


def build_model(args) -> ViNet:
    """ViNet for the flags, with --file_weight loaded strictly; without
    weights (the string "None" included, as reference command lines pass
    it), a random init from seed 0."""
    torch.manual_seed(0)
    model = ViNet(num_hier=args.num_hier, clip_size=args.clip_size)
    path = getattr(args, "file_weight", None)
    if path not in (None, "", "None"):
        model.load_state_dict(load_weights(path), strict=True)
    return model


def shard_video_list(names: list, start_idx: int, num_parts: int) -> list:
    """The reference's manual process-level sharding: part ``start_idx``
    (1-based) of ``num_parts``; -1 keeps every name."""
    if start_idx == -1:
        return names
    ln = (1.0 / num_parts) * len(names)
    return names[int((start_idx - 1) * ln): int(start_idx * ln)]
