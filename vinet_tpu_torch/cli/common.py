"""Shared CLI plumbing: boolean and model flags, model building with
weights, sharding."""

from __future__ import annotations

import argparse

import torch

from vinet_tpu_torch.io.weights import load_model_weights
from vinet_tpu_torch.models import ViNet


def str2bool(v) -> bool:
    """A real boolean flag value (the reference's type=bool flags take any
    non-empty string as True)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def add_bool_flag(parser, name: str, default: bool) -> None:
    parser.add_argument(f"--{name}", type=str2bool, default=default, metavar="BOOL")


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
    """ViNet for the flags, with --file_weight loaded strictly (an S3D
    Kinetics-400 file into the backbone alone); without weights (the string
    "None" included, as reference command lines pass it), a random init
    from seed 0."""
    torch.manual_seed(0)
    model = ViNet(num_hier=args.num_hier, clip_size=args.clip_size)
    path = getattr(args, "file_weight", None)
    if has_weights(path):
        load_model_weights(model, path)
    return model


def has_weights(path) -> bool:
    """A weights flag names a file; "None" is the reference's no-weights
    sentinel."""
    return path not in (None, "", "None")


def shard_video_list(names: list, start_idx: int, num_parts: int) -> list:
    """The reference's manual process-level sharding: part ``start_idx``
    (1-based) of ``num_parts``; -1 keeps every name."""
    if start_idx == -1:
        return names
    ln = (1.0 / num_parts) * len(names)
    return names[int((start_idx - 1) * ln): int(start_idx * ln)]
