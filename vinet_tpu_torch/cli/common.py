"""Shared CLI plumbing: boolean and model flags, model building (ViNet,
AViNet or TASEDv2) with weights, sharding."""

from __future__ import annotations

import argparse

import torch

from vinet_tpu_torch.io.weights import load_model_weights
from vinet_tpu_torch.models import AViNet, TASEDv2, ViNet
from vinet_tpu_torch.models.tased import TASED_CLIP

MODELS = ("vinet", "tased")  # --model: the visual model of a CLI that offers the choice


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


def add_bool_flag(parser, name: str, default: bool, help: str | None = None) -> None:
    parser.add_argument(f"--{name}", type=str2bool, default=default, metavar="BOOL",
                        help=help)


def add_model_args(parser):
    """The JAX package's model flags (``vinet_tpu/cli/common.py:30-41``)."""
    parser.add_argument("--clip_size", type=int, default=32)
    parser.add_argument("--num_hier", type=int, default=3)
    parser.add_argument("--nhead", type=int, default=4,
                        help="AViNet's refinement encoder: attention heads")
    parser.add_argument("--num_encoder_layers", type=int, default=3,
                        help="AViNet's refinement encoder: layers")
    parser.add_argument("--transformer_in_channel", type=int, default=32,
                        help="AViNet's refinement encoder: channels, its tokens")
    add_bool_flag(parser, "use_sound", False, help="AViNet (audio-visual) instead of ViNet")
    add_bool_flag(parser, "use_transformer", False,
                  help="AViNet with the self-attention refinement of the fused y0")
    parser.add_argument("--input_h", type=int, default=224,
                        help="model input height (reference fixed 224)")
    parser.add_argument("--input_w", type=int, default=384,
                        help="model input width (reference fixed 384)")


def model_input_size(args) -> tuple:
    return (args.input_h, args.input_w)


def build_model(args):
    """ViNet, AViNet for --use_sound True, or TASEDv2 for --model tased, for
    the flags, with --file_weight loaded strictly (an S3D Kinetics-400 file
    into ViNet's backbone alone, a SoundNet file into AViNet's audionet
    alone); without weights (the string "None" included, as reference
    command lines pass it), a random init from seed 0. TASEDv2 refuses a
    clip other than 32, --use_sound and int8."""
    torch.manual_seed(0)
    if getattr(args, "model", "vinet") == "tased":
        if args.clip_size != TASED_CLIP:
            raise ValueError(f"--model tased takes --clip_size {TASED_CLIP}, got {args.clip_size}")
        if getattr(args, "use_sound", False):
            raise ValueError("--model tased is visual only: it takes no --use_sound")
        if getattr(args, "dtype", None) == "int8":
            raise ValueError("--model tased has no int8 path")
        model = TASEDv2()
    elif getattr(args, "use_sound", False):
        model = AViNet(use_transformer=args.use_transformer,
                       transformer_in_channel=args.transformer_in_channel,
                       num_encoder_layers=args.num_encoder_layers, nhead=args.nhead,
                       num_hier=args.num_hier, clip_size=args.clip_size,
                       input_hw=model_input_size(args))
    else:
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
