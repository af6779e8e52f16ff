"""Export weights as a reference-compatible torch ``.pt`` state_dict
(``vinet_tpu/cli/export_checkpoint.py``).

The model (ViNet, or AViNet with --use_sound True) is built from the flags,
then loaded from --file_weight (a JAX-package ``.npz`` or a reference
``.pt``) or from a train checkpoint of
``cli.train`` (--checkpoint_dir, the port's ``io/checkpoint.py`` files, with
--step, default the latest), strictly: a checkpoint that does not match the
flags fails. The reference's classes load the output strictly.

Usage:
  python -m vinet_tpu_torch.cli.export_checkpoint \\
      --checkpoint_dir ckpts/ --output vinet_export.pt
  python -m vinet_tpu_torch.cli.export_checkpoint \\
      --file_weight weights.npz --output vinet.pt
  python -m vinet_tpu_torch.cli.export_checkpoint \\
      --file_weight avinet.npz --use_sound True --output avinet.pt
"""

from __future__ import annotations

import argparse


def build_parser():
    from vinet_tpu_torch.cli.common import add_model_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="train-state directory (as written by cli.train)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to export (default: the latest)")
    p.add_argument("--file_weight", type=str, default=None,
                   help=".npz tree or torch .pt to re-export instead; "
                        '"None" exports the seeded random init')
    p.add_argument("--output", type=str, required=True, help="output .pt path")
    return p


def main(argv=None) -> int:
    from vinet_tpu_torch.cli.common import build_model
    from vinet_tpu_torch.io.checkpoint import restore_raw
    from vinet_tpu_torch.io.export import export_torch_checkpoint
    from vinet_tpu_torch.utils.runtime import num_params

    p = build_parser()
    args = p.parse_args(argv)
    if bool(args.checkpoint_dir) == bool(args.file_weight):
        p.error("exactly one of --checkpoint_dir / --file_weight is required")

    model = build_model(args)  # loads --file_weight strictly
    if args.checkpoint_dir:
        ck = restore_raw(args.checkpoint_dir, step=args.step)
        try:
            model.load_state_dict(ck["model"], strict=True)
        except RuntimeError as e:
            # the checkpoint must match the model built from the flags, or the
            # export would silently reflect the wrong flags
            p.error("checkpoint params do not match the model built from the "
                    "given flags (--use_sound/--use_transformer/--clip_size "
                    f"...): {e}")

    export_torch_checkpoint(args.output, model)
    print(f"exported {num_params(model)} params to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
