"""Hollywood-2 / UCF-Sports inference (reference generate_result_hollywood_ucf.py).

``generate_result`` with videos shorter than 2*clip_size-1 frames padded in
front by repeating their first frame instead of skipped.

Usage:
  python -m vinet_tpu_torch.cli.generate_result_hollywood_ucf --path_indata DIR \
      --save_path OUT --file_weight ViNet_Hollywood.pt [--device cuda]
"""

from __future__ import annotations

from vinet_tpu_torch.cli.generate_result import build_parser, run


def main(argv=None):
    parser = build_parser()
    parser.description = __doc__
    args = parser.parse_args(argv)
    if args.live:
        parser.error("--live excludes --pad_short, which this command always sets")
    args.pad_short = True
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
