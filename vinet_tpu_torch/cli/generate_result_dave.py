"""DAVE-fold-list audio-visual inference (``vinet_tpu/cli/generate_result_dave.py``;
the reference's generate_result_dave.py).

``generate_result_audio_visual`` with the video list and fps from a
DAVE-style {video: fps} json (--fps_json, required) instead of a STAViS fold
list.

Usage:
  python -m vinet_tpu_torch.cli.generate_result_dave --path_data ROOT \\
      --dataset DIEM --fps_json DIEM_fps_map.json \\
      --file_weight AViNet_DIEM.pt --save_path OUT --use_sound True
"""

from __future__ import annotations

from vinet_tpu_torch.cli.generate_result_audio_visual import build_parser, check_args, run


def main(argv=None):
    parser = build_parser(__doc__)
    args = parser.parse_args(argv)
    if not args.fps_json:
        parser.error("--fps_json is required for the DAVE variant")
    check_args(parser, args)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
