"""Visual-only sliding-window inference CLI (reference generate_result.py).

For every video dir under --path_indata (DHF1K layout <video>/images/*),
predicts a saliency map for every frame with the causal sliding window and
its flipped warm-up windows, resized to the native frame size, blurred,
min-max normalised, and saved as PNG under --save_path/<video>/ with the
frame's own file name. Windows run --window_batch at a time with BatchNorm
folded, in --dtype, on --device (default cuda; asking for cuda without a card
raises).

Usage:
  python -m vinet_tpu_torch.cli.generate_result --path_indata DIR \
      --save_path OUT --file_weight ViNet_DHF1K.pt [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser():
    from vinet_tpu_torch.cli.common import add_model_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--file_weight", type=str, default=None,
                   help="reference .pt state_dict or JAX-package .npz weights; "
                        "omit for a seeded random init (smoke tests)")
    p.add_argument("--path_indata", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--start_idx", type=int, default=-1)
    p.add_argument("--num_parts", type=int, default=4)
    p.add_argument("--window_batch", type=int, default=16)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--pad_short", action="store_true",
                   help="pad videos shorter than 2*clip_size-1 by repeating the "
                        "first frame (Hollywood/UCF semantics) instead of skipping")
    p.add_argument("--exact_quantize", action="store_true",
                   help="quantize maps to uint8 on the host in f64 (bit-exact "
                        "reference img_save rounding) instead of on the device "
                        "in f32 (can differ by 1 gray level on rounding ties)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless asked for cpu")
    add_model_args(p)
    return p


def run(args) -> int:
    from vinet_tpu_torch.cli.common import build_model, model_input_size, shard_video_list
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.io.images import load_frame, save_map

    predictor = SlidingWindowPredictor(
        build_model(args), clip_size=args.clip_size, batch=args.window_batch,
        dtype=DTYPES[args.dtype], device=args.device)

    videos = sorted(d for d in os.listdir(args.path_indata)
                    if os.path.isdir(join(args.path_indata, d)))
    videos = shard_video_list(videos, args.start_idx, args.num_parts)

    n_maps = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for dname in videos:
            print(f"processing {dname}", flush=True)
            frame_dir = join(args.path_indata, dname, "images")
            frames = sorted(f for f in os.listdir(frame_dir)
                            if os.path.isfile(join(frame_dir, f)))
            if len(frames) < 2 * args.clip_size - 1 and not args.pad_short:
                print(" more frames are needed", flush=True)
                continue
            os.makedirs(join(args.save_path, dname), exist_ok=True)

            size = model_input_size(args)
            decoded = list(pool.map(lambda f: load_frame(join(frame_dir, f), size=size),
                                    frames))
            clip_u8 = np.stack([d[0] for d in decoded])
            orig_w, orig_h = decoded[0][1]

            futures = []
            for frame_idx, smap in predictor.predict_video(
                    clip_u8, out_size=(orig_h, orig_w), pad_short=args.pad_short,
                    quantize_u8=not args.exact_quantize):
                out_path = join(args.save_path, dname, frames[frame_idx])
                futures.append(pool.submit(save_map, smap, out_path))
                n_maps += 1
            for f in futures:
                f.result()
    print(f"wrote {n_maps} maps", flush=True)
    return 0


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
