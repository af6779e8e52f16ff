"""Raw-footage audio-visual inference (``vinet_tpu/cli/generate_theatre.py``;
the reference's generate_theatre.py).

Layout: <path_indata>/fps.json ({video: fps}), video_frames/<video>/*,
video_audio/<video>.wav (flat, any sample rate, resampled to 22050 Hz with
scipy's polyphase ``resample_poly`` at the ratio
``Fraction(22050, fs).limit_denominator(1000)``). The frames' sample ranges
are computed at the resampled rate: the reference computes them at the
original rate on the resampled waveform, which scrambles the windows whenever
the rate is not 22050 Hz, and the JAX package fixes that as this does. Maps
are saved under --save_path/<video>/ with the frames' own names, on --device
(default cuda).

Usage:
  python -m vinet_tpu_torch.cli.generate_theatre --path_indata ROOT \\
      --file_weight AViNet.pt --save_path OUT --use_sound True
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction
from os.path import join

import numpy as np


def build_parser():
    from vinet_tpu_torch.cli.common import add_model_args
    from vinet_tpu_torch.cli.generate_result import DTYPES

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--file_weight", type=str, default=None)
    p.add_argument("--path_indata", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--start_idx", type=int, default=-1)
    p.add_argument("--num_parts", type=int, default=4)
    p.add_argument("--window_batch", type=int, default=16)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless asked for cpu")
    add_model_args(p)
    return p


def load_resampled_wav(path: str, target_fs: int = 22050):
    """(C, N) samples at target_fs, and target_fs."""
    from scipy.signal import resample_poly

    from vinet_tpu_torch.data.audio import load_wav_raw

    wav, fs = load_wav_raw(path)
    if fs != target_fs:
        frac = Fraction(target_fs, fs).limit_denominator(1000)
        wav = resample_poly(wav, frac.numerator, frac.denominator, axis=1).astype(np.float32)
    return wav, target_fs


def audio_info(path: str, n_frames: int, fps: float):
    """The audio index entry of a theatre wav, resampled to 22050 Hz, its
    frames' sample ranges at that rate; None without the file."""
    from vinet_tpu_torch.data.audio import AudioInfo, frame_sample_ranges

    if not os.path.exists(path):
        return None
    wav, fs = load_resampled_wav(path)
    starts, ends = frame_sample_ranges(wav.shape[1], n_frames, fs, fps)
    return AudioInfo(wav=wav, fs=fs, starts=starts, ends=ends)


def run(args) -> int:
    from vinet_tpu_torch.cli.common import build_model, shard_video_list
    from vinet_tpu_torch.cli.generate_result import DTYPES
    from vinet_tpu_torch.cli.generate_result_audio_visual import excerpt_fn, write_video_maps
    from vinet_tpu_torch.inference import SlidingWindowPredictor

    predictor = SlidingWindowPredictor(build_model(args), clip_size=args.clip_size,
                                       batch=args.window_batch, dtype=DTYPES[args.dtype],
                                       device=args.device)
    with open(join(args.path_indata, "fps.json")) as f:
        video_fps = json.load(f)
    videos = shard_video_list(sorted(video_fps), args.start_idx, args.num_parts)

    n_maps = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for v in videos:
            frame_dir = join(args.path_indata, "video_frames", v)
            frames = sorted(f for f in os.listdir(frame_dir)
                            if os.path.isfile(join(frame_dir, f)))
            info = (audio_info(join(args.path_indata, "video_audio", f"{v}.wav"), len(frames),
                               float(video_fps[v])) if args.use_sound else None)
            n_maps += write_video_maps(
                pool, args, v, frame_dir, frames, lambda f: f,
                lambda clip, size, fn=excerpt_fn(args, info): predictor.predict_video(
                    clip, out_size=size, audio_fn=fn))
    print(f"wrote {n_maps} maps", flush=True)
    return 0


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
