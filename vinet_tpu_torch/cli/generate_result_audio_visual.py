"""Audio-visual sliding-window inference CLI
(``vinet_tpu/cli/generate_result_audio_visual.py``; the reference's
generate_result_audio_visual.py).

STAViS layout: a fold list names the videos and their fps
(<path_data>/fold_lists/DIEM_list_<mode>_fps.txt, or
<DS>_list_<mode>_<split>_fps.txt), or a DAVE-style {video: fps} json
(--fps_json); frames under <path_data>/video_frames/<DS>/<video>/, audio
under <path_data>/video_audio/<DS>/<video>/<video>.wav. With --use_sound True
each window gets its Hanning-windowed excerpt (``data/audio.py``) and the
warm-up windows reverse their clip and their audio; a video without a wav
gets zero audio. Maps are min-max normalised and saved as JPEG at quality
100 under --save_path/<video>/, on --device (default cuda; asking for cuda
without a card raises). Every decode ends in the fused head kernel on the
card.

--streaming shares the visual timelines across windows
(``AVStreamingPredictor``, chunk 128); --live feeds frames and samples
--live_micro frames at a time to the live server
(``AVLiveStreamingPredictor``), which emits each map with a constant lag.
Both see real temporal neighbours at window edges where the reference
zero-pads.

Usage:
  python -m vinet_tpu_torch.cli.generate_result_audio_visual \\
      --path_data ROOT --dataset DIEM --split -1 \\
      --file_weight AViNet_DIEM.pt --save_path OUT --use_sound True
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join

import numpy as np


def build_parser(description: str = __doc__):
    from vinet_tpu_torch.cli.common import add_model_args
    from vinet_tpu_torch.cli.generate_result import DTYPES

    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--file_weight", type=str, default=None)
    p.add_argument("--path_data", type=str, required=True,
                   help="STAViS root containing fold_lists/, video_frames/, "
                        "video_audio/, annotations/")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--dataset", type=str, default="DIEM")
    p.add_argument("--split", type=int, default=-1)
    p.add_argument("--mode", type=str, default="test")
    p.add_argument("--fps_json", type=str, default=None,
                   help="DAVE-style {video: fps} json instead of a fold list")
    p.add_argument("--start_idx", type=int, default=-1)
    p.add_argument("--num_parts", type=int, default=4)
    p.add_argument("--window_batch", type=int, default=16)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--streaming", action="store_true",
                   help="whole-video streaming encoder: shared visual timelines and "
                        "per-window audio fusion (window edges see real neighbours)")
    p.add_argument("--live", action="store_true",
                   help="drive the live server: frames and samples are fed "
                        "--live_micro frames at a time, each map emitted with a "
                        "constant lag of about 57 frames")
    p.add_argument("--live_micro", type=int, default=16)
    p.add_argument("--exact_quantize", action="store_true",
                   help="quantize maps to uint8 on the host in f64 (bit-exact reference "
                        "img_save rounding) instead of on the device in f32")
    p.add_argument("--data_parallel", action="store_true",
                   help="not ported yet (parallelism, ROADMAP.md queue 1)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless asked for cpu")
    add_model_args(p)
    return p


def make_predictor(args):
    """The predictor the flags ask for: live, streaming or sliding-window,
    AV with --use_sound True."""
    from vinet_tpu_torch.cli.common import build_model
    from vinet_tpu_torch.cli.generate_result import DTYPES, live_span
    from vinet_tpu_torch.inference import (AVLiveStreamingPredictor, AVStreamingPredictor,
                                           LiveStreamingPredictor, SlidingWindowPredictor,
                                           StreamingPredictor)

    common = dict(clip_size=args.clip_size, dtype=DTYPES[args.dtype], device=args.device)
    if args.live:
        cls = AVLiveStreamingPredictor if args.use_sound else LiveStreamingPredictor
        return cls(build_model(args), batch=min(16, args.live_micro), micro=args.live_micro,
                   span=live_span(args.clip_size, args.live_micro), **common)
    if args.streaming:
        cls = AVStreamingPredictor if args.use_sound else StreamingPredictor
        return cls(build_model(args), batch=args.window_batch, **common)
    return SlidingWindowPredictor(build_model(args), batch=args.window_batch, **common)


def excerpt_fn(args, info):
    """With --use_sound True, the window start -> excerpt function of a
    video's audio index entry (None, a missing wav: zero excerpts), else
    None."""
    from vinet_tpu_torch.data.audio import audio_excerpt

    if not args.use_sound:
        return None
    return lambda start: audio_excerpt(info, args.clip_size, start)


def emit_maps(predictor, args, clip_u8, out_size, info, fps):
    """(frame_index, map) of every frame of one video, with the audio of
    its index entry info. --live feeds the samples that belong to each
    microbatch's frames on the stream clock, the rest of the wav with no
    frames, then flushes."""
    quantize_u8 = not args.exact_quantize
    if not args.live:
        yield from predictor.predict_video(clip_u8, out_size=out_size,
                                           audio_fn=excerpt_fn(args, info),
                                           quantize_u8=quantize_u8)
        return
    predictor.reset()
    m = predictor.micro
    if not args.use_sound:
        predictor.start(out_size=out_size, quantize_u8=quantize_u8)
        for lo in range(0, len(clip_u8), m):
            yield from predictor.feed(clip_u8[lo: lo + m])
        yield from predictor.flush()
        return
    predictor.start(out_size=out_size, quantize_u8=quantize_u8, fps=fps)
    # no wav: zero excerpts, the reference's missing-wav behaviour
    wav = info.wav[0] if info is not None else np.zeros((0,), np.float32)
    spf = predictor.audio_fs / fps
    for lo in range(0, len(clip_u8), m):
        yield from predictor.feed(clip_u8[lo: lo + m], audio=wav[int(lo * spf): int((lo + m) * spf)])
    yield from predictor.feed(clip_u8[:0], audio=wav[int(len(clip_u8) * spf):])
    yield from predictor.flush()


def write_video_maps(pool, args, video, frame_dir, frames, out_name, maps_of) -> int:
    """Write one video's maps: its frames (file names under frame_dir, in
    order) decoded in pool at the model's size, maps_of(clip_u8, (h, w))
    yielding (frame_index, map) at the first frame's own size, each map
    saved as <save_path>/<video>/<out_name(frame)>. A video shorter than
    2 * clip_size - 1 frames is skipped. Returns the number of maps."""
    from vinet_tpu_torch.cli.common import model_input_size
    from vinet_tpu_torch.io.images import load_frame, save_map

    if len(frames) < 2 * args.clip_size - 1:
        print(f"{video}: more frames are needed", flush=True)
        return 0
    print(f"processing {video}", flush=True)
    os.makedirs(join(args.save_path, video), exist_ok=True)
    size = model_input_size(args)
    decoded = list(pool.map(lambda f: load_frame(join(frame_dir, f), size=size), frames))
    orig_w, orig_h = decoded[0][1]
    futures = [pool.submit(save_map, smap, join(args.save_path, video, out_name(frames[i])))
               for i, smap in maps_of(np.stack([d[0] for d in decoded]), (orig_h, orig_w))]
    for f in futures:
        f.result()
    return len(futures)


def run(args) -> int:
    from vinet_tpu_torch.cli.common import shard_video_list
    from vinet_tpu_torch.data.audio import build_audio_index
    from vinet_tpu_torch.data.datasets import read_fold_list, read_fps_json

    predictor = make_predictor(args)
    if args.fps_json:
        data = read_fps_json(args.fps_json)
    elif args.dataset == "DIEM":
        data = read_fold_list(join(args.path_data, "fold_lists", f"DIEM_list_{args.mode}_fps.txt"))
    else:
        data = read_fold_list(join(args.path_data, "fold_lists",
                                   f"{args.dataset}_list_{args.mode}_{args.split}_fps.txt"))
    videos = shard_video_list(sorted(data["names"]), args.start_idx, args.num_parts)
    fps = dict(zip(data["names"], data["fps"]))

    audio_index = {}
    if args.use_sound:
        nframes = {}
        for v in videos:
            d = join(args.path_data, "video_frames", args.dataset, v)
            nframes[v] = len(os.listdir(d)) if os.path.isdir(d) else 0
        audio_index = build_audio_index(
            videos, nframes, fps, join(args.path_data, "video_audio", args.dataset),
            gt_root=join(args.path_data, "annotations", args.dataset))

    n_maps = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for v in videos:
            frame_dir = join(args.path_data, "video_frames", args.dataset, v)
            n_maps += write_video_maps(
                pool, args, v, frame_dir, sorted(os.listdir(frame_dir)),
                lambda f: os.path.splitext(f)[0] + ".jpg",
                lambda clip, size, v=v: emit_maps(predictor, args, clip, size,
                                                  audio_index.get(v), fps[v]))
    print(f"wrote {n_maps} maps", flush=True)
    return 0


def check_args(parser, args) -> None:
    if args.data_parallel:
        parser.error("--data_parallel is not ported to vinet_tpu_torch yet")
    if args.live and args.streaming:
        parser.error("--live excludes --streaming")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(parser, args)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
