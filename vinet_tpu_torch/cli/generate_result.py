"""Visual-only sliding-window inference CLI (reference generate_result.py).

For every video dir under --path_indata (DHF1K layout <video>/images/*),
predicts a saliency map for every frame with the causal sliding window and
its flipped warm-up windows, resized to the native frame size, blurred,
min-max normalised, and saved as PNG under --save_path/<video>/ with the
frame's own file name. Windows run --window_batch at a time with BatchNorm
folded, in --dtype, on --device (default cuda; asking for cuda without a card
raises).

--model tased runs TASEDv2 (``models/tased.py``) through the same windows
and post ops instead of ViNet. --cuda_graph replays the model's forward as a
CUDA graph (``inference/engine.py``): the same maps for fewer host launches.

--streaming runs the backbone once per --chunk frames instead of once per
window (``inference/streaming.py``); --live feeds the frames --live_micro at
a time to the live server (``inference/live.py``), which emits each map with
a constant lag. Both see real temporal neighbours at window edges where the
reference zero-pads, so their maps differ from the default mode's.

--data_parallel splits each window batch over the processes of a
torch.distributed world (``utils/runtime.py::init_distributed``: torchrun's
variables or the VINET_* ones; one process without either): every process
walks the same videos and rank 0 writes the maps. --window_batch must be
divisible by the number of processes.

Usage:
  python -m vinet_tpu_torch.cli.generate_result --path_indata DIR \
      --save_path OUT --file_weight ViNet_DHF1K.pt [--device cuda] \
      [--streaming [--chunk 128] | --live [--live_micro 16]]
  python -m vinet_tpu_torch.cli.generate_result --model tased --path_indata DIR \
      --save_path OUT --file_weight tased_state_dict.pt
On N cards of one host:
  torchrun --standalone --nproc_per_node N -m vinet_tpu_torch.cli.generate_result \
      --data_parallel --path_indata DIR --save_path OUT ...
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
    from vinet_tpu_torch.cli.common import MODELS, add_model_args

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
    p.add_argument("--streaming", action="store_true",
                   help="whole-video streaming encoder: the backbone runs once per "
                        "chunk instead of once per window (not output-equivalent: "
                        "windows see real temporal neighbours where the reference "
                        "zero-pads)")
    p.add_argument("--chunk", type=int, default=128,
                   help="streaming chunk length in frames (multiple of 8)")
    p.add_argument("--live", action="store_true",
                   help="drive the live incremental server: frames are fed "
                        "--live_micro at a time and each map is emitted with a "
                        "constant lag of about 57 frames (--streaming semantics)")
    p.add_argument("--live_micro", type=int, default=16,
                   help="live microbatch (multiple of 8): smaller = lower latency, "
                        "larger = higher throughput")
    p.add_argument("--data_parallel", action="store_true",
                   help="split window batches over the processes of the torch.distributed "
                        "world (exact; rank 0 writes the maps)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless asked for cpu")
    p.add_argument("--cuda_graph", action="store_true",
                   help="sliding windows on a card: replay the model's forward as a CUDA "
                        "graph, captured at the first window batch (same maps, fewer "
                        "host launches)")
    p.add_argument("--model", type=str, default="vinet", choices=MODELS,
                   help="the visual model: ViNet, or TASEDv2 (clip 32, sliding windows only)")
    add_model_args(p)
    return p


def data_parallel_mesh(args):
    """(rank, the data-parallel mesh over every process) with
    --data_parallel, else (0, None)."""
    if not args.data_parallel:
        return 0, None
    from vinet_tpu_torch.parallel import create_mesh
    from vinet_tpu_torch.utils.runtime import init_distributed

    rank, _ = init_distributed(args.device)
    return rank, create_mesh()


def live_span(clip_size: int, micro: int) -> int:
    """Rolling-buffer span of the live servers: the pipeline lag, one window
    and two microbatches, at least 160 frames."""
    return max(160, ((96 + clip_size + 2 * micro + 7) // 8) * 8)


def make_predictor(args, mesh=None):
    """The predictor the flags ask for: live, streaming or sliding-window;
    the last two split their window batches over mesh's data axis."""
    from vinet_tpu_torch.cli.common import build_model
    from vinet_tpu_torch.inference import (LiveStreamingPredictor, SlidingWindowPredictor,
                                           StreamingPredictor)

    common = dict(clip_size=args.clip_size, dtype=DTYPES[args.dtype], device=args.device)
    if args.live:
        return LiveStreamingPredictor(
            build_model(args), batch=min(16, args.live_micro), micro=args.live_micro,
            span=live_span(args.clip_size, args.live_micro), **common)
    if args.streaming:
        return StreamingPredictor(build_model(args), batch=args.window_batch,
                                  chunk=args.chunk, mesh=mesh, **common)
    return SlidingWindowPredictor(build_model(args), batch=args.window_batch, mesh=mesh,
                                  graphs=args.cuda_graph, **common)


def emit_maps(predictor, args, clip_u8: np.ndarray, out_size: tuple):
    """(frame_index, map) of every frame of one video, quantised to uint8 on
    the device unless --exact_quantize."""
    quantize_u8 = not args.exact_quantize
    if args.live:
        predictor.reset()
        predictor.start(out_size=out_size, quantize_u8=quantize_u8)
        for lo in range(0, len(clip_u8), predictor.micro):
            yield from predictor.feed(clip_u8[lo: lo + predictor.micro])
        yield from predictor.flush()
    else:
        yield from predictor.predict_video(clip_u8, out_size=out_size,
                                           pad_short=args.pad_short, quantize_u8=quantize_u8)


def run(args) -> int:
    from vinet_tpu_torch.cli.common import model_input_size, shard_video_list
    from vinet_tpu_torch.io.images import load_frame, save_map

    rank, mesh = data_parallel_mesh(args)
    predictor = make_predictor(args, mesh)

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
            for frame_idx, smap in emit_maps(predictor, args, clip_u8, (orig_h, orig_w)):
                n_maps += 1
                if rank == 0:  # every rank has every map; one writes
                    out_path = join(args.save_path, dname, frames[frame_idx])
                    futures.append(pool.submit(save_map, smap, out_path))
            for f in futures:
                f.result()
    print(f"wrote {n_maps} maps", flush=True)
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.live and (args.streaming or args.pad_short or args.data_parallel):
        parser.error("--live excludes --streaming, --pad_short and --data_parallel")
    if args.use_sound:
        parser.error("--use_sound True: AViNet runs in generate_result_audio_visual")
    if args.model == "tased" and (args.streaming or args.live):
        parser.error("--model tased runs the sliding windows only: no --streaming or --live")
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
