"""Multi-stream saliency serving CLI (``inference/serving.py``).

Serves S video streams concurrently on one card: frames are fed
--live_micro at a time for all streams in lockstep and every map is emitted
with a constant pipeline lag, the shape of a camera or broadcast fleet,
driven here from stored frame directories (DHF1K layout <video>/images/*).

Streams in one server share the frame geometry and advance together, so
videos are grouped by native frame size and served --streams at a time; a
group short of --streams repeats its last video, and shorter videos in a
group are padded with their last frame; the maps of the padding are dropped.
Maps have the window-edge semantics of --streaming/--live.

--stream_parallel shards the streams over the processes of a
torch.distributed world (``utils/runtime.py::init_distributed``: torchrun's
variables or the VINET_* ones; one process without either): each process
advances --streams / world streams, the maps are gathered once a decode,
and rank 0 writes them. --streams must be a multiple of the world's size.

Usage:
  python -m vinet_tpu_torch.cli.serve --path_indata DIR --save_path OUT \
      --file_weight ViNet_DHF1K.pt --streams 4 [--live_micro 32] [--device cuda]
On N cards of one host:
  torchrun --standalone --nproc_per_node N -m vinet_tpu_torch.cli.serve \
      --stream_parallel --streams 4 ...
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join

import numpy as np

from vinet_tpu_torch.cli.generate_result import DTYPES


def build_parser():
    from vinet_tpu_torch.cli.common import add_model_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--file_weight", type=str, default=None)
    p.add_argument("--path_indata", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--streams", type=int, default=4, help="concurrent streams per server")
    p.add_argument("--live_micro", type=int, default=32,
                   help="microbatch per stream (multiple of 8): larger = higher "
                        "aggregate throughput and a longer lag")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--exact_quantize", action="store_true",
                   help="quantize maps to uint8 on the host in f64 instead of on the "
                        "device in f32")
    p.add_argument("--stream_parallel", action="store_true",
                   help="shard the streams over the processes of the torch.distributed "
                        "world (no communication but the maps; --streams must be a "
                        "multiple of the world's size)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless asked for cpu")
    add_model_args(p)
    return p


def _native_size(frame_dir: str, frame: str) -> tuple:
    from PIL import Image

    with Image.open(join(frame_dir, frame)) as im:
        return im.size  # (w, h)


def run(args) -> int:
    from vinet_tpu_torch.cli.common import build_model, model_input_size
    from vinet_tpu_torch.cli.generate_result import live_span
    from vinet_tpu_torch.inference import MultiLiveServer
    from vinet_tpu_torch.io.images import load_frame, save_map

    rank, stream_mesh = 0, None
    if args.stream_parallel:
        from vinet_tpu_torch.parallel import create_mesh
        from vinet_tpu_torch.utils.runtime import init_distributed

        rank, _ = init_distributed(args.device)
        stream_mesh = create_mesh()
        if args.streams % stream_mesh.shape["data"]:
            raise SystemExit(f"--streams {args.streams} is not a multiple of the "
                             f"{stream_mesh.shape['data']}-way data axis")
    server = MultiLiveServer(
        build_model(args), streams=args.streams, stream_mesh=stream_mesh,
        clip_size=args.clip_size,
        batch=min(32, args.live_micro), micro=args.live_micro,
        span=live_span(args.clip_size, args.live_micro), dtype=DTYPES[args.dtype],
        device=args.device)

    # scan the videos; group them by native frame size (lockstep geometry)
    by_size: dict = {}
    meta = {}
    for dname in sorted(d for d in os.listdir(args.path_indata)
                        if os.path.isdir(join(args.path_indata, d))):
        frame_dir = join(args.path_indata, dname, "images")
        frames = sorted(f for f in os.listdir(frame_dir) if os.path.isfile(join(frame_dir, f)))
        if len(frames) < 2 * args.clip_size - 1:
            print(f"{dname}: more frames are needed", flush=True)
            continue
        meta[dname] = (frame_dir, frames)
        by_size.setdefault(_native_size(frame_dir, frames[0]), []).append(dname)

    in_size = model_input_size(args)
    n_maps = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for (w, h), group in sorted(by_size.items()):
            for lo in range(0, len(group), args.streams):
                chunk = group[lo: lo + args.streams]
                names = chunk + [chunk[-1]] * (args.streams - len(chunk))
                print("serving " + ", ".join(chunk), flush=True)
                lengths = [len(meta[n][1]) for n in names]
                t_max = max(lengths)

                def load_stream(name):
                    frame_dir, frames = meta[name]
                    clip = np.stack([load_frame(join(frame_dir, f), size=in_size)[0]
                                     for f in frames])
                    pad = np.repeat(clip[-1:], t_max - clip.shape[0], axis=0)
                    return np.concatenate([clip, pad])  # last-frame pad to lockstep

                clips = np.stack(list(pool.map(load_stream, names)))
                for name in chunk:
                    os.makedirs(join(args.save_path, name), exist_ok=True)
                server.reset()
                server.start(out_size=(h, w), quantize_u8=not args.exact_quantize)
                futures = []

                def sink(got):
                    nonlocal n_maps
                    for s, idx, smap in got:
                        if s >= len(chunk) or idx >= lengths[s]:
                            continue  # a padding stream's or a padding frame's map
                        n_maps += 1
                        if rank == 0:  # every rank has every stream's maps; one writes
                            out = join(args.save_path, names[s], meta[names[s]][1][idx])
                            futures.append(pool.submit(save_map, smap, out))

                for flo in range(0, t_max, server.micro):
                    sink(server.feed(clips[:, flo: flo + server.micro]))
                sink(server.flush())  # drains the tail (last-frame padding)
                for f in futures:
                    f.result()
    print(f"wrote {n_maps} maps", flush=True)
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.use_sound:
        parser.error("--use_sound True: AViNet runs in generate_result_audio_visual")
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
