"""Fused inference and evaluation over a STAViS-layout dataset
(``vinet_tpu/cli/diem_val.py``; the reference's diem_val.py).

Per video of the fold list: sliding-window prediction with the flipped
warm-up windows (``SlidingWindowPredictor``, every decode ending in the
fused head kernel on the card), then per-frame SIM, CC, NSS and AUC-Judd
against eyeMap_%05d.jpg and the binary fixations of fixMap_%05d.mat
(scipy.io), printed as per-frame and per-video averages. --use_sound True
runs AViNet, each window with its excerpt of
<path_data>/video_audio/<DS>/<video>/<video>.wav (``data/audio.py``).

Usage:
  python -m vinet_tpu_torch.cli.diem_val --path_data ROOT --dataset DIEM \\
      --file_weight ViNet_DHF1K.pt [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np


def build_parser():
    from vinet_tpu_torch.cli.common import add_model_args
    from vinet_tpu_torch.cli.generate_result import DTYPES

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--file_weight", type=str, default=None)
    p.add_argument("--path_data", type=str, required=True)
    p.add_argument("--dataset", type=str, default="DIEM")
    p.add_argument("--split", type=int, default=-1)
    p.add_argument("--mode", type=str, default="test")
    p.add_argument("--start_idx", type=int, default=-1)
    p.add_argument("--num_parts", type=int, default=4)
    p.add_argument("--window_batch", type=int, default=16)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--max_videos", type=int, default=0, help="0 = all")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless asked for cpu")
    add_model_args(p)
    return p


def run(args) -> int:
    from vinet_tpu_torch.cli.common import build_model, model_input_size, shard_video_list
    from vinet_tpu_torch.cli.eval_diem import _load_fixmap
    from vinet_tpu_torch.cli.generate_result import DTYPES
    from vinet_tpu_torch.data.audio import audio_excerpt, build_audio_index
    from vinet_tpu_torch.data.datasets import read_fold_list
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.io.images import load_frame, load_map
    from vinet_tpu_torch.metrics import auc_judd, cc_score, nss_score, similarity_score

    predictor = SlidingWindowPredictor(build_model(args), clip_size=args.clip_size,
                                       batch=args.window_batch, dtype=DTYPES[args.dtype],
                                       device=args.device)

    if args.dataset == "DIEM":
        fold = f"DIEM_list_{args.mode}_fps.txt"
    else:
        fold = f"{args.dataset}_list_{args.mode}_{args.split}_fps.txt"
    data = read_fold_list(join(args.path_data, "fold_lists", fold))
    videos = shard_video_list(sorted(data["names"]), args.start_idx, args.num_parts)
    if args.max_videos:
        videos = videos[: args.max_videos]
    fps = dict(zip(data["names"], data["fps"]))

    audio_index = {}
    if args.use_sound:
        nframes = {v: len(os.listdir(join(args.path_data, "video_frames", args.dataset, v)))
                   for v in videos}
        audio_index = build_audio_index(
            videos, nframes, fps, join(args.path_data, "video_audio", args.dataset),
            gt_root=join(args.path_data, "annotations", args.dataset))

    frame_totals = {k: [] for k in ("sim", "cc", "nss", "aucj")}
    video_means = {k: [] for k in ("sim", "cc", "nss", "aucj")}
    for v in videos:
        frame_dir = join(args.path_data, "video_frames", args.dataset, v)
        annt = join(args.path_data, "annotations", args.dataset, v, "maps")
        frames = sorted(os.listdir(frame_dir))
        if len(frames) < 2 * args.clip_size - 1:
            continue
        print(f"processing {v}", flush=True)
        decoded = [load_frame(join(frame_dir, f), size=model_input_size(args)) for f in frames]
        clip_u8 = np.stack([d[0] for d in decoded])
        orig_w, orig_h = decoded[0][1]

        audio_fn = None
        if args.use_sound:
            info = audio_index.get(v)
            audio_fn = lambda start, _info=info: audio_excerpt(_info, args.clip_size, start)

        per = {k: [] for k in frame_totals}
        for frame_idx, smap in predictor.predict_video(clip_u8, out_size=(orig_h, orig_w),
                                                       audio_fn=audio_fn):
            fno = frame_idx + 1
            gt_path = join(annt, "eyeMap_%05d.jpg" % fno)
            if not os.path.exists(gt_path):
                continue
            gt = load_map(gt_path)
            if gt.max() <= 0:
                continue
            vals = {
                "sim": similarity_score(smap, gt),
                "cc": cc_score(smap, gt),
            }
            fix_path = join(args.path_data, "annotations", args.dataset, v,
                            "fixMap_%05d.mat" % fno)
            if os.path.exists(fix_path):
                fix = _load_fixmap(fix_path)
                vals["nss"] = nss_score(smap, fix)
                vals["aucj"] = auc_judd(smap, fix)
            for k, val in vals.items():
                if np.isfinite(val):
                    per[k].append(val)
                    frame_totals[k].append(val)
        for k in per:
            if per[k]:
                video_means[k].append(float(np.mean(per[k])))
        msg = " ".join(f"{k}={np.mean(per[k]):.4f}" for k in per if per[k])
        print(f"  {v}: {msg}", flush=True)

    print("=== per-frame averages ===", flush=True)
    for k in frame_totals:
        if frame_totals[k]:
            print(f"{k}: {np.mean(frame_totals[k]):.4f}", flush=True)
    print("=== per-video averages ===", flush=True)
    for k in video_means:
        if video_means[k]:
            print(f"{k}: {np.mean(video_means[k]):.4f}", flush=True)
    return 0


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
