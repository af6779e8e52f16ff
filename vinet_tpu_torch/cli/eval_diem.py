"""Offline scorer for dumped prediction maps (``vinet_tpu/cli/eval_diem.py``;
the reference's eval_diem.m).

Per video: load every fixMap_%05d.mat, build the shuffle map
(createShuffmap1.m), then score each predicted jpg/png on CC / SIM / NSS /
AUC-Judd / shuffled-AUC against eyeMap_%05d.jpg + fixations; the current
frame's fixations are zeroed out of the shuffle map (eval_diem.m:63-65).
NaNs are dropped; per-video or per-frame averaging via --per_frame
(eval_diem.m:95-110). The optional --emd adds the FastEMD-equivalent EMD
(EMD.m) on the package's native C++ solver (``metrics/emd.py``).

Usage:
  python -m vinet_tpu_torch.cli.eval_diem --pred_path OUT --annot_path \
      ROOT/annotations/DIEM --annot_file ROOT/fold_lists/DIEM_list_test_fps.txt
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pred_path", type=str, required=True)
    p.add_argument("--annot_path", type=str, required=True)
    p.add_argument("--annot_file", type=str, required=True)
    p.add_argument("--per_frame", action="store_true",
                   help="average over frames instead of per-video means")
    p.add_argument("--emd", action="store_true", help="also compute EMD (slow)")
    p.add_argument("--max_videos", type=int, default=0)
    return p


def _load_fixmap(path):
    from scipy.io import loadmat

    m = loadmat(path)
    key = "eyeMap" if "eyeMap" in m else [k for k in m if not k.startswith("__")][0]
    return np.asarray(m[key], dtype=np.float64)


def run(args) -> int:
    from vinet_tpu_torch.data.datasets import read_fold_list
    from vinet_tpu_torch.io.images import load_map
    from vinet_tpu_torch.metrics import (
        auc_judd,
        auc_shuffled,
        cc_score,
        create_shuffle_map,
        nss_score,
        similarity_score,
    )
    from vinet_tpu_torch.metrics.emd import emd_score

    fold = read_fold_list(args.annot_file)
    videos = sorted(fold["names"])
    if args.max_videos:
        videos = videos[: args.max_videos]

    keys = ["cc", "sim", "nss", "aucj", "sauc"] + (["emd"] if args.emd else [])
    agg = {k: [] for k in keys}
    cnt = 0
    for i, v in enumerate(videos):
        pred_dir = join(args.pred_path, v)
        annot_dir = join(args.annot_path, v)
        if not os.path.isdir(pred_dir):
            continue
        n_frames = len([f for f in os.listdir(join(annot_dir, "maps"))
                        if f.endswith(".jpg")])
        fix_maps = {}
        for j in range(1, n_frames + 1):
            p = join(annot_dir, "fixMap_%05d.mat" % j)
            if os.path.exists(p):
                fix_maps[j] = _load_fixmap(p)
        shuf = create_shuffle_map(fix_maps.values()) if fix_maps else None
        print(f"video {i + 1} of {len(videos)}: {v}", flush=True)

        frame_vals = {k: [] for k in keys}
        for fname in sorted(os.listdir(pred_dir)):
            stem = os.path.splitext(fname)[0]
            try:
                frame_num = int(stem.split("_")[-1])
            except ValueError:
                continue
            if frame_num > n_frames:
                continue
            pred = load_map(join(pred_dir, fname))
            eye_path = join(annot_dir, "maps", "eyeMap_%05d.jpg" % frame_num)
            if not os.path.exists(eye_path):
                continue
            eye = load_map(eye_path)
            vals = {"cc": cc_score(pred, eye), "sim": similarity_score(pred, eye)}
            if args.emd:
                # EMD.m scores against the EYE map (EMD.m:28,33), so it does
                # not depend on fixMap presence for the frame.
                vals["emd"] = emd_score(pred, eye)
            if frame_num in fix_maps:
                fix = fix_maps[frame_num]
                vals["nss"] = nss_score(pred, fix)
                vals["aucj"] = auc_judd(pred, fix)
                if shuf is not None:
                    shuf1 = shuf.copy()
                    shuf1[fix == 1] = 0  # exclude current-frame fixations
                    vals["sauc"] = auc_shuffled(pred, fix, shuf1)
            for k, val in vals.items():
                if np.isfinite(val):
                    frame_vals[k].append(val)
        for k in keys:
            if not frame_vals[k]:
                continue
            if args.per_frame:
                agg[k].extend(frame_vals[k])
            else:
                agg[k].append(float(np.mean(frame_vals[k])))
        cnt += 1
        print("  " + " ".join(f"{k}={np.mean(frame_vals[k]):.4f}"
                              for k in keys if frame_vals[k]), flush=True)

    print("=== overall ===", flush=True)
    for k in keys:
        if agg[k]:
            print(f"{k}: {np.mean(agg[k]):.4f}", flush=True)
    return 0


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
