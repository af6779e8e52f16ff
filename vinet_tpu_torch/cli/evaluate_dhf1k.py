"""Offline batch evaluator for DHF1K-layout predictions
(``vinet_tpu/cli/evaluate_dhf1k.py``; the reference's
code_for_Metrics/evaluationFunc.m and its Demo/eval1 scripts).

Per video dir: scores every predicted map against maps/ (continuous GT) and
fixation/ (binary fixations; .png or .mat) on CC, SIM, NSS, AUC-Judd,
AUC-Borji, shuffled AUC and optional EMD. The sAUC negative set is the union
of fixations from up to 10 random frames of the same video
(evaluationFunc.m:89-107). NaNs dropped; per-video and overall means printed.

Usage:
  python -m vinet_tpu_torch.cli.evaluate_dhf1k --pred_path OUT --gt_path DHF1K/val
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
    p.add_argument("--gt_path", type=str, required=True,
                   help="DHF1K layout: <video>/maps/*.png + <video>/fixation/*")
    p.add_argument("--metrics", type=str,
                   default="cc,sim,nss,aucj,aucb,sauc",
                   help="comma list from cc,sim,kldiv,nss,aucj,aucb,sauc,ig,emd; "
                        "ig's baseline is the mean GT map of <=10 random frames "
                        "of the same video (IG.m's baseMap argument)")
    p.add_argument("--max_videos", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    return p


def _load_fixation(path_base: str):
    """fixation frame as binary array; supports .png and .mat ('I' key)."""
    from vinet_tpu_torch.io.images import load_map

    if os.path.exists(path_base + ".mat"):
        from scipy.io import loadmat

        m = loadmat(path_base + ".mat")
        key = "I" if "I" in m else [k for k in m if not k.startswith("__")][0]
        return (np.asarray(m[key], np.float64) > 0).astype(np.float64)
    if os.path.exists(path_base + ".png"):
        return (load_map(path_base + ".png") > 0).astype(np.float64)
    return None


def run(args) -> int:
    from vinet_tpu_torch.io.images import load_map
    from vinet_tpu_torch.metrics import (
        auc_borji,
        auc_judd,
        auc_shuffled,
        cc_score,
        info_gain,
        kldiv_score,
        nss_score,
        similarity_score,
    )
    from vinet_tpu_torch.metrics.emd import emd_score

    want = [m.strip() for m in args.metrics.split(",") if m.strip()]
    rng = np.random.default_rng(args.seed)
    videos = sorted(d for d in os.listdir(args.pred_path)
                    if os.path.isdir(join(args.pred_path, d)))
    if args.max_videos:
        videos = videos[: args.max_videos]

    overall = {m: [] for m in want}
    for v in videos:
        pred_dir = join(args.pred_path, v)
        gt_maps = join(args.gt_path, v, "maps")
        gt_fix = join(args.gt_path, v, "fixation")
        if not os.path.isdir(gt_maps):
            continue
        frames = sorted(os.listdir(pred_dir))

        # sAUC other-map: union of fixations from <=10 random frames
        other_map = None
        if "sauc" in want and os.path.isdir(gt_fix):
            stems = [os.path.splitext(f)[0] for f in sorted(os.listdir(gt_fix))]
            pick = rng.choice(len(stems), size=min(10, len(stems)), replace=False)
            acc = None
            for k in pick:
                fx = _load_fixation(join(gt_fix, stems[int(k)]))
                if fx is not None:
                    acc = fx if acc is None else acc + fx
            if acc is not None:
                other_map = (acc > 0).astype(np.float64)

        # IG baseline: mean GT map of <=10 random frames of the same video
        base_map = None
        if "ig" in want:
            stems = [os.path.splitext(f)[0] for f in sorted(os.listdir(gt_maps))]
            pick = rng.choice(len(stems), size=min(10, len(stems)), replace=False)
            acc = None
            for k in pick:
                p = join(gt_maps, stems[int(k)])
                p = p + ".png" if os.path.exists(p + ".png") else p + ".jpg"
                if os.path.exists(p):
                    bm = load_map(p)
                    acc = bm if acc is None else acc + bm
            if acc is not None:
                base_map = acc / max(len(pick), 1)

        vals = {m: [] for m in want}
        for fname in frames:
            stem = os.path.splitext(fname)[0]
            gt_path = join(gt_maps, stem + ".png")
            if not os.path.exists(gt_path):
                gt_path = join(gt_maps, stem + ".jpg")
                if not os.path.exists(gt_path):
                    continue
            pred = load_map(join(pred_dir, fname))
            gt = load_map(gt_path)
            fix = _load_fixation(join(gt_fix, stem)) if os.path.isdir(gt_fix) else None

            if "cc" in want:
                vals["cc"].append(cc_score(pred, gt))
            if "sim" in want:
                vals["sim"].append(similarity_score(pred, gt))
            if "kldiv" in want:
                vals["kldiv"].append(kldiv_score(pred, gt))
            if fix is not None and fix.any():
                if "ig" in want:
                    vals["ig"].append(info_gain(pred, fix, base_map))
                if "nss" in want:
                    vals["nss"].append(nss_score(pred, fix))
                if "aucj" in want:
                    vals["aucj"].append(auc_judd(pred, fix))
                if "aucb" in want:
                    vals["aucb"].append(auc_borji(pred, fix))
                if "sauc" in want and other_map is not None:
                    vals["sauc"].append(auc_shuffled(pred, fix, other_map))
                if "emd" in want:
                    vals["emd"].append(emd_score(pred, gt))
        line = []
        for m in want:
            vv = [x for x in vals[m] if np.isfinite(x)]
            if vv:
                overall[m].append(float(np.mean(vv)))
                line.append(f"{m}={np.mean(vv):.4f}")
        print(f"{v}: " + " ".join(line), flush=True)

    print("=== overall (per-video means) ===", flush=True)
    for m in want:
        if overall[m]:
            print(f"{m}: {np.mean(overall[m]):.4f}", flush=True)
    return 0


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
