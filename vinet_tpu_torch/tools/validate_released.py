"""Released-weights validation runbook for the port, the counterpart of the
JAX package's ``scripts/validate_released.sh``.

Given a staged released checkpoint (``ViNet_DHF1K.pt``, the reference's
OneDrive bundle, its README.md:49) and the DHF1K validation videos
(``<video>/images/``, ``maps/``, ``fixation/``; its README.md:40), it writes
parity-mode maps with the port's ``generate_result`` (reference-exact
sliding window, host quantisation), scores them with ``evaluate_dhf1k`` (CC,
SIM, NSS, AUC-J), then does the same with ``generate_result --streaming``.
It downloads nothing: the files are placed by hand and named by flags or by
the environment variables VINET_CKPT and DHF1K_VAL.

Pass/fail guidance, as for the JAX runbook: the paper's DHF1K test numbers
(arXiv:2012.06170) are AUC-J 0.908, SIM 0.381, CC 0.511, NSS 2.87; on the
val split CC within about 0.03 of 0.52 is parity and below 0.45 a
conversion fault. Streaming maps score below parity unless the checkpoint
was fine-tuned with ``train --streaming_ft``.

Usage (on the card; --device cpu with --clip_size 8 and --gen_args
"--dtype float32" for a CPU dry run):
  python -m vinet_tpu_torch.tools.validate_released --ckpt ViNet_DHF1K.pt \\
      --val DHF1K/val --out OUT
Writes OUT/maps/, OUT/maps_streaming/, OUT/scores_parity.txt and
OUT/scores_streaming.txt.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shlex
import sys

METRICS = "cc,sim,nss,aucj"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", default=os.environ.get("VINET_CKPT"),
                   help="the released ViNet_DHF1K.pt (default $VINET_CKPT)")
    p.add_argument("--val", default=os.environ.get("DHF1K_VAL"),
                   help="DHF1K val videos with images/, maps/, fixation/ (default $DHF1K_VAL)")
    p.add_argument("--out", required=True, help="directory for the maps and the scores")
    p.add_argument("--clip_size", type=int, default=32,
                   help="the model's clip (32 for the released weights)")
    p.add_argument("--device", default="cuda", help="torch device; cuda unless asked for cpu")
    p.add_argument("--gen_args", default="", help="extra generate_result flags, one string")
    return p


def _score(pred: str, val: str, out_file: str) -> str:
    """evaluate_dhf1k on pred against val; its output, also written to
    out_file."""
    from vinet_tpu_torch.cli.evaluate_dhf1k import main as evaluate_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = evaluate_main(["--pred_path", pred, "--gt_path", val, "--metrics", METRICS])
    if rc != 0:
        raise SystemExit(f"evaluate_dhf1k failed with {rc}")
    with open(out_file, "w") as f:
        f.write(buf.getvalue())
    return buf.getvalue()


def run(args) -> int:
    from vinet_tpu_torch.cli.generate_result import main as generate_main

    if not args.ckpt or not args.val:
        raise SystemExit("name the checkpoint and the val set: --ckpt/--val or "
                         "VINET_CKPT/DHF1K_VAL")
    for path in (args.ckpt, args.val):
        if not os.path.exists(path):
            raise SystemExit(f"{path}: not found (this runbook downloads nothing)")
    os.makedirs(args.out, exist_ok=True)
    common = ["--file_weight", args.ckpt, "--path_indata", args.val, "--clip_size",
              str(args.clip_size), "--device", args.device, *shlex.split(args.gen_args)]
    steps = (("parity", ["--exact_quantize"], "maps"),
             ("streaming", ["--streaming"], "maps_streaming"))
    for i, (mode, flags, sub) in enumerate(steps, 1):
        print(f"== {i}/{len(steps)} {mode}: generate_result, then evaluate_dhf1k ==",
              flush=True)
        maps = os.path.join(args.out, sub)
        rc = generate_main(common + flags + ["--save_path", maps])
        if rc != 0:
            raise SystemExit(f"generate_result ({mode}) failed with {rc}")
        print(_score(maps, args.val, os.path.join(args.out, f"scores_{mode}.txt")), end="",
              flush=True)
    print(f"done: compare {os.path.join(args.out, 'scores_parity.txt')} with the paper's "
          "numbers (module docstring)", flush=True)
    return 0


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
