"""Readings for the limits of ``correct``: the program and the control (one
precision step below the configuration's), each against the plain
reference, at the cell's own sizes, one JSON line a seed.

    python3 portbench/control.py --workload vinet-dhf1k.parity \
        --seeds 11,12,13 --videos 2

The benchmark's own runs never run this; ``PERF.md`` records its readings
beside each limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--videos", type=int, default=2, help="videos (or feeds) a seed")
    args = p.parse_args(argv)
    core.set_caches()
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    cell = core.resolve(spec, args.workload, seed=0, seconds=0.0, trace=False)
    import torch

    torch.backends.cudnn.allow_tf32 = False  # the reference runs in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    for row in core.driver(cell).control(cell, [int(s) for s in args.seeds.split(",")],
                                         args.videos):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
