"""Find the live cell's knee: serve the live-cams mix at each stream count
for a stretch and report how late the feeds were issued, the latency and
the maps served a second, one JSON line a count.

    python3 portbench/sweep_live.py --workload avinet-stavis.live-cams \
        --streams 4,6,8,10,12 --seconds 15 --seed 5

A count is sustained when the last feeds are issued on time (the backlog
does not grow through the stretch).
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
    p.add_argument("--streams", required=True, help="comma-separated stream counts")
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args(argv)
    core.set_caches()
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    import torch

    for s in [int(v) for v in args.streams.split(",")]:
        cell = core.resolve(spec, args.workload, seed=args.seed, seconds=args.seconds,
                            trace=False)
        cell.traffic["streams"] = s
        drv = core.driver(cell)
        st = drv.setup(cell)
        win = drv.window(st, cell)
        late = st.window_stats["late"]
        print(json.dumps({"streams": s, "maps_per_s": win["maps_per_s"],
                          "map_latency_p95_ms": win["map_latency_p95_ms"],
                          "map_latency_p50_ms": 1e3 * sorted(st.window_stats["latencies"])[
                              len(st.window_stats["latencies"]) // 2],
                          "backlog_p95_ms": win["backlog_p95_ms"],
                          "last_feeds_late_ms": [1e3 * v for v in late[-3:]],
                          "feeds": len(late)}), flush=True)
        drv.release(st)
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
