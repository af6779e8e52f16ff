"""Run one cell of the port's benchmark once and print the result line.

    python3 portbench/run.py --workload vinet-dhf1k.parity --seed 1234 \
        --seconds 30 --trace 0

From the root of a checkout: loads the program (``vinet_tpu_torch``) with
the cell's configuration, warms up every shape the cell's traffic uses,
measures for ``--seconds`` seconds, checks the window's outputs against the
plain reference in ``portbench/reference/`` and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device`` and ``compared`` (each number the
check compared, with its limit; also the last lines of standard error).
With ``--trace 1`` a profiled stretch follows the window and the line also
has ``breakdown``.

Exits non-zero without a result when there is no CUDA device, fewer than
the cell's chips, or when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def limits(cell) -> dict:
    """The cell's limits of ``correct``: ``limits/<workload>.json``."""
    return core.load_json(cell.root / "portbench" / "limits" / f"{cell.name}.json")


def measure(cell, t_start: float = T_START) -> dict:
    """Set up, measure, check; the result object (without printing). Also
    runs on the CPU at small sizes, for the tests."""
    import torch

    drv = core.driver(cell)
    on_card = cell.device != "cpu"
    st = drv.setup(cell)
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    win = drv.window(st, cell)
    trace = None
    if cell.trace:
        trace = core.traced(drv.traced_work(st, cell)) if on_card else None
    device = core.device_record(cell.chips, trace) if on_card else {"platform": "cpu"}
    ctx = {"cell": cell, "window": win, "trace": trace, "state": st, "setup_s": setup_s}
    if cell.trace:
        metrics = {}
        for m in cell.per_layer:
            value = core.layer_reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **win}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    drv.release(st)
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False  # the reference runs in true f32
        torch.backends.cuda.matmul.allow_tf32 = False
    ok, compared = drv.check(st, cell, limits(cell))
    out = {"correct": bool(ok and win["failed"] == 0), "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": device}
    if trace is not None:
        out["breakdown"] = core.breakdown(trace)
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    args = parse(argv)
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    core.set_caches()
    cell = core.resolve(spec, args.workload, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = measure(cell)
    bad = core.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 4
    for line in core.compared_lines(out["compared"]):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
