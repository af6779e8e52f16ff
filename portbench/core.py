"""The harness's general parts: the cell's files found by name, the caches,
the device checks, the profiler window and its reduction, the statistics and
the contract's result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. The configuration's ``file`` is a JSON
object of sizes; the mix is ``traffic/<traffic>.json``, whose ``driver``
names the general loop in ``drivers/<driver>.py`` that reads it. Each
per-layer metric is ``layer_metrics/<name>.py`` with ``read(ctx)``, which
returns a number or None (nothing to read: the metric is left out).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vinet_tpu")  # top-level module names, whole
# the data sheet of one NVIDIA H100 SXM (dense, no sparsity), at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with "name"
    traffic: dict  # the mix's file, with "name"
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: Path = ROOT  # the checkout whose portbench/ holds the cell's files


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(spec: dict, name: str) -> tuple:
    """(end_to_end, per_layer) entries that cell ``name`` reports: a metric
    with ``workloads`` where it lists the cell, one without in every cell
    (end to end) or in every cell that reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return e2e, per_layer


def resolve(spec: dict, name: str, root: Path = ROOT, **run) -> Cell:
    """The Cell of workload ``name``, its files read from under root."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = {"name": w["config"], **load_json(root / cfg_entry["file"])}
    traffic = {"name": w["traffic"],
               **load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")}
    e2e, per_layer = cell_metrics(spec, name)
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, root=root, **run)


def driver(cell: Cell):
    """The module of the cell's traffic driver."""
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def layer_reader(name: str, root: Path = ROOT):
    """``read`` of ``layer_metrics/<name>.py``."""
    path = root / "portbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_layer_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_caches(root: Path = ROOT) -> None:
    """Triton's cache at a fixed path inside the checkout (the port's nvcc
    libraries already go to ``vinet_tpu_torch/_build``)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "portbench" / ".cache" / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not hold."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    values = list(values)
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[18]


# ------------------------------------------------------------------ trace --
@dataclasses.dataclass
class Trace:
    """Device kernels and host ops of one profiler window, times in seconds
    from the window's start."""
    kernels: list  # (name, start, duration)
    host: list  # (name, start, duration) of CPU ops
    window_s: float
    spans: list = dataclasses.field(default_factory=list)  # record_function ranges


def traced(fn) -> Trace:
    """Run fn() under torch.profiler (CPU and CUDA) and return its Trace.
    The chrome trace goes to TMPDIR and is deleted after reading."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t_wall
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = load_json(Path(path))["traceEvents"]
    finally:
        os.unlink(path)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    t0 = min([e["ts"] for e in dev + host], default=0.0)
    conv = lambda es: sorted((e["name"], (e["ts"] - t0) / 1e6, e.get("dur", 0) / 1e6)  # noqa: E731
                             for e in es)
    return Trace(kernels=conv(dev), host=conv(host), window_s=window_s, spans=conv(spans))


def merged(intervals: list) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_within(trace: Trace, spans: list | None = None) -> tuple:
    """(busy seconds, span seconds): the union of the device's kernel time,
    inside spans [(start, end)] of trace time where given, else over the
    trace's first to last event."""
    busy = merged([(s, s + d) for _, s, d in trace.kernels])
    if spans is None:
        lo = min([s for _, s, _ in trace.kernels + trace.host], default=0.0)
        spans = [(lo, lo + trace.window_s)]
    total = sum(e - s for s, e in spans)
    inside = sum(max(0.0, min(e, be) - max(s, bs)) for s, e in spans for bs, be in busy)
    return inside, total


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps of the
    device, each named by the innermost host op running at the gap's start."""
    by_name = {}
    for name, _, d in trace.kernels:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged([(s, s + d) for _, s, d in trace.kernels])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        running = [(hs, name) for name, hs, hd in trace.host if hs <= s < hs + hd]
        named.append([max(running)[1][:120] if running else "host: no op", e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


# ----------------------------------------------------------------- result --
def device_record(count: int, trace: Trace | None = None) -> dict:
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}
    if trace is not None:
        busy, window = busy_within(trace)
        rec.update(busy_s=busy, window_s=window)
    return rec


def compared_lines(compared: dict) -> list:
    return [f"compared {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in compared.items()]
