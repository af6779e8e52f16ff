"""Runtime helpers: the parameter count and a profiler context,
``vinet_tpu/utils/runtime.py``.

``enable_compilation_cache`` has no counterpart (PyTorch eager compiles
nothing ahead); ``init_distributed`` waits for the parallelism slice
(``ROADMAP.md`` queue 1 item 4).
"""

from __future__ import annotations

import contextlib
import os

import torch


def num_params(model: torch.nn.Module) -> int:
    """Number of parameter values, each storage counted once (the
    reference's utils.py: tied parameters share a data pointer)."""
    return sum(dict((p.data_ptr(), p.numel()) for p in model.parameters()).values())


@contextlib.contextmanager
def enable_profiling(logdir: str):
    """torch.profiler around a code region (the host, and the card when
    there is one); writes a Chrome trace to ``logdir/trace.json`` (open it in
    chrome://tracing or Perfetto). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
