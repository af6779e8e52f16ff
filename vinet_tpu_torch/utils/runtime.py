"""Runtime helpers: the parameter count, a profiler context and the
bring-up of torch.distributed, ``vinet_tpu/utils/runtime.py``.

``enable_compilation_cache`` has no counterpart (PyTorch eager compiles
nothing ahead).
"""

from __future__ import annotations

import contextlib
import json
import os

import torch
import torch.distributed as dist

from vinet_tpu_torch.device import resolve_device
from vinet_tpu_torch.utils import trace


def init_distributed(device="cuda") -> tuple:
    """Join this process to its torch.distributed world: one process a card,
    the counterpart of ``jax.distributed.initialize()``. Returns (rank,
    world).

    - VINET_COORDINATOR=host:port, VINET_NUM_PROCESSES and VINET_PROCESS_ID
      (the JAX package's variables) set: the TCP store's address, the world
      size and this rank. An explicit bring-up: failures propagate.
    - otherwise torchrun's RANK, WORLD_SIZE and LOCAL_RANK (``env://``).
    - otherwise (0, 1), and no group: one process, so that --multihost on a
      one-card box is a no-op, as in the JAX package.

    The backend is NCCL for a CUDA device, on the card LOCAL_RANK names (by
    default the rank modulo the cards of the host); gloo for the CPU, which
    runs only when the caller asked for it (``device.resolve_device``). A
    process already joined returns its (rank, world)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    coord = os.environ.get("VINET_COORDINATOR")
    if coord:
        world = int(os.environ["VINET_NUM_PROCESSES"])
        rank = int(os.environ["VINET_PROCESS_ID"])
        init = dict(init_method=f"tcp://{coord}", world_size=world, rank=rank)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = dict(init_method="env://")
    else:
        return 0, 1
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **init)
    return rank, world


def num_params(model: torch.nn.Module) -> int:
    """Number of parameter values, each storage counted once (the
    reference's utils.py: tied parameters share a data pointer)."""
    return sum(dict((p.data_ptr(), p.numel()) for p in model.parameters()).values())


@contextlib.contextmanager
def enable_profiling(logdir: str):
    """torch.profiler around a code region (the host, and the card when
    there is one), the operator's exporter. The port's spans
    (``utils/trace.py``) are on while it records. Writes a Chrome trace to
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto), where
    each span is a ``user_annotation`` range beside the kernels, and the
    region's span records, each with its attrs and ``device_ms``, to
    ``logdir/spans.json``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    trace.clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(trace.records(), f)
