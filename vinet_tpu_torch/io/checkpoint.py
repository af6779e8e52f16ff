"""Train-state checkpoints with step-level resume, ``vinet_tpu/io/checkpoint.py``
with ``torch.save`` in place of orbax.

One file per step, ``<directory>/step_<step>.pt``, holds the model's
state_dict (parameters and BatchNorm statistics), the optimizer's state, the
step and the generator's state; the newest three are kept. The JAX package's
orbax checkpoints are not read.
"""

from __future__ import annotations

import os
import re

import torch

KEEP = 3
_NAME = re.compile(r"step_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def save_checkpoint(directory: str, ts, step: int | None = None) -> str:
    """Write ts (a ``training/trainer.py::TrainState``) as the checkpoint of
    step (default ts.step); returns its path."""
    step = ts.step if step is None else int(step)
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": ts.model.state_dict(), "optimizer": ts.optimizer.state_dict(),
                "step": step, "generator": ts.generator.get_state()}, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    for old in _steps(directory)[:-KEEP]:
        os.remove(_path(directory, old))
    return path


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_raw(directory: str, step: int | None = None, map_location="cpu") -> dict:
    """The checkpoint of step (default the latest) as saved: {"model",
    "optimizer", "step", "generator"}, without a train state to load into."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return torch.load(_path(directory, step), map_location=map_location, weights_only=True)


def restore_checkpoint(directory: str, ts, step: int | None = None):
    """Load the checkpoint of step (default the latest) into ts in place and
    return it; tensors go to the devices of the model's parameters."""
    ck = restore_raw(directory, step, map_location=next(ts.model.parameters()).device)
    ts.model.load_state_dict(ck["model"], strict=True)
    ts.optimizer.load_state_dict(ck["optimizer"])
    ts.step = int(ck["step"])
    ts.generator.set_state(ck["generator"].cpu())
    return ts
