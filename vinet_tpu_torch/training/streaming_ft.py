"""Streaming-consistent fine-tuning, ``vinet_tpu/training/streaming_ft.py``
in PyTorch: train through the --streaming forward itself,

    chunk (1, N, H, W, 3) --streaming_pyramid--> phase timelines
        --gather_windows(starts)--> per-window pyramids
        --decoder (training graph)--> maps --> loss vs each window's last-frame GT

so that the training distribution is the streaming inference's. The
backbone runs in eval mode (frozen BatchNorm statistics; its weights, BN
scales and biases still train) and the decoder in training mode, its plain
differentiable graph (``models/decoder.py``). Window starts always include
both chunk edges, the only windows that see zero padding in streaming
inference.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vinet_tpu_torch.inference.streaming import gather_windows, streaming_pyramid
from vinet_tpu_torch.training.losses import LossConfig, cc, loss_func, similarity
from vinet_tpu_torch.training.trainer import TrainState, apply_update, autocast, kept_modes


def sample_window_starts(rng: np.random.Generator, n_windows: int, chunk_len: int,
                         clip_size: int) -> np.ndarray:
    """Window starts of one step: uniform over [0, chunk_len - clip_size],
    with the two chunk-edge windows pinned; sorted int32."""
    hi = chunk_len - clip_size
    if hi < 0:
        raise ValueError(f"chunk {chunk_len} is shorter than the clip {clip_size}")
    starts = rng.integers(0, hi + 1, size=n_windows)
    if n_windows >= 2:
        starts[0], starts[-1] = 0, hi
    return np.sort(starts).astype(np.int32)


def eval_window_starts(n_windows: int, chunk_len: int, clip_size: int) -> np.ndarray:
    """Evenly spaced starts, edges included, for validation."""
    hi = chunk_len - clip_size
    return np.unique(np.linspace(0, hi, n_windows).round().astype(np.int32))


def _maps(model, batch: dict, clip_size: int) -> torch.Tensor:
    x = batch["chunk"].permute(0, 4, 1, 2, 3).contiguous()  # (1, 3, N, H, W)
    pyr = gather_windows(streaming_pyramid(model.backbone, x), batch["starts"], clip_size)
    return model.decoder(pyr)


def make_streaming_ft_step(loss_cfg: LossConfig, *, clip_size: int = 32,
                           compute_dtype: torch.dtype | None = None) -> Callable:
    """step(ts, batch) -> (ts, {"loss", "grad_norm"}), updating ts in place.

    batch = {"chunk": (1, N, H, W, 3) normalised, "gt": (K, H, W), "starts":
    (K,) int64 window starts with start + clip_size <= N}, on the model's
    device. Differentiates the whole streaming forward with the backbone's
    BatchNorm statistics frozen; compute_dtype as in
    ``trainer.make_train_step``."""

    def step(ts: TrainState, batch: dict):
        model = ts.model
        model.backbone.eval()
        model.decoder.train()
        ts.optimizer.zero_grad(set_to_none=True)
        with autocast(batch["chunk"].device, compute_dtype):
            out = _maps(model, batch, clip_size)
        loss = loss_func(out.float(), batch["gt"], loss_cfg)
        loss.backward()
        grad_norm = apply_update(ts)
        return ts, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_streaming_eval_step(loss_cfg: LossConfig, *, clip_size: int = 32) -> Callable:
    """step(ts, batch) -> {"loss", "cc", "sim"}: the streaming forward in
    eval mode without autograd, in the model's dtype (on a card the decoder
    ends in the fused head kernel), at the model's resolution."""

    def step(ts: TrainState, batch: dict) -> dict:
        model = ts.model
        with kept_modes(model), torch.no_grad():
            model.eval()
            out = _maps(model, batch, clip_size).float()
        gt = batch["gt"]
        return {"loss": loss_func(out, gt, loss_cfg), "cc": cc(out, gt),
                "sim": similarity(out, gt)}

    return step
