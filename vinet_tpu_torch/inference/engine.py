"""Batched sliding-window saliency inference, ``vinet_tpu/inference/engine.py``
on PyTorch.

Causal semantics per frame i: predict from frames [i-T+1 .. i]; the first T-1
frames are predicted from time-FLIPPED clips ending at that frame, so every
frame gets a map. Videos shorter than 2T-1 frames are skipped unless
``pad_short`` (repeat the first frame in front).

A video's frames go to the device once, as uint8; windows are gathered there
by index (a flipped window is its index row reversed) and run ``batch`` at a
time: normalise, model, resize every map to the native size, Gaussian blur
and optionally quantise to uint8. The host only decodes and encodes PNGs.

For AViNet, ``audio_fn(start)`` gives each window its (L, 1) excerpt: on the
device it is cast to the compute dtype and, for a warm-up window, reversed
along the samples next to its clip; padded batch rows get zero audio.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from vinet_tpu_torch.data.pipeline import device_preprocess
from vinet_tpu_torch.device import resolve_device
from vinet_tpu_torch.models.inference import cast_floating, fold_batchnorms
from vinet_tpu_torch.ops.image import gaussian_blur, quantize_maps_u8, resize_bilinear

FETCH_EVERY = 4  # window batches kept on the device per device->host copy
BLUR_KSIZE = 11  # the reference's cv2.GaussianBlur(map, (11, 11), 0)


@dataclasses.dataclass(frozen=True)
class WindowTask:
    out_frame: int  # index of the frame this window predicts
    start: int  # first frame index of the window
    flipped: bool


def prepared_copy(model: torch.nn.Module, dtype: torch.dtype, device) -> torch.nn.Module:
    """A copy of model for inference: BatchNorms folded, cast to dtype, on
    device, in eval mode. The model passed in is not changed."""
    model = copy.deepcopy(model).eval()
    return cast_floating(fold_batchnorms(model), dtype).to(device)


def window_plan(n_frames: int, clip_size: int, *, pad_short: bool = False) -> list:
    """All (out_frame, start, flipped) windows for a video, in the reference's
    emission order. Returns [] for videos that are too short without padding."""
    t = clip_size
    if n_frames < 2 * t - 1 and not pad_short:
        return []
    plan = []
    for i in range(n_frames):
        if i >= t - 1:
            plan.append(WindowTask(i, i - t + 1, False))
            if i < 2 * t - 2:
                plan.append(WindowTask(i - t + 1, i - t + 1, True))
    return plan


class SlidingWindowPredictor:
    def __init__(self, model: torch.nn.Module, *, clip_size: int = 32, batch: int = 16,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        """model: a ViNet or AViNet with its weights loaded (or any module
        mapping (B, T, H, W, 3) clips [and (B, L, 1) audio] to (B, H, W)
        maps). The predictor prepares a
        copy of it (BatchNorms folded, cast to dtype, moved to device, eval
        mode) and leaves the caller's model as it is, as the JAX predictors
        leave (params, state)."""
        self.device = resolve_device(device)
        self.model = prepared_copy(model, dtype, self.device)
        self.clip_size = clip_size
        self.batch = batch
        self.dtype = dtype

    @torch.inference_mode()
    def run_batch(self, frames: torch.Tensor, idx: torch.Tensor, out_hw: tuple,
                  quantize_u8: bool, audio: torch.Tensor | None = None,
                  flip: torch.Tensor | None = None) -> torch.Tensor:
        """frames (N, H, W, 3) uint8 and idx (B, T) on the device [audio (B,
        L, 1) and flip (B,) bool, the warm-up rows] -> (B, out_h, out_w)
        blurred maps, f32 or uint8."""
        x = device_preprocess(frames[idx]).to(self.dtype)
        if audio is None:
            maps = self.model(x).float()
        else:
            audio = audio.to(self.dtype)
            audio = torch.where(flip[:, None, None], audio.flip(1), audio)
            maps = self.model(x, audio).float()
        if tuple(out_hw) != tuple(maps.shape[1:]):
            maps = resize_bilinear(maps, *out_hw)
        maps = gaussian_blur(maps, ksize=BLUR_KSIZE)
        return quantize_maps_u8(maps) if quantize_u8 else maps

    def predict_video(self, frames_u8: np.ndarray, *, out_size=None, pad_short=False,
                      audio_fn=None, quantize_u8=False):
        """frames_u8: (N, H, W, 3) uint8 model-sized frames. Yields
        (frame_index, map (out_h, out_w)) for every predictable frame; the map
        is float32, or uint8 with quantize_u8. audio_fn(start) -> (L, 1)
        float32: the excerpt of the window starting at that frame of the
        video, for AViNet."""
        n = frames_u8.shape[0]
        t = self.clip_size
        offset = 0
        if n < 2 * t - 1 and pad_short:
            pad = np.repeat(frames_u8[:1], 2 * t - 1 - n, axis=0)
            offset = pad.shape[0]
            frames_u8 = np.concatenate([pad, frames_u8], axis=0)
        plan = window_plan(frames_u8.shape[0], t)
        if not plan:
            return
        out_hw = tuple(out_size) if out_size is not None else frames_u8.shape[1:3]
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)

        pending = []  # (tasks, maps on the device)

        def flush():
            fetched = torch.cat([m for _, m in pending]).cpu().numpy()
            k = 0
            for tasks, m in pending:
                for j, task in enumerate(tasks):
                    if task.out_frame - offset >= 0:
                        yield task.out_frame - offset, fetched[k + j]
                k += m.shape[0]
            pending.clear()

        for lo in range(0, len(plan), self.batch):
            chunk = plan[lo: lo + self.batch]
            idx = np.zeros((self.batch, t), np.int64)  # padded rows: window at 0
            for j, task in enumerate(chunk):
                row = np.arange(task.start, task.start + t)
                idx[j] = row[::-1] if task.flipped else row
            idx_d = torch.from_numpy(idx).to(self.device)
            audio = flip = None
            if audio_fn is not None:
                exc = [audio_fn(max(0, task.start - offset)) for task in chunk]
                audio = np.zeros((self.batch, *exc[0].shape), np.float32)
                audio[: len(chunk)] = np.stack(exc)
                audio = torch.from_numpy(audio).to(self.device)
                flip = torch.tensor([task.flipped for task in chunk]
                                    + [False] * (self.batch - len(chunk)), device=self.device)
            pending.append((chunk, self.run_batch(frames, idx_d, out_hw, quantize_u8,
                                                  audio, flip)))
            if len(pending) >= FETCH_EVERY:
                yield from flush()
        if pending:
            yield from flush()
