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
Maps come back FETCH_EVERY batches at a time; on a card a group's copy runs
into pinned memory while the next group is computed, and nothing between
(the index upload, the post ops' constants) waits for the device's queue.

With ``graphs`` on a card, the model's forward is a CUDA graph: captured at
the first window batch of each input shape, then replayed, so a window
batch costs the host a few launches instead of one for each of the model's
kernels. While a profiler records, the forward runs op by op, so spans and
launch counters see every layer; the kernels and their order are the same.
A replay launches what the capture recorded, and the counters count the
capture's calls, not the replays.

For AViNet, ``audio_fn(start)`` gives each window its (L, 1) excerpt: on the
device it is cast to the compute dtype and, for a warm-up window, reversed
along the samples next to its clip; padded batch rows get zero audio.

With a mesh (``parallel/mesh.py``) each window batch's rows are split over
the data group: every rank runs its rows through the model and the post
ops, and the rows are gathered, so ``predict_video`` yields every frame's
map on every rank, as the JAX package's data-parallel predictor does.
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
from vinet_tpu_torch.parallel.mesh import batch_slice, gather_batch
from vinet_tpu_torch.utils import trace

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


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """a on device; to a card from pinned memory without waiting, so the
    host keeps ahead of the queue (a pageable copy waits for it to drain)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _capture(model: torch.nn.Module, inputs: tuple) -> tuple:
    """(graph, static inputs, static output) of model(*inputs) captured as a
    CUDA graph, after one call on a side stream that sets up the libraries'
    plans and workspaces, as capture asks; then one call op by op on the
    current stream, whose memory stays cached for the forwards that run op
    by op under a profiler."""
    static = tuple(x.clone() for x in inputs)
    side = torch.cuda.Stream(static[0].device)
    side.wait_stream(torch.cuda.current_stream(static[0].device))
    with torch.cuda.stream(side):
        model(*static)
    torch.cuda.current_stream(static[0].device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = model(*static)
    model(*static)
    return graph, static, out


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
                 dtype: torch.dtype = torch.bfloat16, device="cuda", mesh=None,
                 graphs: bool = False):
        """model: a ViNet or AViNet with its weights loaded (or any module
        mapping (B, T, H, W, 3) clips [and (B, L, 1) audio] to (B, H, W)
        maps). The predictor prepares a
        copy of it (BatchNorms folded, cast to dtype, moved to device, eval
        mode) and leaves the caller's model as it is, as the JAX predictors
        leave (params, state). mesh: window batches are split over its data
        axis (the module's docstring); batch must be divisible by it.
        graphs: replay the forward as a CUDA graph on a card (the module's
        docstring); ignored elsewhere."""
        self.device = resolve_device(device)
        self.model = prepared_copy(model, dtype, self.device)
        self.clip_size = clip_size
        self.batch = batch
        self.dtype = dtype
        self.mesh = mesh
        self.rows = batch_slice(mesh, batch)  # this rank's rows of a window batch
        self.videos = 0  # predict_video calls begun; the spans' request is the current one
        self.graphs = {} if graphs and self.device.type == "cuda" else None  # by input shapes

    def _forward(self, *inputs):
        """self.model(*inputs), replayed from a CUDA graph where graphs are
        on and no profiler records. The graph's output is overwritten by its
        next replay, which the stream orders after every use of it here."""
        if self.graphs is None or trace.recording():
            return self.model(*inputs)
        key = tuple((x.shape, x.dtype) for x in inputs)
        if key not in self.graphs:
            self.graphs[key] = _capture(self.model, inputs)
        graph, static, out = self.graphs[key]
        for s, x in zip(static, inputs):
            s.copy_(x)
        graph.replay()
        return out

    @torch.inference_mode()
    def run_batch(self, frames: torch.Tensor, idx: torch.Tensor, out_hw: tuple,
                  quantize_u8: bool, audio: torch.Tensor | None = None,
                  flip: torch.Tensor | None = None) -> torch.Tensor:
        """frames (N, H, W, 3) uint8 and idx (B, T) on the device [audio (B,
        L, 1) and flip (B,) bool, the warm-up rows] -> (B, out_h, out_w)
        blurred maps, f32 or uint8."""
        with trace.span("engine.run_batch", request=self.videos - 1, rows=idx.shape[0]):
            x = device_preprocess(frames[idx]).to(self.dtype)
            if audio is None:
                maps = self._forward(x).float()
            else:
                audio = audio.to(self.dtype)
                audio = torch.where(flip[:, None, None], audio.flip(1), audio)
                maps = self._forward(x, audio).float()
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
        video = self.videos
        self.videos += 1
        with trace.span("engine.upload", request=video, bytes=frames_u8.nbytes):
            frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)

        pending = []  # (tasks, maps on the device) of the group being filled
        fetching = []  # (group, host maps, copy done) of the groups sent, oldest first

        def send():
            """Start the pending group's copy to the host: on a card into
            pinned memory without waiting, so the next group is queued
            before the host waits for this one."""
            maps = torch.cat([m for _, m in pending])
            done = None
            if self.device.type == "cuda":
                host = torch.empty(maps.shape, dtype=maps.dtype, pin_memory=True)
                host.copy_(maps, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = maps.cpu()
            fetching.append((list(pending), host, done))
            pending.clear()

        def deliver():
            group, host, done = fetching.pop(0)
            with trace.span("engine.fetch", request=video, bytes=host.nbytes):
                if done is not None:
                    done.synchronize()
                fetched = host.numpy()
            k = 0
            for tasks, m in group:
                for j, task in enumerate(tasks):
                    if task.out_frame - offset >= 0:
                        yield task.out_frame - offset, fetched[k + j]
                k += m.shape[0]

        for lo in range(0, len(plan), self.batch):
            chunk = plan[lo: lo + self.batch]
            idx = np.zeros((self.batch, t), np.int64)  # padded rows: window at 0
            for j, task in enumerate(chunk):
                row = np.arange(task.start, task.start + t)
                idx[j] = row[::-1] if task.flipped else row
            idx_d = _upload(idx, self.device)
            audio = flip = None
            if audio_fn is not None:
                exc = [audio_fn(max(0, task.start - offset)) for task in chunk]
                audio = np.zeros((self.batch, *exc[0].shape), np.float32)
                audio[: len(chunk)] = np.stack(exc)
                audio = torch.from_numpy(audio).to(self.device)
                flip = torch.tensor([task.flipped for task in chunk]
                                    + [False] * (self.batch - len(chunk)), device=self.device)
            r = self.rows
            maps = self.run_batch(frames, idx_d[r], out_hw, quantize_u8,
                                  None if audio is None else audio[r],
                                  None if flip is None else flip[r])
            pending.append((chunk, gather_batch(maps, self.mesh)))
            if len(pending) >= FETCH_EVERY:
                send()
                if len(fetching) > 1:
                    yield from deliver()
        if pending:
            send()
        while fetching:
            yield from deliver()
