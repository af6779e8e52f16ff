"""Live incremental streaming inference: frames are fed as they arrive and
every frame gets a map, with a constant lag and O(1) work per frame,
``vinet_tpu/inference/live.py`` in NCDHW.

The dense phase timelines of ``inference/streaming.py`` advance by
overlap-save: the backbone is cut into segments where ``streaming_pyramid``
splits phases; each segment keeps a tail of its own INPUT timeline (its
temporal receptive diameter) and, per microbatch of F frames, runs VALID in
time over [tail | new], producing exactly the new timeline positions. Maps
equal the chunked streaming maps away from stream boundaries.

The S3D temporal convs are centred, so a position is final only once its
future context exists: maps lag the input by a constant of the architecture
(about 57 frames) plus one microbatch. The stream start behaves as if
preceded by zero frames (the zero tails); ``flush`` drains the pipeline by
repeating the last frame. Warm-up frames (0..T-2, from time-flipped clips in
the reference) come from one flipped chunked-timeline pass once
``warmup_chunk`` frames have arrived.

All state carries ``streams`` streams in its batch axis, stream-major; the
single-stream predictor has one, ``inference/serving.py::MultiLiveServer``
several. Rolling buffers and tails live on the predictor's device.

``AVLiveStreamingPredictor`` serves AViNet: the visual timelines advance as
for ViNet (audio never reaches the backbone), and each stream's samples go
into a rolling host buffer from which every decoded window takes its excerpt,
equal to ``data/audio.py::audio_excerpt`` (reversed for the warm-up windows).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.data.audio import windowed_excerpt
from vinet_tpu_torch.data.pipeline import device_preprocess
from vinet_tpu_torch.inference.streaming import (MAXP3_DENSE, MAXT4_DENSE, AVStreamingPredictor,
                                                 StreamingPredictor, _split_time, valid_tconv)
from vinet_tpu_torch.models.layers import BasicConv3d, SepConv3d
from vinet_tpu_torch.models.s3d import InceptionBlock


def _valid_apply(mod: nn.Module, x: torch.Tensor):
    """Apply a module dense in time (temporal stride 1) with its temporal
    padding stripped: the output loses the module's temporal receptive
    radius at each end. Returns (y, radius), the radius in input positions.
    Inception branches have unequal radii, so their outputs are trimmed to
    the widest branch's before the channel concat."""
    if isinstance(mod, nn.Conv3d):
        pad = mod.padding
        y = F.conv3d(x, mod.weight, mod.bias, stride=(1, *mod.stride[1:]),
                     padding=(0, *pad[1:]))
        return y, pad[0]
    if isinstance(mod, nn.MaxPool3d):
        k, s, p = (v if isinstance(v, tuple) else (v,) * 3
                   for v in (mod.kernel_size, mod.stride, mod.padding))
        if not (k[0] == 1 or p[0] or k[0] == 2):
            raise ValueError(f"no valid temporal form for a max pool {k} with padding {p}")
        return F.max_pool3d(x, k, (1, *s[1:]), (0, *p[1:])), p[0]
    if isinstance(mod, BasicConv3d):
        y, r = _valid_apply(mod.conv, x)
        return torch.relu(mod.bn(y)), r
    if isinstance(mod, SepConv3d):
        y, rs = _valid_apply(mod.conv_s, x)
        y, rt = _valid_apply(mod.conv_t, torch.relu(mod.bn_s(y)))
        return torch.relu(mod.bn_t(y)), rs + rt
    if isinstance(mod, nn.Sequential):
        r = 0
        for layer in mod:
            x, ri = _valid_apply(layer, x)
            r += ri
        return x, r
    if isinstance(mod, InceptionBlock):
        outs = [_valid_apply(b, x) for b in (mod.branch0, mod.branch1, mod.branch2, mod.branch3)]
        rmax = max(r for _, r in outs)
        return torch.cat([y[:, :, rmax - r: y.shape[2] - (rmax - r)] for y, r in outs],
                         dim=1), rmax
    raise TypeError(f"_valid_apply: unhandled module {type(mod).__name__}")


# Tail lengths (input positions) of the segments, cut at streaming_pyramid's
# seams:
#   A : stem (SepConv3d k7)                r=3, input rate, then split /2
#   B : pool + 1x1 + sep192               r=1 at /2
#   C : maxpool + base2 (2 Mixed)         r=2 at /2
#   D1: maxp3 (3,3,3) dense-T             r=1 at /2, then split /4
#   D2: base3 (5 Mixed)                   r=5 at /4
#   E1: maxt4 (2,1,1) dense-T             k=2 valid (future 1), then split /8
#   E2: spatial pool + base4 (2 Mixed)    r=2 at /8
# Each is the receptive diameter, with one extra past slot on A and E1 so
# every split input block starts at an even timeline position.
_TAIL_A, _TAIL_B, _TAIL_C, _TAIL_D1, _TAIL_D2, _TAIL_E1, _TAIL_E2 = 7, 2, 4, 2, 10, 2, 4

# Newest global position per level after n input frames (zero-preceded
# stream); the dense-front series are VALID convs over the timelines:
#   c2y: y1 - 2    c3y/c4y: y2 - 4    c1u: y0
_NEWEST = {
    "y3": lambda n: n // 2 - 4,
    "y2": lambda n: n // 2 - 6,
    "y1": lambda n: n // 4 - 9,
    "y0": lambda n: n // 8 - 8,
}

# Aligned views: dropping these oldest slots re-bases every rolling buffer
# to input position n - span + 8 (a multiple of 8), the common origin the
# decode's phase algebra assumes.
_VIEW_OFF = {"y3": 7, "y2": 9, "y1": 10, "y0": 8, "c1u": 8, "c2y": 12, "c3y": 13, "c4y": 11}


class LiveStreamingPredictor(StreamingPredictor):
    """Stateful live server for one stream:

        live = LiveStreamingPredictor(model, micro=16)
        for frames in source:                  # (k, H, W, 3) uint8, any k
            for idx, smap in live.feed(frames): ...
        for idx, smap in live.flush(): ...     # drain the pipeline

    Maps come in input order with a constant lag (about 57 frames plus one
    microbatch), decoded on rolling timeline buffers by StreamingPredictor's
    decode."""

    streams = 1

    def __init__(self, model, *, clip_size: int = 32, batch: int = 16, micro: int = 16,
                 span: int = 160, dtype: torch.dtype = torch.bfloat16, device="cuda",
                 warmup_chunk: int | None = None):
        if micro % 8 or micro <= 0:
            raise ValueError(f"micro must be a positive multiple of 8, got {micro}")
        # the rolling buffers must cover the pipeline lag, one window and a
        # microbatch of emission slack
        if span % 8 or span < 96 + clip_size + 2 * micro:
            raise ValueError(f"span {span} must be a multiple of 8 and >= "
                             f"{96 + clip_size + 2 * micro}")
        super().__init__(model, clip_size=clip_size, batch=batch,
                         chunk=max(2 * clip_size, span), dtype=dtype, device=device)
        self.micro = micro
        self.span = span
        self.warmup_chunk = warmup_chunk or 2 * clip_size
        if self.warmup_chunk % 8 or self.warmup_chunk < 2 * clip_size - 1:
            raise ValueError(f"warmup_chunk must be a multiple of 8 and >= {2 * clip_size - 1}")
        # the oldest steady window (start 0) must still be on the buffers
        # when the warm-up pass ends
        if span < self.warmup_chunk + 8:
            raise ValueError(f"span {span} must be >= warmup_chunk + 8")
        bb = self.visual.backbone
        stem, pool1, b1x1, sep192 = bb.base1
        self._segments = {  # key: (module, tail length)
            "A": (stem, _TAIL_A), "B": (nn.Sequential(pool1, b1x1, sep192), _TAIL_B),
            "C": (nn.Sequential(bb.maxp2, *bb.base2), _TAIL_C), "D1": (MAXP3_DENSE, _TAIL_D1),
            "D2": (bb.base3, _TAIL_D2), "E1": (MAXT4_DENSE, _TAIL_E1), "E2": (bb.base4, _TAIL_E2)}
        self._out_size = None
        self._quantize_u8 = False
        self._reset()

    # ------------------------------------------------------------- state --
    def _reset(self):
        self._n_in = 0  # frames advanced into the timelines
        self._next_emit = 0  # next frame index to emit
        self._pending = []  # (S, H, W, 3) slabs not yet advanced
        self._early = []  # the first slabs, kept for the flipped warm-up
        self._warmed = False
        self._last_frame = None
        self._flushed_pad = 0
        self._tails = self._bufs = None

    def _init_state(self, h: int, w: int):
        s, span, d = self.streams, self.span, self.dtype
        z = lambda p, c, t, f: torch.zeros((s * p, c, t, h // f, w // f), dtype=d,
                                           device=self.device)
        self._tails = {"A": z(1, 3, _TAIL_A, 1), "B": z(2, 64, _TAIL_B, 2),
                       "C": z(2, 192, _TAIL_C, 4), "D1": z(2, 480, _TAIL_D1, 8),
                       "D2": z(4, 480, _TAIL_D2, 16), "E1": z(4, 832, _TAIL_E1, 16),
                       "E2": z(8, 832, _TAIL_E2, 32)}
        self._bufs = {"y3": z(2, 192, span // 2, 4), "y2": z(2, 480, span // 2, 8),
                      "y1": z(4, 832, span // 4, 16), "y0": z(8, 1024, span // 8, 32)}
        if self.v2:
            dec = self.visual.decoder
            self._bufs.update({
                "c2y": z(4, dec.convtsp2[0].out_channels, span // 4, 16),
                "c3y": z(2, dec.convtsp3[0].out_channels, span // 2, 8),
                "c4y": z(2, dec.convtsp4[0].out_channels, span // 2, 4)})
            if self.dense_conv1:
                self._bufs["c1u"] = z(8, dec.convtsp1[0].out_channels, span // 8, 16)

    # ----------------------------------------------------------- advance --
    def _seg(self, key: str, new: torch.Tensor, keep_oldest: int | None = None) -> torch.Tensor:
        """Overlap-save one segment: its new output positions; updates its
        tail. keep_oldest trims the extra positions an enlarged tail gives."""
        mod, length = self._segments[key]
        buf = torch.cat([self._tails[key], new.to(self.dtype)], dim=2)
        self._tails[key] = buf[:, :, -length:].contiguous()
        y, _ = _valid_apply(mod, buf)
        return y if keep_oldest is None else y[:, :, :keep_oldest]

    def _advance(self, frames_u8: torch.Tensor) -> None:
        """frames_u8 (S, F, H, W, 3) on the device -> F new input positions."""
        s, f = frames_u8.shape[:2]
        x = device_preprocess(frames_u8).to(self.dtype).permute(0, 4, 1, 2, 3).contiguous()
        a = _split_time(self._seg("A", x, keep_oldest=f), s)  # (2S, F/2)
        y3n = self._seg("B", a)
        y2n = self._seg("C", y3n)
        d1 = _split_time(self._seg("D1", y2n), s)  # (4S, F/4)
        y1n = self._seg("D2", d1)
        e1 = _split_time(self._seg("E1", y1n, keep_oldest=y1n.shape[2]), s)  # (8S, F/8)
        # the spatial maxp4 is pointwise in time: before E2's tail (4x smaller)
        y0n = self._seg("E2", self.visual.backbone.maxp4(e1))
        news = {"y3": y3n, "y2": y2n, "y1": y1n, "y0": y0n}
        if self.v2:
            news.update(self._dense_front_new(news))
        for k, new in news.items():  # shift in: a new tensor, never an overlapping copy
            self._bufs[k] = torch.cat([self._bufs[k][:, :, new.shape[2]:], new], dim=2)

    def _dense_front_new(self, news: dict) -> dict:
        """New dense-front positions: each series is a VALID temporal conv
        over its timeline, so its newest positions need the last kt-1
        buffered timeline positions and the new ones (read before the
        shift)."""
        dec = self.visual.decoder
        out = {"c1u": dec.convtsp1(news["y0"])} if self.dense_conv1 else {}
        for key, src, conv in (("c2y", "y1", dec.convtsp2[0]), ("c3y", "y2", dec.convtsp3[0]),
                               ("c4y", "y3", dec.convtsp4[0])):
            kt = conv.kernel_size[0]
            ext = torch.cat([self._bufs[src][:, :, -(kt - 1):], news[src]], dim=2)
            out[key] = valid_tconv(ext, conv.weight)
        return out

    # ------------------------------------------------------------ decode --
    def _views(self):
        v = {k: self._bufs[k][:, :, off:] for k, off in _VIEW_OFF.items() if k in self._bufs}
        timelines = (v["y0"], v["y1"], v["y2"], v["y3"])
        return timelines, ((v.get("c1u"), v["c2y"], v["c3y"], v["c4y"]) if self.v2 else None)

    def _emittable(self) -> int:
        """Frames (exclusive) decodable from the advanced timelines: frame i's
        window needs y0 up to (i-T+1)//8 + T//8 - 1, and so on."""
        t, n = self.clip_size, self._n_in
        lim = [rate * (_NEWEST[key](n) - span + 1) + t - 1 + (rate - 1)
               for key, span, rate in (("y0", t // 8, 8), ("y1", t // 4, 4),
                                       ("y2", t // 2, 2), ("y3", t // 2, 2))]
        if self.v2:  # c2y offsets reach (i-t+1)//4 + 5; c3y/c4y reach //2 + 11
            lim.append(4 * (_NEWEST["y1"](n) - 2 - 5) + t - 1 + 3)
            lim.append(2 * (_NEWEST["y2"](n) - 4 - 11) + t - 1 + 1)
            lim.append(2 * (_NEWEST["y3"](n) - 4 - 11) + t - 1 + 1)
        return max(0, min(lim) + 1)

    def _window_audio(self, starts: list, flipped: bool):
        """The windows' audio, for the window start frames of the streams
        (AVLiveStreamingPredictor); the visual model takes none."""
        return None

    def _emit(self, tl, dense, starts: list, frames: list, audio=None):
        """Decode one window batch of every stream; yields (stream, frame,
        map) for the real windows."""
        maps = self._decode(tl, dense, self._starts(starts), audio)
        maps = maps.reshape(self.streams, self.batch, *maps.shape[1:])[:, : len(frames)]
        out = self._post(maps.reshape(-1, *maps.shape[2:]), self._out_hw, self._quantize_u8)
        out = out.reshape(self.streams, len(frames), *out.shape[1:]).cpu().numpy()
        for j, f in enumerate(frames):
            for s in range(self.streams):
                yield s, f, out[s, j]

    def _decode_live(self, frames_emittable: int):
        t = self.clip_size
        while self._next_emit < frames_emittable:
            group = list(range(max(self._next_emit, t - 1),  # warm-up frames come from
                               min(frames_emittable, self._next_emit + self.batch)))
            if not group:  # the flipped pass
                self._next_emit = min(frames_emittable, t - 1)
                continue
            base_in = self._n_in - self.span + 8  # the views' origin
            starts = [g - t + 1 - base_in for g in group]
            if min(starts) < 0:
                raise RuntimeError(f"frame {group[0]}'s window fell off the rolling buffers: "
                                   "increase span or drain feed() faster")
            yield from self._emit(*self._views(), starts, group,
                                  self._window_audio([g - t + 1 for g in group], flipped=False))
            self._next_emit = group[-1] + 1

    def _emit_warmup(self):
        """Frames 0..T-2 of every stream from one flipped chunked-timeline
        pass over the first warmup_chunk frames."""
        t, wc = self.clip_size, self.warmup_chunk
        frames = self._upload(torch.from_numpy(np.stack(self._early[:wc], axis=1)))
        tl, dense = self._timeline(frames, flip=True)
        for lo in range(0, t - 1, self.batch):
            group = list(range(lo, min(t - 1, lo + self.batch)))
            yield from self._emit(tl, dense, [wc - t - f for f in group], group,
                                  self._window_audio(group, flipped=True))
        self._warmed = True
        self._early = []

    # -------------------------------------------------------------- feed --
    def reset(self):
        """Start a new stream (a new group of streams)."""
        self._reset()

    def start(self, out_size=None, quantize_u8=False):
        """Output geometry before feeding (default: the frame size)."""
        self._out_size = out_size
        self._quantize_u8 = quantize_u8

    @torch.inference_mode()
    def _feed(self, frames_u8: np.ndarray):
        """frames_u8 (S, k, H, W, 3) uint8; yields every (stream, frame, map)
        that became final."""
        if frames_u8.shape[1] == 0:
            return
        if self._tails is None:
            h, w = frames_u8.shape[2:4]
            self._out_hw = tuple(self._out_size or (h, w))
            self._init_state(h, w)
        slabs = list(np.moveaxis(np.asarray(frames_u8), 1, 0))  # k of (S, H, W, 3)
        self._last_frame = slabs[-1]
        self._pending.extend(slabs)
        if not self._warmed:
            self._early.extend(slabs[: max(0, self.warmup_chunk - len(self._early))])
        while len(self._pending) >= self.micro:
            chunk = np.stack(self._pending[: self.micro], axis=1)
            self._pending = self._pending[self.micro:]
            self._advance(self._upload(torch.from_numpy(chunk)))
            self._n_in += self.micro
        if not self._warmed and len(self._early) >= self.warmup_chunk:
            yield from self._emit_warmup()
        if self._warmed:
            yield from self._decode_live(min(self._emittable(), self._real_frame_count()))

    def _real_frame_count(self) -> int:
        return self._n_in + len(self._pending) - self._flushed_pad

    @torch.inference_mode()
    def _flush(self):
        """End of stream: repeat the last frame until every real frame is
        emitted; the last ~TEMPORAL_HALO frames see that repeated context."""
        if self._last_frame is None:
            return
        total = self._real_frame_count()
        if not self._warmed and self._early:  # a short stream: pad the warm-up chunk
            while len(self._early) < self.warmup_chunk:
                self._early.append(self._last_frame)
            if total >= 2 * self.clip_size - 1:
                yield from self._emit_warmup()
        while self._warmed and self._emittable() < total:
            self._flushed_pad += self.micro
            yield from self._feed(np.repeat(self._last_frame[:, None], self.micro, axis=1))
        if self._warmed:
            yield from self._decode_live(min(self._emittable(), total))

    def feed(self, frames_u8: np.ndarray):
        """Feed (k, H, W, 3) uint8 model-sized frames; yields every (frame,
        map) that became final."""
        frames_u8 = np.asarray(frames_u8)
        if frames_u8.ndim == 3:
            frames_u8 = frames_u8[None]
        for _, f, m in self._feed(frames_u8[None]):
            yield f, m

    def flush(self):
        """Drain the pipeline; yields the remaining (frame, map)."""
        for _, f, m in self._flush():
            yield f, m

    def predict_video(self, frames_u8, **kw):
        raise NotImplementedError(
            "LiveStreamingPredictor is a feed()/flush() server; use "
            "StreamingPredictor for stored videos")


class AVLiveStreamingPredictor(AVStreamingPredictor, LiveStreamingPredictor):
    """Live serving for AViNet (``vinet_tpu/inference/live.py:505-598``).
    Feed each stream's samples with its frames:

        live = AVLiveStreamingPredictor(model, fps=30.0, micro=16)
        for frames, samples in source:
            for idx, smap in live.feed(frames, audio=samples): ...
        for idx, smap in live.flush(): ...

    ``audio`` is the 1-D chunk of mono samples that arrived since the last
    feed, at ``audio_fs`` Hz and the reference's raw 2^-23 scale
    (``data/audio.py::load_wav_raw``). Frames and samples meet on the stream
    clock: frame f covers the samples around (f - 1) / fps · fs, as in
    ``frame_sample_ranges``. Maps lag the input by the pipeline's constant,
    so a window's excerpt is complete when it is decoded; a stream fed no
    audio gets zero excerpts, the reference's missing-wav behaviour. Samples
    no future window reads are dropped after each feed and each step of the
    flush; an excerpt that has fallen off the buffer raises."""

    def __init__(self, model, *, fps: float | None = None, audio_fs: int = 22050, **kw):
        if audio_fs <= 0:
            raise ValueError(f"audio_fs must be positive, got {audio_fs}")
        self.fps = float(fps) if fps else None
        self.audio_fs = int(audio_fs)
        super().__init__(model, **kw)

    def _reset(self):
        super()._reset()
        self._samples = [np.zeros((0,), np.float32) for _ in range(self.streams)]
        self._samples_base = [0] * self.streams  # global index of each buffer's first sample

    def start(self, out_size=None, quantize_u8=False, fps=None):
        super().start(out_size, quantize_u8)
        if fps:
            self.fps = float(fps)

    def _take_audio(self, audio) -> None:
        """audio: one 1-D chunk of samples per stream, or None."""
        if not self.fps:
            raise ValueError("set fps (constructor or start()) before feeding")
        if audio is None:
            return
        if len(audio) != self.streams:
            raise ValueError(f"{len(audio)} audio chunks for {self.streams} streams")
        for s, a in enumerate(audio):
            self._samples[s] = np.concatenate(
                [self._samples[s], np.asarray(a, np.float32).reshape(-1)])

    def feed(self, frames_u8: np.ndarray, audio=None):
        """Feed (k, H, W, 3) uint8 frames (k may be 0) and the samples that
        arrived with them; yields every (frame, map) that became final."""
        self._take_audio(None if audio is None else [audio])
        yield from LiveStreamingPredictor.feed(self, frames_u8)

    def _feed(self, frames_u8: np.ndarray):
        """The visual step, then the trim: after every feed and after every
        repeated-frame step of the flush, as JAX's server trims."""
        yield from super()._feed(frames_u8)
        self._trim_audio()

    def _trim_audio(self) -> None:
        """Drop the samples no future window reads: the oldest window still
        to emit starts at _next_emit - T + 1, less one frame of slack."""
        if not self._warmed:
            return  # the warm-up windows reach back to sample 0
        spf = self.audio_fs / self.fps
        lo = max(0, int((self._next_emit - self.clip_size) * spf - spf))
        for s in range(self.streams):
            drop = lo - self._samples_base[s]
            if drop > 0:
                self._samples[s] = self._samples[s][drop:]
                self._samples_base[s] = lo

    def _excerpt(self, s: int, start: int) -> np.ndarray:
        """Stream s's excerpt for the window starting at frame start:
        ``audio_excerpt`` over the rolling buffer, with the samples received
        so far as the end clamp. The float expressions are
        frame_sample_ranges', so int() truncates to the same sample."""
        fs, fps = self.audio_fs, self.fps
        spf = fs / fps
        base, samples = self._samples_base[s], self._samples[s]
        t0 = start * (1.0 / fps) * fs
        t1 = (start + self.clip_size - 1) * (1.0 / fps) * fs
        lo = int(max(0.0, t0 - spf / 2))
        hi = int(min(base + samples.shape[0], t1 + spf / 2))
        if lo < base:
            raise RuntimeError(f"stream {s}: the excerpt from sample {lo} fell off the rolling "
                               f"sample buffer (it starts at {base})")
        return windowed_excerpt(samples[lo - base: hi + 1 - base])

    def _window_audio(self, starts: list, flipped: bool) -> torch.Tensor:
        """(S·batch, 70560, 1) excerpts of every stream for the window start
        frames, reversed for the warm-up windows; padded rows are zeros."""
        exc = [[self._excerpt(s, st) for st in starts] for s in range(self.streams)]
        if flipped:
            exc = [[e[::-1] for e in row] for row in exc]
        return self._audio(exc)
