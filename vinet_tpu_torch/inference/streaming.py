"""Streaming whole-video inference for ViNet and AViNet: the S3D backbone
runs once over the video timeline instead of once per sliding window,
``vinet_tpu/inference/streaming.py`` in NCDHW.

Every temporally strided op (the stem's conv_t s2, maxp3 s2, maxt4 s2) runs
DENSE (stride 1, ``models/s3d.py::run_in_time``) and its output is split
into even/odd phase timelines, folded into the batch axis; every other op is
unchanged, since on a phase timeline a window's temporal neighbours are the
timeline's neighbours. For a window starting at frame s each pyramid level
is a contiguous slice of one phase timeline:

    p1 = s % 2;  s1 = s // 2      y3/y2 <- timeline[p1][s1 : s1+16]
    p2 = s1 % 2; s2 = s1 // 2     y1    <- timeline[p2*2+p1][s2 : s2+8]
    p3 = s2 % 2; s3 = s2 // 2     y0    <- timeline[p3*4+p2*2+p1][s3 : s3+4]

Semantics differ from the parity mode at window edges: a window's features
see the real neighbouring frames, and zero padding only at chunk edges.

Timelines may carry S streams: their batch axis is (stream, phase),
stream-major, and ``_split_time`` keeps the phase split inside each stream,
so one backbone call and one decode serve S streams
(``inference/serving.py``). Every decode ends in the decoder's head, the
fused head kernel on the card (``ops/saliency_head.py``).

``AVStreamingPredictor`` shares the visual timelines the same way; audio
enters per window: SoundNet on the window's excerpt and the fusion into the
window's y0 (``AViNet.fuse``), so conv1 runs windowed on the fused y0 and the
dense front has no conv1 series. y1, y2 and y3 carry no audio, so their
dense series serve the AV decode as they are.

With a mesh the window batches' rows are split over the data group, as in
``inference/engine.py``; the timelines are computed on every rank.
``streaming_pyramid_tsharded`` splits a long chunk's time axis over the
data group instead, with a halo exchange between neighbouring ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vinet_tpu_torch.data.pipeline import device_preprocess
from vinet_tpu_torch.device import resolve_device
from vinet_tpu_torch.inference.engine import BLUR_KSIZE, FETCH_EVERY, prepared_copy
from vinet_tpu_torch.models.decoder import DECODER_PLANS, run_stage
from vinet_tpu_torch.models.s3d import run_in_time
from vinet_tpu_torch.ops import dconv
from vinet_tpu_torch.ops.image import gaussian_blur, quantize_maps_u8, resize_bilinear
from vinet_tpu_torch.ops.phasefold import FoldedConvUp2x
from vinet_tpu_torch.ops.upsample import relu_up2x
from vinet_tpu_torch.parallel.collectives import all_gather
from vinet_tpu_torch.parallel.mesh import batch_slice, gather_batch

# dense-mode temporal receptive radius of the S3D backbone in input frames,
# rounded up to the /8 phase alignment (vinet_tpu/inference/streaming.py)
TEMPORAL_HALO = 56


def _split_time(x: torch.Tensor, streams: int = 1) -> torch.Tensor:
    """(S·P, C, T, H, W) -> (S·2P, C, ceil(T/2), H, W): even/odd phase
    timelines, phase-major inside each stream (the new phase is the slowest
    axis of a stream's batch). An odd phase one short is zero-padded; that
    position is never gathered."""
    sp, c, t = x.shape[:3]
    rest = x.shape[3:]
    if t % 2 == 0:
        x2 = x.reshape(streams, sp // streams, c, t // 2, 2, *rest)
        x2 = x2.permute(0, 4, 1, 2, 3, *range(5, 5 + len(rest)))
        return x2.reshape(2 * sp, c, t // 2, *rest)
    even, odd = x[:, :, 0::2], x[:, :, 1::2]
    odd = F.pad(odd, (0, 0) * len(rest) + (0, even.shape[2] - odd.shape[2]))
    both = torch.stack([even.reshape(streams, sp // streams, *even.shape[1:]),
                        odd.reshape(streams, sp // streams, *odd.shape[1:])], dim=1)
    return both.reshape(2 * sp, *even.shape[1:])


def streaming_pyramid(backbone, x: torch.Tensor):
    """x (S, 3, N, H, W) normalised, N % 8 == 0 -> phase timelines
    (y0 (8S, 1024, N/8, h0, w0), y1 (4S, 832, N/4, ...), y2 (2S, 480, N/2,
    ...), y3 (2S, 192, N/2, ...)), stream-major.

    The backbone's stages on its own weights, with dense temporal strides and
    phase splits as the module docstring says."""
    s = x.shape[0]
    if x.shape[2] % 8:
        raise ValueError(f"timeline length must be a multiple of 8, got {x.shape[2]}")
    stem, pool, b1x1, sep192 = backbone.base1
    y = _split_time(run_in_time(stem, x, "dense")[0], s)  # (2S, 64, N/2, ...)
    y3 = sep192(b1x1(pool(y)))
    y2 = backbone.base2(backbone.maxp2(y3))
    y = _split_time(run_in_time(backbone.maxp3, y2, "dense")[0], s)  # (4S, 480, N/4, ...)
    y1 = backbone.base3(y)
    y = _split_time(run_in_time(backbone.maxt4, y1, "dense")[0], s)  # (8S, 832, N/8, ...)
    y0 = backbone.base4(backbone.maxp4(y))
    return y0, y1, y2, y3


def streaming_pyramid_tsharded(backbone, x: torch.Tensor, mesh, *,
                               halo: int = TEMPORAL_HALO):
    """The timeline pyramid of a long chunk with its time axis split over the
    mesh's data group, ``vinet_tpu/inference/streaming.py::
    streaming_pyramid_tsharded``: x (1, 3, N, H, W) normalised, the whole
    chunk on every rank -> the four phase timelines of ``streaming_pyramid``,
    the whole chunk's on every rank.

    Rank i of d runs frames [i·N/d, (i+1)·N/d): it sends its first and last
    halo frames to its neighbours and takes theirs (the JAX package's two
    ppermutes), runs ``streaming_pyramid`` on [left halo | segment | right
    halo] and keeps its segment's positions; the ranks' positions are then
    gathered along time. The first and last rank take zero frames for the
    halo beyond the chunk, so within each level's receptive radius of the
    chunk's two ends the timelines differ from ``streaming_pyramid``'s,
    which zero-pads every temporal conv at the chunk edge (the JAX
    package's documented semantics: y3 and y2 at their outermost 1-3
    positions); everywhere else they are equal."""
    group, d, i = mesh.groups["data"], mesh.shape["data"], mesh.coords[0]
    n = x.shape[2]
    seg = n // d
    if n % d or seg % 8:
        raise ValueError(f"a chunk of {n} frames does not split into {d} segments of a "
                         "multiple of 8 frames")
    if seg < halo:
        raise ValueError(f"per-device segment {seg} shorter than the halo {halo}: temporal "
                         f"sharding needs chunks >= {halo * d} frames on {d} devices (it is a "
                         "long-context extension)")
    if halo % 8:
        raise ValueError(f"halo {halo} is not a multiple of 8")
    mine = x[:, :, i * seg: (i + 1) * seg].contiguous()
    left = torch.zeros_like(mine[:, :, :halo])
    right = torch.zeros_like(mine[:, :, :halo])
    ops = []
    if i > 0:
        peer = dist.get_global_rank(group, i - 1)
        ops += [dist.P2POp(dist.isend, mine[:, :, :halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, left, peer, group)]
    if i < d - 1:
        peer = dist.get_global_rank(group, i + 1)
        ops += [dist.P2POp(dist.isend, mine[:, :, -halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, right, peer, group)]
    for req in dist.batch_isend_irecv(ops) if ops else []:
        req.wait()
    pyr = streaming_pyramid(backbone, torch.cat([left, mine, right], dim=2))
    return tuple(all_gather(y[:, :, halo // f: (halo + seg) // f].contiguous(), group, dim=2)
                 for y, f in zip(pyr, (8, 4, 2, 2)))


def _phases(starts: torch.Tensor):
    """Window starts -> (p1, s1, p2·2+p1, s2, p3·4+p2·2+p1, s3)."""
    p1, s1 = starts % 2, starts // 2
    p2, s2 = s1 % 2, s1 // 2
    p3, s3 = s2 % 2, s2 // 2
    return p1, s1, p2 * 2 + p1, s2, p3 * 4 + p2 * 2 + p1, s3


def _gather(t: torch.Tensor, phases: int, p: torch.Tensor, base: torch.Tensor, count: int,
            first: int = 0, step: int = 1) -> torch.Tensor:
    """Rows base + first + step·k (k < count) of phase p of each stream's
    timeline: t (S·phases, C, T, h, w), p and base (Bw,) -> (S·Bw, C, count,
    h, w), stream-major."""
    s = t.shape[0] // phases
    offs = first + step * torch.arange(count, device=base.device)
    tt = t.reshape(s, phases, *t.shape[1:]).transpose(2, 3)  # (S, P, T, C, h, w)
    g = tt[:, p[:, None], base[:, None] + offs[None, :]]  # (S, Bw, count, C, h, w)
    return g.transpose(2, 3).reshape(s * p.shape[0], t.shape[1], count, *t.shape[3:])


def gather_y0(y0t: torch.Tensor, starts: torch.Tensor, clip_size: int = 32) -> torch.Tensor:
    """The windows' y0 slices of the y0 timelines, batched (stream, window)."""
    *_, p0, s3 = _phases(starts)
    return _gather(y0t, 8, p0, s3, clip_size // 8)


def gather_windows(timelines, starts: torch.Tensor, clip_size: int = 32) -> list:
    """Per-window pyramid slices [y0, y1, y2, y3] of the phase timelines at
    the window starts (Bw,), batched (stream, window)."""
    y0t, y1t, y2t, y3t = timelines
    p1, s1, pb, s2, p0, s3 = _phases(starts)
    return [gather_y0(y0t, starts, clip_size),
            _gather(y1t, 4, pb, s2, clip_size // 4),
            _gather(y2t, 2, p1, s1, clip_size // 2),
            _gather(y3t, 2, p1, s1, clip_size // 2)]


def valid_tconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(kt, 3, 3) conv of x with weight w, VALID in T, spatial padding 1,
    through ``ops/dconv.py``'s route (the hand-written kernel for bf16 on
    the card)."""
    return dconv.conv3d(x, w, padding=1)


def dense_decoder_front(decoder, timelines, *, with_conv1: bool = True):
    """Per-chunk dense part of the plan-(3, 32) decode: the decoder's
    skip-window convs whose taps fall inside the skip, as VALID convs over
    the skip timelines, each timeline position computed once per chunk.

    Returns c1u = up2x(relu(conv1(y0t))) (None without with_conv1: AViNet
    fuses audio into each window's y0, so its conv1 runs windowed), c2y =
    VALID (3,3,3) conv of y1t, c3y and c4y = VALID (5,3,3) convs of y2t and
    y3t (pre-ReLU)."""
    y0t, y1t, y2t, y3t = timelines
    return (run_stage(decoder.convtsp1, y0t) if with_conv1 else None,
            valid_tconv(y1t, decoder.convtsp2[0].weight),
            valid_tconv(y2t, decoder.convtsp3[0].weight),
            valid_tconv(y3t, decoder.convtsp4[0].weight))


def fold_decoder(decoder) -> FoldedConvUp2x:
    """conv3's up-mixing taps (``w[:, :, 0:4]``), which read the
    2x-upsampled z2, folded with that upsample once per prepared decoder
    (for inference: no autograd graph)."""
    with torch.no_grad():
        return FoldedConvUp2x(decoder.convtsp3[0].weight[:, :, 0:4])


def decode_windows_v2(decoder, timelines, dense, starts: torch.Tensor,
                      fold3: FoldedConvUp2x | None = None,
                      y0_fused: torch.Tensor | None = None) -> torch.Tensor:
    """Windowed plan-(3, 32) decode on the dense front: only the positions
    that mix the upsampled deeper level into a window are computed per
    window; pure-skip positions are gathered from the dense series.

      conv2 over [z1 (4), y1 (8)], kt3 st3: t0 = z1[0:3], t1 = z1[3] + y1[0:2]
        (windowed), t2, t3 = c2y (dense)
      conv3 over [z2 (4), y2 (16)], kt5 st5: t0 = z2[0:4] + y2[0] (windowed),
        t1..t3 = c3y (dense); conv4 likewise over y3
      conv5 folded with its upsample, then the head (``Decoder.tail``).

    The up-mixing taps read the 2x-upsampled z2 and z3. conv3's run folded
    with that upsample, as in the JAX package; conv4's run on the upsampled
    z3, which on the H100 measured faster than its folded conv there
    (``PERF.md``), z3's ReLU and upsample through ``relu_up2x``. The
    decoder's convs carry no bias, so partial sums add exactly before each
    ReLU. fold3: ``fold_decoder(decoder)``, made here if not given.
    y0_fused: the windows' own y0 (S·Bw, 1024, 4, h0, w0), which conv1 then
    takes in place of the dense c1u (AViNet). Returns (S·Bw, H, W) maps in
    the timelines' dtype."""
    fold3 = fold_decoder(decoder) if fold3 is None else fold3
    _, y1t, y2t, y3t = timelines
    c1u, c2y, c3y, c4y = dense
    p1, s1, pb, s2, p0, s3 = _phases(starts)
    w2 = decoder.convtsp2[0].weight
    w3 = decoder.convtsp3[0].weight
    w4 = decoder.convtsp4[0].weight

    if y0_fused is None:
        z1 = _gather(c1u, 8, p0, s3, 4)
    else:
        z1 = run_stage(decoder.convtsp1, y0_fused)
    y1h = _gather(y1t, 4, pb, s2, 2)
    t0 = valid_tconv(z1[:, :, 0:3], w2[:, :, 0:3])
    t1 = valid_tconv(z1[:, :, 3:4], w2[:, :, 0:1]) + valid_tconv(y1h, w2[:, :, 1:3])
    t23 = _gather(c2y, 4, pb, s2, 2, first=2, step=3)  # rows 2, 5
    z2 = torch.relu(torch.cat([t0, t1, t23], dim=2))

    t0 = (fold3(z2)
          + valid_tconv(_gather(y2t, 2, p1, s1, 1), w3[:, :, 4:5]))
    t123 = _gather(c3y, 2, p1, s1, 3, first=1, step=5)  # rows 1, 6, 11
    z3 = torch.cat([t0, t123], dim=2)  # before its ReLU, which relu_up2x takes in

    t0 = (valid_tconv(relu_up2x(z3), w4[:, :, 0:4])
          + valid_tconv(_gather(y3t, 2, p1, s1, 1), w4[:, :, 4:5]))
    t123 = _gather(c4y, 2, p1, s1, 3, first=1, step=5)
    z4 = torch.relu(torch.cat([t0, t123], dim=2))
    return decoder.tail(z4)


class StreamingPredictor:
    """Streaming sliding-window inference for ViNet (visual only): the
    emission order and frame indices of ``SlidingWindowPredictor`` with
    --streaming semantics. Warm-up frames (time-flipped clips in the
    reference) run on the time-reversed first chunk: the flipped window for
    start s is the reversed chunk's window at chunk_len - clip_size - s."""

    dense_conv1 = True  # the dense front has conv1's series (not for AViNet)

    def __init__(self, model, *, clip_size: int = 32, batch: int = 16, chunk: int = 128,
                 dtype: torch.dtype = torch.bfloat16, device="cuda", mesh=None):
        """model: a ViNet (AViNet for AVStreamingPredictor) with its weights
        loaded. The predictor prepares a copy of it (BatchNorms folded, cast
        to dtype, moved to device, eval mode) and leaves the caller's model
        as it is. mesh: the decode's window batches are split over its data
        axis; batch must be divisible by it."""
        if chunk % 8 or chunk < 2 * clip_size:
            raise ValueError(f"chunk must be a multiple of 8 and >= {2 * clip_size}, got {chunk}")
        self.device = resolve_device(device)
        self.model = prepared_copy(model, dtype, self.device)
        self.clip_size = clip_size
        self.batch = batch
        self.mesh = mesh
        self.rows = batch_slice(mesh, batch)  # this rank's rows of a window batch
        self.chunk = chunk
        self.dtype = dtype
        self.v2 = clip_size == 32 and self.visual.decoder.plan == DECODER_PLANS[(3, 32)]
        self._fold3 = fold_decoder(self.visual.decoder) if self.v2 else None

    @property
    def visual(self):
        """The prepared model's ViNet: its backbone and decoder."""
        return self.model

    # --- the device functions (S streams in the batch axis) ---
    def _timeline(self, frames_u8: torch.Tensor, flip: bool):
        """frames_u8 (S, N, H, W, 3) uint8 on the device -> (timelines,
        dense front or None)."""
        x = device_preprocess(frames_u8).to(self.dtype).permute(0, 4, 1, 2, 3).contiguous()
        if flip:
            x = torch.flip(x, dims=[2])
        tl = streaming_pyramid(self.visual.backbone, x)
        dense = (dense_decoder_front(self.visual.decoder, tl, with_conv1=self.dense_conv1)
                 if self.v2 else None)
        return tl, dense

    def _decode(self, timelines, dense, starts: torch.Tensor, audio=None) -> torch.Tensor:
        """Window starts (Bw,) shared by the S streams -> (S·Bw, H, W) f32.
        audio: the windows' excerpts, which the visual model does not take
        (as in the JAX package, it is ignored)."""
        if self.v2:
            return decode_windows_v2(self.visual.decoder, timelines, dense, starts,
                                     self._fold3).float()
        return self.visual.decoder(gather_windows(timelines, starts, self.clip_size)).float()

    @staticmethod
    def _post(maps: torch.Tensor, out_hw: tuple, quantize_u8: bool) -> torch.Tensor:
        if tuple(out_hw) != tuple(maps.shape[1:]):
            maps = resize_bilinear(maps, *out_hw)
        maps = gaussian_blur(maps, ksize=BLUR_KSIZE)
        return quantize_maps_u8(maps) if quantize_u8 else maps

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device; from pinned memory on a card, so the
        copy does not wait for the work queued ahead of it."""
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _starts(self, starts: list) -> torch.Tensor:
        """A window batch's starts, padded to the batch with start 0."""
        return self._upload(torch.tensor(starts + [0] * (self.batch - len(starts))))

    def _audio(self, excerpts: list) -> torch.Tensor:
        """Each stream's list of (L, 1) excerpts -> (S·batch, L, 1) f32 on
        the device, stream-major, each stream's list padded with zero
        audio to the batch."""
        length = excerpts[0][0].shape[0]
        buf = np.zeros((len(excerpts), self.batch, length, 1), np.float32)
        for s, exc in enumerate(excerpts):
            if exc:
                buf[s, : len(exc)] = np.stack(exc)
        return self._upload(torch.from_numpy(buf.reshape(-1, length, 1)))

    @torch.inference_mode()
    def predict_video(self, frames_u8: np.ndarray, *, out_size=None, pad_short=False,
                      audio_fn=None, quantize_u8=False):
        """frames_u8 (N, H, W, 3) uint8 model-sized frames. Yields
        (frame_index, map) for every predictable frame in the reference's
        emission order (warm-up maps interleaved); maps are f32, or uint8
        with quantize_u8. audio_fn(start) -> (L, 1) float32: the excerpt of
        the window starting at that frame of the video (AViNet); warm-up
        windows get it reversed, as their clips are."""
        n = frames_u8.shape[0]
        t = self.clip_size
        if n < 2 * t - 1:
            if not pad_short:
                return
            pad = np.repeat(frames_u8[:1], 2 * t - 1 - n, axis=0)
            frames_u8 = np.concatenate([pad, frames_u8], axis=0)
        offset = frames_u8.shape[0] - n
        nn = frames_u8.shape[0]
        out_hw = tuple(out_size) if out_size is not None else frames_u8.shape[1:3]

        # the chunk shrinks (to a multiple of 8, >= 2t) for short videos
        chunk = max(2 * t, min(self.chunk, ((nn + 7) // 8) * 8))
        if nn < chunk:  # pad the tail by repeating the last frame; never emitted
            frames_u8 = np.concatenate(
                [frames_u8, np.repeat(frames_u8[-1:], chunk - nn, axis=0)], axis=0)

        plans = []  # (chunk_start, flipped, [(emit_frame, start_within_chunk)])
        warm = [(s - offset, chunk - t - s) for s in range(t - 1) if s - offset >= 0]
        if warm:
            plans.append((0, True, warm))
        starts = [(i - offset, i - t + 1) for i in range(t - 1, nn) if i - offset >= 0]
        c0 = 0
        while starts:
            hi = c0 + chunk - t  # window starts this chunk covers
            wins = [(f, s - c0) for f, s in starts if c0 <= s <= hi]
            if wins:
                plans.append((c0, False, wins))
            if hi >= nn - t:
                break
            c0 = min(hi + 1, max(frames_u8.shape[0] - chunk, 0))

        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        done = set()
        pending = []  # (frames, maps on the device), fetched every FETCH_EVERY

        def flush():
            fetched = torch.cat([m for _, m in pending]).cpu().numpy()
            k = 0
            for group, m in pending:
                for j, f in enumerate(group):
                    yield f, fetched[k + j]
                k += m.shape[0]
            pending.clear()

        for chunk_start, flipped, wins in plans:
            wins = [(f, s) for f, s in wins if f not in done]
            if not wins:
                continue
            tl, dense = self._timeline(frames[None, chunk_start: chunk_start + chunk], flipped)
            for lo in range(0, len(wins), self.batch):
                group = wins[lo: lo + self.batch]
                audio = None
                if audio_fn is not None:
                    # a warm-up window starts at the frame it emits, a
                    # normal one t - 1 frames before it
                    exc = [audio_fn(max(0, f if flipped else f - t + 1)) for f, _ in group]
                    audio = self._audio([[e[::-1] for e in exc] if flipped else exc])
                r = self.rows
                maps = self._decode(tl, dense, self._starts([s for _, s in group])[r],
                                    None if audio is None else audio[r])
                maps = gather_batch(self._post(maps, out_hw, quantize_u8), self.mesh)
                done.update(f for f, _ in group)
                pending.append(([f for f, _ in group], maps[: len(group)]))
                if len(pending) >= FETCH_EVERY:
                    yield from flush()
        if pending:
            yield from flush()


class AVStreamingPredictor(StreamingPredictor):
    """Streaming sliding-window inference for AViNet (bilinear fusion,
    ``vinet_tpu/inference/streaming.py::AVStreamingPredictor``): the visual
    timelines are shared by the overlapping windows as for ViNet; per window
    batch, the windows' y0 is gathered and fused with their audio
    (``AViNet.fuse``: SoundNet, the y0 max pool, the bilinear map and the
    optional encoder), and the decode runs on it, its pure-skip positions
    still from the dense front. Reference workload:
    generate_result_audio_visual's sliding windows."""

    dense_conv1 = False

    @property
    def visual(self):
        return self.model.visual_model

    def _decode(self, timelines, dense, starts: torch.Tensor, audio=None) -> torch.Tensor:
        """audio (S·Bw, L, 1): the windows' excerpts, stream-major."""
        if audio is None:
            raise ValueError("an AViNet decode needs the windows' audio")
        if self.v2:
            fused = self.model.fuse(gather_y0(timelines[0], starts, self.clip_size), audio)
            return decode_windows_v2(self.visual.decoder, timelines, dense, starts,
                                     self._fold3, y0_fused=fused).float()
        pyr = gather_windows(timelines, starts, self.clip_size)
        pyr[0] = self.model.fuse(pyr[0], audio)
        return self.visual.decoder(pyr).float()
