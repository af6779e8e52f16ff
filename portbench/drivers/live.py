"""Open-loop live serving of S camera streams with audio:
``inference/serving.py::AVMultiLiveServer`` (or ``MultiLiveServer`` for
ViNet), each stream at ``fps`` frames a second, ``micro`` frames and
micro * fs / fps samples a feed, every stream's feed due at once.

Traffic parameters (``traffic/<name>.json``): ``streams``, ``fps``,
``micro``, ``batch`` (the decode's windows a stream), ``warm_feeds`` (fed
as fast as they are served during set-up, past the flipped warm-up pass
into steady emission), ``trace_feeds`` (the traced stretch after the
window), ``period`` (frames a stream holds; its video repeats after
that), ``sample_maps``.

Feed k of the window is due at k * micro / fps seconds after the window
opens and is issued then, or when the previous feed is served if that is
later. A map's latency runs from its feed's due time to the moment
``feed`` yields it on the host; ``map_latency_p95_ms`` is the 95th
percentile over every map the window's feeds yield, of every stream. The
constant lag of the architecture (maps come out about 57 frames plus one
feed after their frame) is not in it.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from portbench import core, frames
from portbench.drivers.parity import check_sampled, compare
from portbench.reference.models import RefAViNet
from portbench.reference.post import normalise, post
from portbench.reference.weights import fixture_state_dict, seeded_leaves

CONTEXT = 64  # frames of real context the reference takes on each side of a window


class State:
    pass


def build_model(cell):
    """The program's AViNet with the fixture's visual weights and the
    audio-visual leaves drawn from the seed on the device, in f32."""
    from vinet_tpu_torch.models import AViNet

    cfg = cell.config
    model = AViNet(num_hier=cfg["num_hier"], clip_size=cfg["clip_size"],
                   input_hw=(cfg["input_h"], cfg["input_w"]))
    sd = {f"visual_model.{k}": v
          for k, v in fixture_state_dict(cfg["weights"], cfg["weights_sha256"]).items()}
    shapes = {k: v.shape for k, v in model.state_dict().items() if k not in sd}
    sd.update(seeded_leaves(shapes, cell.seed, cell.device))
    model.load_state_dict(sd, strict=True)
    return model, sd


def setup(cell) -> State:
    from vinet_tpu_torch.cli.generate_result import live_span
    from vinet_tpu_torch.inference.serving import AVMultiLiveServer

    cfg, tr = cell.config, cell.traffic
    st = State()
    model, st.weights = build_model(cell)
    s, micro = tr["streams"], tr["micro"]
    st.server = AVMultiLiveServer(model, streams=s, fps=tr["fps"], audio_fs=cfg["audio_fs"],
                                  micro=micro, batch=tr["batch"], clip_size=cfg["clip_size"],
                                  span=live_span(cfg["clip_size"], micro),
                                  dtype=getattr(torch, cfg["dtype"]), device=cell.device)
    st.server.start(out_size=(cfg["frame_h"], cfg["frame_w"]), quantize_u8=True)
    _inputs(st, cell, math.ceil(cell.seconds * tr["fps"] / micro))
    st.fed = 0
    st.emitted = 0
    for _ in range(tr["warm_feeds"]):
        for _, f, _ in feed(st, cell):
            st.emitted = max(st.emitted, f + 1)
    if cell.device != "cpu":
        torch.cuda.synchronize()
    st.kept = _draw(st, cell)
    return st


def _inputs(st: State, cell, n_window: int) -> None:
    """Each stream's frames (``period`` of them, repeated) and its audio for
    every feed of the run, made on the device from the seed."""
    cfg, tr = cell.config, cell.traffic
    st.spf = cfg["audio_fs"] // tr["fps"]
    if st.spf * tr["fps"] != cfg["audio_fs"] or tr["period"] % tr["micro"]:
        raise ValueError("audio_fs / fps and period / micro must be whole numbers")
    st.n_window = n_window
    feeds = tr["warm_feeds"] + n_window + tr["trace_feeds"] + CONTEXT // tr["micro"] + 2
    st.video = np.stack([frames.video(cell.seed, i, tr["period"], cfg["input_h"],
                                      cfg["input_w"], cell.device).cpu().numpy()
                         for i in range(tr["streams"])])
    st.wav = torch.stack([frames.audio(cell.seed, i, feeds * tr["micro"] * st.spf,
                                       cfg["audio_fs"], cell.device)
                          for i in range(tr["streams"])]).cpu().numpy()


def feed_inputs(st: State, cell, g: int) -> tuple:
    """Feed g's (S, micro, H, W, 3) frames and its S sample chunks."""
    micro, period = cell.traffic["micro"], cell.traffic["period"]
    lo = (g * micro) % period
    chunk = micro * st.spf
    return st.video[:, lo: lo + micro], list(st.wav[:, g * chunk: (g + 1) * chunk])


def feed(st: State, cell):
    frames_k, audio_k = feed_inputs(st, cell, st.fed)
    st.fed += 1
    yield from st.server.feed(frames_k, audio=audio_k)


def _draw(st: State, cell) -> set:
    """(stream, frame) pairs the check recomputes, drawn from the seed among
    the frames the window's feeds will emit, far enough from the window's
    end to be emitted in it."""
    micro = cell.traffic["micro"]
    lo, hi = st.emitted, st.emitted + micro * st.n_window - 2 * CONTEXT
    if lo - cell.config["clip_size"] + 1 < CONTEXT or hi <= lo:
        raise ValueError("warm_feeds too few or the window too short for the check")
    rng = frames.rng(cell.seed, 13)
    pairs = set()
    while len(pairs) < cell.traffic["sample_maps"]:
        pairs.add((int(rng.integers(0, cell.traffic["streams"])), int(rng.integers(lo, hi))))
    return pairs


def serve(st: State, cell, n_feeds: int, annotate: bool = False) -> dict:
    """Serve n_feeds feeds on the open-loop schedule; latencies and lateness."""
    micro, fps = cell.traffic["micro"], cell.traffic["fps"]
    lat, late, maps, busy = [], [], 0, 0.0
    t0 = time.perf_counter()
    for k in range(n_feeds):
        due = t0 + k * micro / fps
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        issued = time.perf_counter()
        late.append(issued - due)
        span = (torch.profiler.record_function("portbench.feed") if annotate
                else contextlib.nullcontext())
        with span:
            for s, f, m in feed(st, cell):
                lat.append(time.perf_counter() - due)
                maps += 1
                if (s, f) in st.kept:
                    st.maps[(s, f)] = np.array(m)
        busy += time.perf_counter() - issued
    elapsed = time.perf_counter() - t0
    return {"latencies": lat, "late": late, "maps": maps, "window_s": elapsed, "service_s": busy}


def window(st: State, cell) -> dict:
    st.maps = {}
    r = serve(st, cell, st.n_window)
    expected = cell.traffic["streams"] * cell.traffic["micro"] * st.n_window
    st.window_stats = r
    return {"map_latency_p95_ms": 1e3 * core.p95(r["latencies"]),
            "backlog_p95_ms": 1e3 * core.p95(r["late"]),
            "maps_per_s": r["maps"] / r["window_s"], "window_s": r["window_s"],
            "maps_per_service_s": r["maps"] / r["service_s"],
            "maps": r["maps"], "attempted": expected, "failed": expected - r["maps"]}


def traced_work(st: State, cell):
    """The next trace_feeds feeds on the same schedule, each feed's service
    marked by a ``portbench.feed`` range."""
    return lambda: serve(st, cell, cell.traffic["trace_feeds"], annotate=True)


def release(st: State) -> None:
    st.server = None


def reference_map(model, st: State, cell, s: int, f: int) -> torch.Tensor:
    """Frame f of stream s as the live path defines it: the window of frames
    f-31..f, its backbone features those of the stream (the S3D run over
    CONTEXT more frames on each side, cropped to the window's positions),
    fused with the window's excerpt, decoded; (h, w) f32."""
    cfg = cell.config
    t = cfg["clip_size"]
    start = f - t + 1
    idx = np.arange(start - CONTEXT, start + t + CONTEXT) % cell.traffic["period"]
    x = normalise(torch.from_numpy(st.video[s][idx]).to(cell.device))[None]
    y0, y1, y2, y3 = model.visual_model.backbone(x)
    c = CONTEXT
    y0, y1 = y0[:, :, c // 8: c // 8 + t // 8], y1[:, :, c // 4: c // 4 + t // 4]
    y2, y3 = y2[:, :, c // 2: c // 2 + t // 2], y3[:, :, c // 2: c // 2 + t // 2]
    audio = torch.from_numpy(excerpt(st.wav[s], start, t, cell.traffic["fps"],
                                     cfg["audio_fs"], cfg["audio_window"])).to(cell.device)
    return model.decode(model.fuse(y0, audio[None]), y1, y2, y3)[0]


def excerpt(wav: np.ndarray, start: int, t: int, fps: float, fs: int, n: int) -> np.ndarray:
    """The window's audio (the published get_audio_feature): the samples of
    frames start..start+t-1, each frame covering fs/fps samples around its
    time stamp, Hanning-windowed over their own length and centred in an
    n-sample buffer."""
    spf = fs / fps
    lo = int(max(0.0, start * (1.0 / fps) * fs - spf / 2))
    hi = int((start + t - 1) * (1.0 / fps) * fs + spf / 2)
    seg = wav[lo: hi + 1]
    buf = np.zeros(n, np.float32)
    m = min(seg.shape[0], n)
    off = n // 2 - m // 2
    buf[off: off + m] = seg[:m] * np.hanning(seg.shape[0])[:m].astype(np.float32)
    return buf


def reference_maps(st: State, cell, keys: list, quant: bool = False) -> dict:
    cfg = cell.config
    model = RefAViNet((4, cfg["input_h"] // 32, cfg["input_w"] // 32))
    model.load_state_dict({k: v.float() for k, v in st.weights.items()}, strict=True)
    model = model.eval().to(cell.device)
    model.quant.on = quant
    out = {}
    with torch.no_grad():
        for s, f in keys:
            m = reference_map(model, st, cell, s, f)
            out[(s, f)] = post(m[None], (cfg["frame_h"], cfg["frame_w"]))[0].cpu().numpy()
    return out


def check(st: State, cell, limits: dict) -> tuple:
    return check_sampled(st.maps, sorted(st.kept),
                         lambda keys: reference_maps(st, cell, keys), limits)


def control(cell, seeds: list, n_feeds: int) -> list:
    """Readings of the control, the reference with every convolution's and
    the bilinear map's input and weight rounded to int8 (``quant=True``), put
    in the program's place, against the f32 reference, on the maps a window
    of n_feeds feeds would check (the program has no int8 path for AViNet)."""
    inf = {"map_mean_abs_u8": float("inf"), "map_max_abs_u8": float("inf")}
    rows = []
    for seed in seeds:
        cell.seed = seed
        st = State()
        _, st.weights = build_model(cell)
        _inputs(st, cell, n_feeds)
        # the first frame the window emits after the warm feeds (the lag of
        # the architecture is about 57 frames plus one feed)
        st.emitted = cell.traffic["warm_feeds"] * cell.traffic["micro"] - 57 - cell.traffic["micro"]
        keys = sorted(_draw(st, cell))
        ref = reference_maps(st, cell, keys)
        ref_q = reference_maps(st, cell, keys, quant=True)
        rows.append({"seed": seed, "maps": len(keys),
                     "reference_int8": {k: v["value"]
                                        for k, v in compare(ref_q, ref, inf).items()}})
    return rows
