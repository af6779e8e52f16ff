"""vinet_tpu_torch's spans (``utils/trace.py``): off without a profiler (the
shared no-op, no record, no ``record_function``, no CUDA event); on under
``torch.profiler``, the live, parity and train paths' spans in order, with
their request and counts, closed before every yield, and the maps unchanged;
the records bounded; ``enable_profiling`` writing the spans out. On the
CPU, small shapes: AViNet(3, 32) at 32 x 32 on two streams, ViNet(3, 8)."""

import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_port_util import INFER_AV_LIVE, TORCH_THREADS
from vinet_tpu_torch.data.audio import MAX_AUDIO_WIN
from vinet_tpu_torch.inference import AVMultiLiveServer, SlidingWindowPredictor
from vinet_tpu_torch.inference.engine import window_plan
from vinet_tpu_torch.models import AViNet, ViNet
from vinet_tpu_torch.utils import enable_profiling, trace

torch.set_num_threads(TORCH_THREADS)
HW, N, STREAMS, FPS, FS = 32, 64, 2, INFER_AV_LIVE["fps"], INFER_AV_LIVE["audio_fs"]
FEED = ["live.upload", "live.advance"]
WINDOWS = ["live.audio", "live.decode", "live.post", "live.fetch"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh_records():
    trace.clear()
    yield
    trace.clear()


def test_off_is_the_shared_noop(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    spans = [trace.span("live.upload", request=k, bytes=k) for k in range(100)]
    assert all(s is spans[0] for s in spans)
    with trace.span("train.forward", request=3) as attrs:
        assert attrs is None
    assert trace.records() == []


def test_on_records_nesting_and_bounded(monkeypatch):
    with _cpu_profile():
        with trace.span("outer", request=7, rows=4) as attrs:
            attrs["bytes"] = 12
            with trace.span("inner"):
                pass
    inner, outer = trace.records()  # a record is kept when its span closes
    assert (outer["name"], outer["request"], outer["parent"]) == ("outer", 7, None)
    assert outer["attrs"] == {"rows": 4, "bytes": 12} and outer["device_ms"] is None
    assert (inner["name"], inner["parent"]) == ("inner", "outer")
    assert outer["host_start_ns"] <= inner["host_start_ns"] <= inner["host_end_ns"] \
        <= outer["host_end_ns"]

    assert trace._records.maxlen == trace.MAX_RECORDS == 100_000
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=3))
    with _cpu_profile():
        for k in range(5):
            with trace.span("filler", request=k):
                pass
    assert [r["request"] for r in trace.records()] == [2, 3, 4]  # the oldest dropped


def _serve(model, frames, wavs, consumer_sleep=0.0):
    """Feed 16 frames a time with their samples, then flush; the maps and
    the host clock at each map the consumer took."""
    server = AVMultiLiveServer(model, streams=STREAMS, dtype=torch.float32, device="cpu",
                               **INFER_AV_LIVE)
    spf = FS / FPS
    maps, taken = {}, []

    def take(items):
        for s, f, m in items:
            taken.append(time.perf_counter_ns())
            maps[(s, f)] = np.array(m)
            time.sleep(consumer_sleep)

    for lo in range(0, N, 16):
        take(server.feed(frames[:, lo:lo + 16], audio=[w[int(lo * spf): int((lo + 16) * spf)]
                                                       for w in wavs]))
    take(server.flush())
    return maps, taken


def test_live_spans_in_order_with_counts_and_no_yield_inside():
    torch.manual_seed(0)
    model = AViNet(input_hw=(HW, HW))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (STREAMS, N, HW, HW, 3), dtype=np.uint8)
    wavs = [rng.standard_normal(int(N * FS / FPS)).astype(np.float32) for _ in range(STREAMS)]
    plain, _ = _serve(model, frames, wavs)
    assert trace.records() == []
    with _cpu_profile():
        traced, taken = _serve(model, frames, wavs, consumer_sleep=0.02)
    assert traced.keys() == plain.keys() and len(plain) == STREAMS * N
    assert all(np.array_equal(traced[k], plain[k]) for k in plain)

    recs = trace.records()
    feeds = sorted({r["request"] for r in recs})
    assert feeds == list(range(len(feeds))) and all(r["request"] is not None for r in recs)
    decoding = 0
    for k in feeds:
        names = [r["name"] for r in recs if r["request"] == k]
        rounds = (len(names) - 2) // 4
        assert names == FEED + WINDOWS * rounds, (k, names)
        decoding += rounds > 0
    assert decoding >= 3  # the warm-up feed and the flush's steady feeds
    batch = INFER_AV_LIVE["batch"]
    for r in recs:
        a = r["attrs"]
        if r["name"] == "live.upload":
            assert a["bytes"] == STREAMS * INFER_AV_LIVE["micro"] * HW * HW * 3
        elif r["name"] == "live.audio":
            assert a["bytes"] == STREAMS * batch * MAX_AUDIO_WIN * 4
            assert 0 < a["windows"] <= STREAMS * batch
        elif r["name"] == "live.decode":
            assert a["rows"] == STREAMS * batch and 0 < a["real_rows"] <= a["rows"]
    decodes = [r for r in recs if r["name"] == "live.decode"]
    fetches = [r for r in recs if r["name"] == "live.fetch"]
    assert [f["attrs"]["bytes"] for f in fetches] == [d["attrs"]["real_rows"] * HW * HW * 4
                                                      for d in decodes]
    assert sum(d["attrs"]["real_rows"] for d in decodes) == STREAMS * N
    # the consumer's 20 ms a map fall outside every span: none is open at a yield
    ends = np.array([(r["host_start_ns"], r["host_end_ns"]) for r in recs])
    for t in taken:
        assert not ((ends[:, 0] < t) & (t < ends[:, 1])).any()


def test_engine_and_train_spans():
    from vinet_tpu_torch.cli.train import to_device
    from vinet_tpu_torch.training.losses import LossConfig
    from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

    torch.manual_seed(0)
    model = ViNet(3, 8)
    rng = np.random.default_rng(1)
    video = rng.integers(0, 256, (20, HW, HW, 3), dtype=np.uint8)
    pred = SlidingWindowPredictor(model, clip_size=8, batch=4, dtype=torch.float32, device="cpu")
    with _cpu_profile():
        maps = [(f, m) for f, m in pred.predict_video(video)]
        [None for _ in pred.predict_video(video[:15])]
    assert len(maps) == 20
    recs = trace.records()
    names = [(r["name"], r["request"]) for r in recs]
    assert names[0] == ("engine.upload", 0)
    assert names.count(("engine.run_batch", 0)) == -(-len(window_plan(20, 8)) // 4)
    assert ("engine.fetch", 0) in names and ("engine.upload", 1) in names
    assert recs[0]["attrs"]["bytes"] == video.nbytes
    first_fetch = next(r for r in recs if r["name"] == "engine.fetch")
    assert first_fetch["attrs"]["bytes"] == 4 * 4 * HW * HW * 4  # FETCH_EVERY batches of 4
    assert all(r["attrs"]["rows"] == 4 for r in recs if r["name"] == "engine.run_batch")

    trace.clear()
    ts = init_train_state(model)
    step = make_train_step(LossConfig())
    host = {"clip": rng.integers(0, 256, (2, 8, HW, HW, 3), dtype=np.uint8),
            "gt": rng.random((2, HW, HW), dtype=np.float32)}
    with _cpu_profile():
        for _ in range(2):
            step(ts, to_device(host, "cpu"))
    got = [(r["name"], r["request"]) for r in trace.records()]
    assert got == [x for k in (0, 1) for x in (("train.upload", None), ("train.forward", k),
                                               ("train.backward", k), ("train.update", k))]
    assert trace.records()[0]["attrs"]["bytes"] == host["clip"].nbytes + host["gt"].nbytes


def test_enable_profiling_writes_the_spans(tmp_path):
    with enable_profiling(str(tmp_path)):
        with trace.span("engine.fetch", request=2, bytes=64):
            torch.relu(torch.randn(8, 8))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "engine.fetch" for e in events)
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert [(s["name"], s["request"], s["attrs"]) for s in spans] == [
        ("engine.fetch", 2, {"bytes": 64})]
