"""The metric arithmetic: a rate over all of the window's work and time, a
95th percentile over every map, open-loop due times that charge a stall to
every later map, and idle time counted only inside service intervals."""

import time
import types

import numpy as np
import pytest

from portbench import core
from portbench.drivers import live, parity


def test_p95_over_all_values():
    values = list(range(1, 101))
    assert core.p95(values) == pytest.approx(95.95)
    assert core.p95([3.0]) == 3.0


class SlowPredictor:
    """predict_video yielding one map a frame after a fixed wait a video."""

    def __init__(self, wait):
        self.wait = wait

    def predict_video(self, clip, **kw):
        time.sleep(self.wait)
        for i in range(clip.shape[0]):
            yield i, np.zeros((2, 2), np.uint8)


def test_parity_rate_counts_the_video_in_progress():
    st = parity.State()
    st.predictor = SlowPredictor(0.2)
    st.args = types.SimpleNamespace(live=False, exact_quantize=False, pad_short=False)
    st.out_hw = (2, 2)
    st.videos = [np.zeros((n, 1, 1, 3), np.uint8) for n in (10, 30)]
    st.kept = [set(), set()]
    cell = types.SimpleNamespace(seconds=0.3)
    t0 = time.perf_counter()
    win = parity.window(st, cell)
    elapsed = time.perf_counter() - t0
    assert win["maps"] == 40 and win["failed"] == 0  # the second video ran to its end
    assert win["window_s"] == pytest.approx(elapsed, abs=0.02)
    assert win["maps_per_s"] == pytest.approx(40 / win["window_s"])


class StallServer:
    """feed() yielding micro maps a stream; the first feed stalls."""

    def __init__(self, stall, streams=2, micro=4):
        self.stall, self.calls, self.streams, self.micro = stall, 0, streams, micro

    def feed(self, frames, audio=None):
        time.sleep(self.stall if self.calls == 0 else 0.001)
        base = self.calls * self.micro
        self.calls += 1
        for f in range(base, base + self.micro):
            for s in range(self.streams):
                yield s, f, np.zeros((2, 2), np.uint8)


def test_open_loop_charges_a_stall_to_later_maps():
    fps, micro, stall = 400.0, 4, 0.1  # a feed is due every 10 ms; the first takes 100
    st = live.State()
    st.server = StallServer(stall, micro=micro)
    st.video = np.zeros((2, 16, 1, 1, 3), np.uint8)
    st.wav = np.zeros((2, 10000), np.float32)
    st.spf, st.fed, st.kept, st.maps = 1, 0, set(), {}
    cell = types.SimpleNamespace(traffic={"micro": micro, "fps": fps, "period": 16})
    r = live.serve(st, cell, 6)
    period = micro / fps
    # feed k (k >= 1) is issued when feed 0 ends, about stall - k * period late
    for k in range(1, 6):
        assert r["late"][k] == pytest.approx(stall - k * period, abs=0.02)
    # every map of feed k counts from feed k's due time, so the stall shows in all
    lat = np.array(r["latencies"]).reshape(6, -1)
    assert (lat[1:].min(axis=1) >= np.array(r["late"][1:]) - 1e-3).all()
    assert core.p95(r["latencies"]) >= stall - 5 * period - 0.02
    assert r["maps"] == 6 * 2 * micro


def test_idle_only_inside_service_intervals():
    # device busy 0-1 and 1.5-2 s; service 0.5-1.5 s and a 3-4 s stretch idle
    trace = core.Trace(kernels=[("k", 0.0, 1.0), ("k", 1.5, 0.5)], host=[], window_s=4.0,
                       spans=[("portbench.feed", 0.5, 1.0), ("portbench.feed", 3.0, 1.0)])
    busy, total = core.busy_within(trace, [(s, s + d) for _, s, d in trace.spans])
    assert (busy, total) == (pytest.approx(0.5), pytest.approx(2.0))
    busy_all, span_all = core.busy_within(trace)
    assert (busy_all, span_all) == (pytest.approx(1.5), pytest.approx(4.0))
    ctx = {"trace": trace}
    assert core.layer_reader("idle_share.live")(ctx) == pytest.approx(75.0)


def test_breakdown_names_the_longest_gaps():
    trace = core.Trace(kernels=[("a", 0.0, 1.0), ("b", 3.0, 1.0), ("a", 4.5, 0.1)],
                       host=[("aten::wait", 0.9, 2.0)], window_s=5.0)
    bd = core.breakdown(trace)
    assert bd["device_ops"][0] == ["a", pytest.approx(1.1)]
    assert bd["idle_gaps"][0] == ["aten::wait", pytest.approx(2.0)]
