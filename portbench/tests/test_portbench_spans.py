"""The span readers' arithmetic (``portbench/spans.py``) on a synthetic
trace: input spans grouped by the feed that contains them, idle counted only
inside feeds and under the input spans, medians taken per feed, the
program's records matched to the trace's spans, and None where there is
nothing to read."""

import pytest

from portbench import core, spans

# two feeds, 0-1 s and 2-3 s; the device busy 0.3-1.0 and 2.0-2.4 s
FEEDS = [("portbench.feed", 0.0, 1.0), ("portbench.feed", 2.0, 1.0)]
KERNELS = [("k", 0.3, 0.7), ("k", 2.0, 0.4)]
INPUTS = [("live.upload", 0.0, 0.1), ("live.audio", 0.2, 0.2),  # feed 0: 0.3 s, 0.2 idle
          ("live.upload", 2.0, 0.05),  # feed 1: 0.05 s, busy
          ("live.upload", 1.5, 0.3)]  # between the feeds: ignored
INPUT_NAMES = {"live.upload", "live.audio"}


def _trace(extra=()):
    return core.Trace(kernels=KERNELS, host=[], window_s=3.0,
                      spans=FEEDS + INPUTS + list(extra))


def test_input_spans_group_by_feed_and_ignore_the_rest():
    got = spans.per_feed(_trace(), INPUT_NAMES)
    assert got == [[(0.0, pytest.approx(0.1)), (0.2, pytest.approx(0.4))],
                   [(2.0, pytest.approx(2.05))]]


def test_idle_only_inside_feeds_and_under_the_input_spans():
    # idle under the inputs: 0.0-0.1 and 0.2-0.3 of feed 0; feed 1's upload is
    # busy; the 1.5-1.8 s upload lies outside both feeds. Service: 2 s.
    ctx = {"trace": _trace()}
    assert spans.idle_share_within(ctx, INPUT_NAMES) == pytest.approx(100 * 0.2 / 2.0)
    assert core.layer_reader("idle_in_input_share.live")(ctx) == pytest.approx(10.0)


def test_medians_per_feed():
    third = [("portbench.feed", 4.0, 1.0), ("live.upload", 4.0, 0.1),
             ("live.audio", 4.5, 0.1)]
    ctx = {"trace": _trace(third)}
    # per feed 300, 50 and 200 ms: the median feed, not the median span (100)
    assert spans.feed_host_ms(ctx, INPUT_NAMES) == pytest.approx(200.0)
    assert core.layer_reader("input_host_ms.live")(ctx) == pytest.approx(200.0)


def _records(name, device_ms, requests):
    return [{"name": name, "request": r, "device_ms": d} for r, d in zip(requests, device_ms)]


def test_device_ms_reads_the_newest_records_the_trace_holds(monkeypatch):
    decodes = [("live.decode", 0.1 * k, 0.01) for k in range(4)]
    ctx = {"trace": _trace(decodes)}
    # an older record first, then four: two feeds of two decodes each
    recs = _records("live.decode", [99.0, 1.0, 2.0, 5.0, 7.0], [0, 1, 1, 2, 2])
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    assert spans.device_ms(ctx, "live.decode") == pytest.approx((3.0 + 12.0) / 2)
    assert core.layer_reader("decode_device_ms.live")(ctx) == pytest.approx(7.5)
    assert spans.device_ms(ctx, "live.decode", per_request=False) == pytest.approx(3.5)


def test_nothing_to_read_is_none(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: [])
    none = {"trace": None}
    bare = {"trace": core.Trace(kernels=KERNELS, host=[], window_s=3.0, spans=FEEDS)}
    for name in ("input_host_ms.live", "idle_in_input_share.live", "advance_device_ms.live",
                 "decode_device_ms.live", "batch_device_ms.parity", "upload_ms.train",
                 "forward_device_ms.train", "backward_device_ms.train",
                 "update_device_ms.train"):
        read = core.layer_reader(name)
        assert read(none) is None and read(bare) is None, name
    # spans in the trace but no records (or records without a device time)
    ctx = {"trace": _trace([("train.forward", 0.0, 0.1)])}
    assert spans.device_ms(ctx, "train.forward") is None
    monkeypatch.setattr(spans, "program_records",
                        lambda: _records("train.forward", [None], [0]))
    assert spans.device_ms(ctx, "train.forward") is None
