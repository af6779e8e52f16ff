"""Reading the program's spans (``vinet_tpu_torch/utils/trace.py``) for the
per-layer metrics: the spans of a traced stretch as the profiler's trace has
them (``core.Trace.spans``, ``user_annotation`` ranges on the device's
clock), grouped into the ``portbench.feed`` ranges that contain them; the
device's idle time inside given spans (``core.busy_within``); and the
program's own records, whose ``device_ms`` is the stream's time from a
span's entry mark to its exit mark.

Every reader returns None when there is nothing to read: on the CPU (no
trace), or for a program without spans.
"""

from __future__ import annotations

import statistics

from portbench import core

FEED = "portbench.feed"


def ranges(trace: core.Trace, names) -> list:
    """(start, end) of the trace's spans named in names, in trace seconds."""
    return [(s, s + d) for name, s, d in trace.spans if name in names]


def per_feed(trace: core.Trace, names) -> list:
    """For each ``portbench.feed`` range, the (start, end) of the spans named
    in names that lie inside it; a span outside every feed is left out."""
    return [[(s, e) for s, e in ranges(trace, names) if fs <= s and e <= fe]
            for fs, fe in ranges(trace, {FEED})]


def feed_host_ms(ctx, names) -> float | None:
    """Median over the traced feeds of the host time a feed spends inside
    the spans named in names (ms)."""
    trace = ctx["trace"]
    if trace is None:
        return None
    feeds = [f for f in per_feed(trace, names) if f]
    if not feeds:
        return None
    return 1e3 * statistics.median(sum(e - s for s, e in f) for f in feeds)


def idle_share_within(ctx, names) -> float | None:
    """% of the feeds' service time in which the host was inside a span
    named in names and no kernel, copy or memset ran on the device."""
    trace = ctx["trace"]
    if trace is None:
        return None
    inside = core.merged([se for f in per_feed(trace, names) for se in f])
    if not inside:
        return None
    busy, total = core.busy_within(trace, inside)
    service = sum(e - s for s, e in ranges(trace, {FEED}))
    return 100.0 * (total - busy) / service


def host_ms(ctx, name: str) -> float | None:
    """Median host time of the traced stretch's spans named name (ms)."""
    trace = ctx["trace"]
    spans = [] if trace is None else ranges(trace, {name})
    return 1e3 * statistics.median(e - s for s, e in spans) if spans else None


def program_records() -> list:
    """The program's span records (``trace.records()``); none from a program
    without spans."""
    try:
        from vinet_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.records()


def device_ms(ctx, name: str, per_request: bool = True) -> float | None:
    """Median ``device_ms`` of the traced stretch's spans named name: the
    program's newest records of that name, as many as the trace holds; with
    per_request, summed per request (feed, video or step) first."""
    trace = ctx["trace"]
    n = 0 if trace is None else len(ranges(trace, {name}))
    if n == 0:
        return None
    recs = [r for r in program_records() if r["name"] == name][-n:]
    if not recs or any(r["device_ms"] is None for r in recs):
        return None
    if not per_request:
        return statistics.median(r["device_ms"] for r in recs)
    summed = {}
    for r in recs:
        summed[r["request"]] = summed.get(r["request"], 0.0) + r["device_ms"]
    return statistics.median(summed.values())
