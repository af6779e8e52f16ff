"""Spans: named ranges at the layer boundaries of the port's paths, on the
profiler's clock.

    from vinet_tpu_torch.utils import trace

    with trace.span("live.upload", request=feed, bytes=chunk.nbytes):
        ...
    trace.records()  # [{"name", "request", "parent", "host_start_ns", ...}]

A span is on only while a ``torch.profiler`` records (``enable_profiling``,
or any other profiler): the profiler is the switch, and there is no other.
Off, ``span`` returns one shared no-op context manager: it allocates
nothing, makes no CUDA call and keeps no record. On, a span

- enters ``torch.profiler.record_function(name)``, so it is a
  ``user_annotation`` range in the profiler's trace, on the clock of the
  device's kernels;
- takes ``time.perf_counter_ns()`` at entry and at exit;
- where CUDA is initialised, records a ``torch.cuda.Event`` at entry and at
  exit on the current stream, without synchronising;
- appends a record: the name, ``request`` (the feed, video or step the
  span's work belongs to), the enclosing span's name (``parent``), the host
  times, ``attrs`` (counts at the boundary: ``bytes``, ``rows``, ...) and the
  events. The newest ``MAX_RECORDS`` are kept.

The span sites keep three rules: no span synchronises the device, no span
stays open across a ``yield`` (the consumer's time is never a span's), and
no span sits in a loop over windows, excerpts or maps.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

MAX_RECORDS = 100_000

_OFF = contextlib.nullcontext()
_records = collections.deque(maxlen=MAX_RECORDS)
_stack = []  # names of the open spans, innermost last


class _Span:
    __slots__ = ("name", "request", "attrs", "parent", "start", "events", "_range")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.name)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        _stack.pop()
        _records.append({"name": self.name, "request": self.request, "parent": self.parent,
                         "host_start_ns": self.start, "host_end_ns": end, "attrs": self.attrs,
                         "events": self.events})


def span(name: str, request=None, **attrs):
    """A context manager marking one span: the shared no-op unless a
    profiler records (the module's docstring). ``with span(...) as attrs``:
    the record's attrs, for a count known only inside the span; None when
    off."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request, attrs)


def records() -> list:
    """The kept records, oldest first, each with ``device_ms``: the current
    stream's time from reaching the span's entry mark to reaching its exit
    mark, gaps included (None where CUDA was not initialised). Resolving it
    waits for the exit mark; it is done here, never when the span closes."""
    out = []
    for rec in list(_records):
        events = rec.pop("events", None)
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
        rec.setdefault("device_ms", None)
        out.append(dict(rec))
    return out


def clear() -> None:
    """Drop every record."""
    _records.clear()
