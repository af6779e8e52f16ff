"""Share of the feeds' service time in which no kernel, copy or memset ran
on the device: only inside the ``portbench.feed`` ranges of the traced
feeds, so waiting for frames to arrive does not count as idle."""

from portbench import core


def read(ctx):
    trace = ctx["trace"]
    spans = [(s, s + d) for name, s, d in trace.spans if name == "portbench.feed"]
    if not spans:
        return None
    busy, total = core.busy_within(trace, spans)
    return 100.0 * (1.0 - busy / total)
