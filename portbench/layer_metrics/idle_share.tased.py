"""Share of the traced stretch in which no kernel, copy or memset ran on the
device."""

from portbench import core


def read(ctx):
    if ctx["trace"] is None:
        return None
    busy, span = core.busy_within(ctx["trace"])
    return 100.0 * (1.0 - busy / span)
