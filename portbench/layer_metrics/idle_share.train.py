"""Share of the traced steps in which no kernel, copy or memset ran on the
device."""

from portbench import core


def read(ctx):
    busy, span = core.busy_within(ctx["trace"])
    return 100.0 * (1.0 - busy / span)
