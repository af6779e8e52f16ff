"""Device time of a feed's advance (the backbone over the new frames and
the dense front): the median over the traced feeds of ``live.advance``'s
``device_ms``."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "live.advance")
