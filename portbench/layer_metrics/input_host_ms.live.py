"""Host time a feed spends making its inputs: the median over the traced
feeds of the time inside the feed's ``live.upload`` (the frames' stack and
upload) and ``live.audio`` (the windows' excerpts, their stack, pin and
upload) spans, while the device waits for the advance and the decode."""

from portbench import spans


def read(ctx):
    return spans.feed_host_ms(ctx, {"live.upload", "live.audio"})
