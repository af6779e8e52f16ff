"""Device time of a feed's window decodes (fusion, decoder, head): the
median over the traced feeds of the summed ``device_ms`` of the feed's
``live.decode`` spans."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "live.decode")
