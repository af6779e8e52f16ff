"""Share of the feeds' service time (``portbench.feed``) in which the host
was inside ``live.upload`` or ``live.audio`` and no kernel, copy or memset
ran on the device: the part of ``idle_share.live`` that the input work
leaves."""

from portbench import spans


def read(ctx):
    return spans.idle_share_within(ctx, {"live.upload", "live.audio"})
