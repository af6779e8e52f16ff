"""Device time of a train step's forward (the autocast forward and the
loss): the median over the traced steps of ``train.forward``'s
``device_ms``."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train.forward")
