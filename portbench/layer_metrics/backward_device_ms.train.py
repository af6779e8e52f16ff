"""Device time of a train step's backward (the loss's backward): the
median over the traced steps of ``train.backward``'s ``device_ms``."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train.backward")
