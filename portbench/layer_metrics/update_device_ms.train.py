"""Device time of a train step's update (the loss's mean over the data
group and the Adam update): the median over the traced steps of
``train.update``'s ``device_ms``."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "train.update")
