"""Device time of TASEDv2's decoder (``convtsp1`` ... ``convtsp4``) for one
window batch: the median over the traced window batches of the
``tased.decode`` spans' ``device_ms``. Nothing to read from a program
without that span."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "tased.decode", per_request=False)
