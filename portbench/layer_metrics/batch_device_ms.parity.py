"""Device time of one window batch (normalise, S3D, decoder, head, resize,
blur, u8): the median over the traced window batches of
``engine.run_batch``'s ``device_ms``, without the uploads and fetches that
``maps_per_s`` also pays."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "engine.run_batch", per_request=False)
