"""Share of the H100's bf16 dense peak in the window: clips/s times three
times one window's forward operations (``counts.window_flops``; the
convention that a backward pass costs two forwards)."""

from portbench import core, counts


def read(ctx):
    cfg = ctx["cell"].config
    return (100.0 * ctx["window"]["train_clips_per_s"] * 3 * counts.window_flops(cfg)
            / core.PEAK_FLOPS[cfg["dtype"]])
