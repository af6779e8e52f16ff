"""Share of the H100's bf16 dense peak in the window: maps/s times one
TASEDv2 window's operations (``counts_tased.window_flops`` of the
configuration)."""

from portbench import core, counts_tased


def read(ctx):
    cfg = ctx["cell"].config
    return 100.0 * ctx["window"]["maps_per_s"] * counts_tased.window_flops(cfg) \
        / core.PEAK_FLOPS[cfg["dtype"]]
