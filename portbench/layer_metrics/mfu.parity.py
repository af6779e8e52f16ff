"""Share of the H100's bf16 dense peak in the window: maps/s times one
window's operations (``counts.window_flops`` of the configuration)."""

from portbench import core, counts


def read(ctx):
    win = ctx["window"]
    flops = counts.window_flops(ctx["cell"].config)
    return 100.0 * win["maps_per_s"] * flops / core.PEAK_FLOPS[ctx["cell"].config["dtype"]]
