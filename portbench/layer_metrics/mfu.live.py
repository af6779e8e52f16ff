"""Share of the H100's bf16 dense peak while the server works: maps a
second of feed service (the window's maps over the summed time from each
feed's issue to its last map) times the least work a map costs on the live
path (``counts.live_flops_per_map``). Below the knee the maps a second of
wall time are the offered load; this share moves with the service time."""

from portbench import core, counts


def read(ctx):
    cfg = ctx["cell"].config
    return (100.0 * ctx["window"]["maps_per_service_s"] * counts.live_flops_per_map(cfg)
            / core.PEAK_FLOPS[cfg["dtype"]])
