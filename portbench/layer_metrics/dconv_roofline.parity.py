"""The decoder convolutions' share of their roofline in the traced stretch:
the least time of conv1-conv5 for the window batches that the
``engine.run_batch`` spans record (``counts.decoder_convs``' operations; the
inputs, weights and outputs in bf16, once each; ``counts.roofline_s`` per
conv and batch) over the summed device time of every kernel whose name holds
``dconv`` (the decoder-conv kernel and its channels-last copies). Nothing to
read when the program has no such kernel, its launch counter or the trace
shows no launch, or no span records the batches."""

from portbench import counts, spans

BF16 = 2
CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5")


def least_s(cfg: dict, rows: int) -> float:
    """Least time of conv1-conv5 for one window batch of ``rows`` windows.
    Each conv of the clip-32 plan has its temporal stride equal to its
    kernel, so it reads kt x (output positions) input positions."""
    total = 0.0
    for name, (f, n, ci, co, area, grid) in counts.decoder_convs(cfg["input_h"],
                                                                 cfg["input_w"]).items():
        if name not in CONVS:
            continue
        kt = f // counts.conv_flops(ci, co, area, grid)
        nbytes = BF16 * (rows * (ci * kt * n + co * n) * grid + co * ci * kt * area)
        total += counts.roofline_s(nbytes, rows * f * n)
    return total


def read(ctx):
    try:
        from vinet_tpu_torch.ops import dconv
    except ImportError:
        return None
    trace = ctx["trace"]
    if trace is None or dconv.launches == 0:
        return None
    busy = sum(d for name, _, d in trace.kernels if "dconv" in name)
    n = len(spans.ranges(trace, {"engine.run_batch"}))
    recs = [r for r in spans.program_records() if r["name"] == "engine.run_batch"][-n:] if n else []
    if busy == 0 or not recs:
        return None
    least = sum(least_s(ctx["cell"].config, r["attrs"]["rows"]) for r in recs)
    return 100.0 * least / busy
