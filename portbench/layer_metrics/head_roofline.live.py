"""The fused head kernel's share of its roofline in the traced feeds: its
least time for one decode (streams x batch windows,
``counts.head_bytes_flops``) over its mean device time a launch, found by
name in the trace. Nothing to read without a launch."""

from portbench import counts


def read(ctx):
    from vinet_tpu_torch.ops import saliency_head

    times = [d for name, _, d in ctx["trace"].kernels if "saliency_head" in name]
    if not times or saliency_head.launches == 0:
        return None
    tr = ctx["cell"].traffic
    least = counts.roofline_s(*counts.head_bytes_flops(ctx["cell"].config,
                                                       tr["streams"] * tr["batch"]))
    return 100.0 * least / (sum(times) / len(times))
