"""The fused head kernel's share of its roofline in the traced stretch: its
least time for a window batch (``counts.head_bytes_flops``) over its mean
device time a launch, found by name in the trace. Nothing to read when the
program's launch counter or the trace shows no launch."""

from portbench import counts


def read(ctx):
    from vinet_tpu_torch.ops import saliency_head

    trace = ctx["trace"]
    times = [d for name, _, d in trace.kernels if "saliency_head" in name]
    if not times or saliency_head.launches == 0:
        return None
    cfg = ctx["cell"].config
    least = counts.roofline_s(*counts.head_bytes_flops(cfg, ctx["cell"].traffic["window_batch"]))
    return 100.0 * least / (sum(times) / len(times))
