"""S3D's stem spatial convolution's share of its roofline in the traced
stretch: the least time of the stem's conv_s with its bias and ReLU for the
window batches that the ``engine.run_batch`` spans record (the bf16 clip
read once, the bf16 weights and bias once, the bf16 output written once, and
its operations; ``counts.roofline_s`` per batch) over the summed device time
of every kernel whose name holds ``stemconv`` (the stem kernel). Nothing to
read when the program has no such kernel, its launch counter or the trace
shows no launch, or no span records the batches."""

from portbench import counts, spans

BF16 = 2
CIN, COUT, TAPS = 3, 64, 7


def out_hw(h: int, w: int) -> tuple:
    """The stem's output grid: stride 2, padding 3, kernel 7."""
    return (h + 6 - TAPS) // 2 + 1, (w + 6 - TAPS) // 2 + 1


def window_bytes_flops(cfg: dict) -> tuple:
    """(bytes, FLOPs) of the stem's spatial convolution over one window:
    input and output once each, and 2 x taps x channels an output."""
    t, h, w = cfg["clip_size"], cfg["input_h"], cfg["input_w"]
    ho, wo = out_hw(h, w)
    outputs = COUT * t * ho * wo
    flops = counts.conv_flops(CIN, COUT, TAPS * TAPS, t * ho * wo)
    return BF16 * (CIN * t * h * w + outputs), flops


def least_s(cfg: dict, rows: int) -> float:
    """Least time of the stem's conv_s for a window batch of ``rows``
    windows; its weights and bias are read once a batch."""
    nbytes, flops = window_bytes_flops(cfg)
    weights = BF16 * (COUT * CIN * TAPS * TAPS + COUT)
    return counts.roofline_s(rows * nbytes + weights, rows * flops)


def read(ctx):
    try:
        from vinet_tpu_torch.ops import stemconv
    except ImportError:
        return None
    trace = ctx["trace"]
    if trace is None or stemconv.launches == 0:
        return None
    busy = sum(d for name, _, d in trace.kernels if "stemconv" in name)
    n = len(spans.ranges(trace, {"engine.run_batch"}))
    recs = [r for r in spans.program_records() if r["name"] == "engine.run_batch"][-n:] if n else []
    if busy == 0 or not recs:
        return None
    least = sum(least_s(ctx["cell"].config, r["attrs"]["rows"]) for r in recs)
    return 100.0 * least / busy
