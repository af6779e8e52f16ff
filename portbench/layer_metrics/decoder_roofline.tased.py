"""TASEDv2's decoder's share of its roofline in the traced stretch: its
least time for the window batches of the traced ``tased.decode`` spans
(``counts_tased.decoder_least_s`` for each span's ``rows``: per convolution
the larger of its operations over the bf16 peak and its bytes, bf16 input,
weight and output each once, over the HBM rate) over those spans' device
time.

The device time is each span's ``device_ms`` (the stream's time from the
span's entry mark to its exit mark), summed. The profiler's span ranges are
host ranges, and in this closed loop the host enqueues a window batch's
decoder while the device still runs its S3D, so the kernels that lie inside
a host range are not the decoder's; the stream's marks bracket exactly the
decoder's kernels, which run back to back behind the queued S3D.

Nothing to read when the program has no folded decoder route or its counter
(``models/tased.py::folded_calls``) is 0, or no span records the batches."""

from portbench import counts_tased, spans

SPAN = "tased.decode"


def read(ctx):
    try:
        from vinet_tpu_torch.models import tased
    except ImportError:
        return None
    trace = ctx["trace"]
    if trace is None or getattr(tased, "folded_calls", 0) == 0:
        return None
    n = len(spans.ranges(trace, {SPAN}))
    recs = [r for r in spans.program_records() if r["name"] == SPAN][-n:] if n else []
    if not recs or any(r["device_ms"] is None for r in recs):
        return None
    busy = 1e-3 * sum(r["device_ms"] for r in recs)
    least = sum(counts_tased.decoder_least_s(ctx["cell"].config, r["attrs"]["rows"])
                for r in recs)
    return 100.0 * least / busy if busy > 0 else None
