"""S3D's max pools' share of their roofline in the traced stretch: the least
time of the backbone's fourteen pools for the window batches that the
``engine.run_batch`` spans record (each pool's input read and its output
written once, in bf16, with no index; ``counts.roofline_s`` per batch) over
the summed device time of every kernel whose name holds ``maxpool`` (the
index-free pool kernels; PyTorch's own pool is ``max_pool3d_with_indices``
and is not counted). Nothing to read when the program has no such kernel,
its launch counter or the trace shows no launch, or no span records the
batches."""

from portbench import counts, spans
from portbench.reference.models import MIXED_PLAN

BF16 = 2
SAME = ((3, 3, 3), (1, 1, 1), (1, 1, 1))  # a Mixed block's branch3 pool


def pools(t: int, h: int, w: int) -> list:
    """(channels, input (T, H, W), output (T, H, W)) of each S3D pool for a
    (t, h, w) clip, t, h and w even: the stem's convolutions halve all
    three, then the pools in the backbone's order."""
    out = []

    def pool(c, thw, kernel, stride, padding):
        o = tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(thw, kernel, stride, padding))
        out.append((c, thw, o))
        return o

    g = pool(64, (t // 2, h // 2, w // 2), (1, 3, 3), (1, 2, 2), (0, 1, 1))  # stem
    g = pool(192, g, (1, 3, 3), (1, 2, 2), (0, 1, 1))  # maxp2
    for name in ("3b", "3c"):
        pool(MIXED_PLAN[name][0], g, *SAME)
    g = pool(480, g, (3, 3, 3), (2, 2, 2), (1, 1, 1))  # maxp3
    for name in ("4b", "4c", "4d", "4e", "4f"):
        pool(MIXED_PLAN[name][0], g, *SAME)
    g = pool(832, g, (2, 1, 1), (2, 1, 1), (0, 0, 0))  # maxt4
    g = pool(832, g, (1, 2, 2), (1, 2, 2), (0, 0, 0))  # maxp4
    for name in ("5b", "5c"):
        pool(MIXED_PLAN[name][0], g, *SAME)
    return out


def window_bytes(cfg: dict) -> int:
    """Bytes the fourteen pools of one window move: inputs and outputs once."""
    vol = lambda thw: thw[0] * thw[1] * thw[2]  # noqa: E731
    return BF16 * sum(c * (vol(i) + vol(o))
                      for c, i, o in pools(cfg["clip_size"], cfg["input_h"], cfg["input_w"]))


def least_s(cfg: dict, rows: int) -> float:
    """Least time of the pools of a window batch of ``rows`` windows."""
    return counts.roofline_s(rows * window_bytes(cfg), 0)


def read(ctx):
    try:
        from vinet_tpu_torch.ops import maxpool
    except ImportError:
        return None
    trace = ctx["trace"]
    if trace is None or maxpool.launches == 0:
        return None
    busy = sum(d for name, _, d in trace.kernels if "maxpool" in name)
    n = len(spans.ranges(trace, {"engine.run_batch"}))
    recs = [r for r in spans.program_records() if r["name"] == "engine.run_batch"][-n:] if n else []
    if busy == 0 or not recs:
        return None
    least = sum(least_s(ctx["cell"].config, r["attrs"]["rows"]) for r in recs)
    return 100.0 * least / busy
