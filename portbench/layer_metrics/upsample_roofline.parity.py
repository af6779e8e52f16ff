"""The decoder's ReLU and 2x upsample kernel's share of its roofline in the
traced stretch: the least time of the three stage upsamples (after conv1,
conv2 and conv3) for the window batches that the ``engine.run_batch`` spans
record (each bf16 input read once and each output, four times as large,
written once; ``counts.roofline_s`` per batch) over the summed device time of
every kernel whose name holds ``relu_up2x`` (PyTorch's own upsample is
``upsample_trilinear3d`` and is not counted). Nothing to read when the
program has no such kernel, its launch counter or the trace shows no launch,
or no span records the batches."""

from portbench import counts, spans

BF16 = 2


def stages(t: int, h: int, w: int) -> list:
    """(channels, T, H, W) of each stage upsample's input in ViNet(3, 32)'s
    decoder for a (t, h, w) clip: conv1 on S3D's deepest level (t / 8, h /
    32, w / 32), conv2 (kt 3, stride 3) over it beside the t / 4 frames of
    the next, conv3 (kt 5, stride 5) beside the t / 2 of the one after."""
    t1 = t // 8
    t2 = (t1 + t // 4 - 3) // 3 + 1
    t3 = (t2 + t // 2 - 5) // 5 + 1
    return [(832, t1, h // 32, w // 32), (480, t2, h // 16, w // 16), (192, t3, h // 8, w // 8)]


def window_bytes(cfg: dict) -> int:
    """Bytes the three upsamples of one window move: each input once, each
    output (4 times the input) once."""
    return BF16 * 5 * sum(c * t * h * w
                          for c, t, h, w in stages(cfg["clip_size"], cfg["input_h"],
                                                   cfg["input_w"]))


def least_s(cfg: dict, rows: int) -> float:
    """Least time of the stage upsamples of a window batch of ``rows``
    windows."""
    return counts.roofline_s(rows * window_bytes(cfg), 0)


def read(ctx):
    try:
        from vinet_tpu_torch.ops import upsample
    except ImportError:
        return None
    trace = ctx["trace"]
    if trace is None or getattr(upsample, "launches", 0) == 0:
        return None
    busy = sum(d for name, _, d in trace.kernels if "relu_up2x" in name)
    n = len(spans.ranges(trace, {"engine.run_batch"}))
    recs = [r for r in spans.program_records() if r["name"] == "engine.run_batch"][-n:] if n else []
    if busy == 0 or not recs:
        return None
    least = sum(least_s(ctx["cell"].config, r["attrs"]["rows"]) for r in recs)
    return 100.0 * least / busy
