"""Operation and byte counts of TASEDv2 (the ``tased`` configuration), from
its shapes alone, with ``counts.py``'s conventions: a convolution counts 2 x
(multiply-adds) without its bias, as torch's FlopCounterMode counts it; a
transposed convolution counts every tap of every input position
(FlopCounterMode's count: 2 * C_in * C_out * kernel volume * input
positions, the taps that fall into the cropped border included). Pooling,
normalisation and elementwise ops count nothing. The CPU tests hold
``window_flops`` to FlopCounterMode over ``reference/tased.py::RefTASED``.
"""

from __future__ import annotations

from portbench import counts

BF16 = 2


def decoder_convs(h: int, w: int) -> list:
    """(name, C_in, C_out, kernel volume, input (T, H, W), output (T, H, W),
    transposed) of each of the decoder's ten convolutions for a clip-32
    window at h x w (h and w multiples of 32), in order."""
    g = lambda f: (h // f, w // f)  # noqa: E731
    t = 4  # y0's time positions
    return [
        ("convtsp1.0", 1024, 1024, 1, (t, *g(32)), (t, *g(32)), False),
        ("convtsp1.3", 1024, 832, 16, (t, *g(32)), (t, *g(16)), True),
        ("convtsp2.0", 832, 480, 16, (t, *g(16)), (t, *g(8)), True),
        ("convtsp3.0", 480, 192, 16, (t, *g(8)), (t, *g(4)), True),
        ("convtsp4.0", 192, 64, 16, (t, *g(4)), (t, *g(2)), True),
        ("convtsp4.3", 64, 64, 2, (t, *g(2)), (t // 2, *g(2)), False),
        ("convtsp4.6", 64, 4, 1, (t // 2, *g(2)), (t // 2, *g(2)), True),
        ("convtsp4.9", 4, 4, 2, (t // 2, *g(2)), (1, *g(2)), False),
        ("convtsp4.12", 4, 4, 16, (1, *g(2)), (1, h, w), True),
        ("convtsp4.13", 4, 1, 1, (1, h, w), (1, h, w), False),
    ]


def _vol(thw: tuple) -> int:
    return thw[0] * thw[1] * thw[2]


def conv_flops(cin: int, cout: int, kvol: int, thw_in: tuple, thw_out: tuple,
               transposed: bool) -> int:
    return counts.conv_flops(cin, cout, kvol, _vol(thw_in if transposed else thw_out))


def decoder_flops(h: int, w: int) -> int:
    """One window's decoder operations."""
    return sum(conv_flops(*c[1:]) for c in decoder_convs(h, w))


def window_flops(cfg: dict) -> int:
    """One window's forward: S3D (``counts.backbone_layers``) and the
    decoder."""
    t, h, w = cfg["clip_size"], cfg["input_h"], cfg["input_w"]
    return sum(f * n for f, n in counts.backbone_layers(t, h, w)) + decoder_flops(h, w)


def decoder_least_s(cfg: dict, rows: int) -> float:
    """The decoder's least time for a window batch of ``rows`` windows: for
    each convolution the larger of its operations over the bf16 peak and its
    bytes (bf16 input and output once a window, bf16 weight once a batch)
    over the HBM rate (``counts.roofline_s``), summed."""
    total = 0.0
    for _, cin, cout, kvol, ti, to, tr in decoder_convs(cfg["input_h"], cfg["input_w"]):
        nbytes = BF16 * (rows * (cin * _vol(ti) + cout * _vol(to)) + cin * cout * kvol)
        total += counts.roofline_s(nbytes, rows * conv_flops(cin, cout, kvol, ti, to, tr))
    return total
