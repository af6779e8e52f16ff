"""Operation and byte counts of the benchmark, from the configuration's shapes
alone: whatever kernels the program launches, the count reads the same work.

A convolution counts 2 x (multiply-adds): 2 * C_out * C_in * kernel volume
* output positions, without its bias, as torch's FlopCounterMode counts it
(the CPU tests hold ``window_flops`` to FlopCounterMode over the plain
reference). Pooling, normalisation and elementwise ops count nothing.
"""

from __future__ import annotations

from portbench.reference.models import MIXED_PLAN, SOUNDNET_PLAN


def conv_flops(cin: int, cout: int, kvol: int, positions: int) -> int:
    return 2 * cin * cout * kvol * positions


def _mixed(name: str, pos: int) -> int:
    i, b0, b1r, b1, b2r, b2, b3 = MIXED_PLAN[name]
    return (conv_flops(i, b0, 1, pos) + conv_flops(i, b1r, 1, pos) + conv_flops(b1r, b1, 9, pos)
            + conv_flops(b1, b1, 3, pos) + conv_flops(i, b2r, 1, pos)
            + conv_flops(b2r, b2, 9, pos) + conv_flops(b2, b2, 3, pos)
            + conv_flops(i, b3, 1, pos))


def backbone_layers(t: int, h: int, w: int) -> list:
    """(FLOPs per output time position, output time positions) of each
    backbone stage for a (t, h, w) clip; t a multiple of 8, h and w of 32."""
    s1 = (h // 2) * (w // 2)  # the stem's conv_s and conv_t output grid
    s4 = (h // 4) * (w // 4)
    s8, s16, s32 = (h // 8) * (w // 8), (h // 16) * (w // 16), (h // 32) * (w // 32)
    return [
        (conv_flops(3, 64, 49, s1), t),  # stem conv_s, stride 1 in time
        (conv_flops(64, 64, 7, s1), t // 2),  # stem conv_t, stride 2
        (conv_flops(64, 64, 1, s4) + conv_flops(64, 192, 9, s4) + conv_flops(192, 192, 3, s4),
         t // 2),  # 1x1 and sep192 (y3)
        (_mixed("3b", s8) + _mixed("3c", s8), t // 2),  # base2 (y2)
        (sum(_mixed(n, s16) for n in ("4b", "4c", "4d", "4e", "4f")), t // 4),  # base3 (y1)
        (_mixed("5b", s32) + _mixed("5c", s32), t // 8),  # base4 (y0)
    ]


def decoder_convs(h: int, w: int) -> dict:
    """Decoder conv -> (FLOPs of one output time position, output positions
    a window, C_in, C_out, kernel area, output grid) at the clip-32 plan."""
    g = lambda f: (h // f) * (w // f)  # noqa: E731
    plan = {"conv1": (1024, 832, 1, 9, g(32), 4), "conv2": (832, 480, 3, 9, g(16), 4),
            "conv3": (480, 192, 5, 9, g(8), 4), "conv4": (192, 64, 5, 9, g(4), 4),
            "conv5": (64, 32, 2, 9, g(2), 2), "conv6": (32, 32, 2, 1, g(1), 1),
            "conv7": (32, 1, 1, 1, g(1), 1)}
    return {k: (conv_flops(ci, co, kt * area, grid), n, ci, co, area, grid)
            for k, (ci, co, kt, area, grid, n) in plan.items()}


def soundnet_flops(samples: int) -> int:
    length, i, total = samples, 1, 0
    for o, k, s, p, pool in SOUNDNET_PLAN:
        length = (length + 2 * p - k) // s + 1
        total += conv_flops(i, o, k, length)
        if pool:
            length //= pool
        i = o
    return total


def soundnet_len(samples: int) -> int:
    length = samples
    for _, k, s, p, pool in SOUNDNET_PLAN:
        length = (length + 2 * p - k) // s + 1
        if pool:
            length //= pool
    return length


def bilinear_flops(h: int, w: int, samples: int) -> int:
    """The fusion's bilinear map: 2 * channels * pooled * audio * tokens."""
    t0, h0, w0 = 4, h // 32, w // 32
    pooled = ((t0 - 4) // 2 + 1) * h0 * ((w0 - 1) // 2 + 1)
    return 2 * 1024 * pooled * soundnet_len(samples) * (t0 * h0 * w0)


def window_flops(cfg: dict) -> int:
    """One window's forward (clip_size frames at the model's input size):
    the backbone, the decoder and, for AViNet, SoundNet and the bilinear."""
    t, h, w = cfg["clip_size"], cfg["input_h"], cfg["input_w"]
    total = sum(f * n for f, n in backbone_layers(t, h, w))
    total += sum(f * n for f, n, *_ in decoder_convs(h, w).values())
    if cfg["model"] == "avinet":
        total += soundnet_flops(cfg["audio_window"]) + bilinear_flops(h, w, cfg["audio_window"])
    return total


def live_flops_per_map(cfg: dict) -> int:
    """The least work a map costs on the live path, which keeps the backbone
    and the decoder's pure-skip convolutions dense in time (each level at
    every input position, once a frame) and decodes each window on them:

    * the backbone at one output position of every stage a frame;
    * the dense front, one position a frame: conv2 over the y1 timeline,
      conv3 over y2, conv4 over y3, and for ViNet conv1 over y0;
    * per window, the taps that read the window's own decoder path: the four
      z positions of conv2, conv3 and conv4 (one kernel tap each), conv5,
      conv6 and conv7 whole, and for AViNet conv1 whole on the fused y0,
      SoundNet and the bilinear map.

    Partial sums over the skip taps of mixed outputs are left out, so no
    implementation needs less."""
    h, w = cfg["input_h"], cfg["input_w"]
    total = sum(f for f, _ in backbone_layers(cfg["clip_size"], h, w))
    dec = decoder_convs(h, w)
    for k in ("conv2", "conv3", "conv4"):
        f, _, ci, co, area, grid = dec[k]
        total += f + 4 * conv_flops(ci, co, area, grid)
    for k in ("conv5", "conv6", "conv7"):
        total += dec[k][0] * dec[k][1]
    if cfg["model"] == "avinet":
        total += dec["conv1"][0] * dec["conv1"][1]
        total += soundnet_flops(cfg["audio_window"]) + bilinear_flops(h, w, cfg["audio_window"])
    else:
        total += dec["conv1"][0]
    return total


def head_bytes_flops(cfg: dict, rows: int) -> tuple:
    """(bytes, FLOPs) the fused head needs for ``rows`` maps. Bytes: read
    relu(conv5) at the coarse grid (32 channels, 2 time positions, bf16) and
    write the full-size f32 maps. FLOPs: conv6 (pointwise in space, so it
    commutes with the linear 2x upsample) at the coarse grid, then a
    32-channel bilinear upsample (8 a value), the ReLU and conv7 at the full
    grid."""
    h, w = cfg["input_h"], cfg["input_w"]
    coarse = (h // 2) * (w // 2)
    nbytes = rows * (32 * 2 * coarse * 2 + h * w * 4)
    flops = rows * (coarse * conv_flops(32, 32, 2, 1) + h * w * (32 * 8 + conv_flops(32, 1, 1, 1)))
    return nbytes, flops


def roofline_s(nbytes: int, flops: int, dtype: str = "bfloat16") -> float:
    """The least time of a kernel: the larger of bytes over the HBM rate and
    FLOPs over the dtype's peak."""
    from portbench.core import HBM_BYTES_PER_S, PEAK_FLOPS

    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
