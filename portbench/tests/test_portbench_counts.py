"""``counts.py`` reads the same work as torch's FlopCounterMode over the
plain reference, at a small size."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference.models import RefAViNet, RefViNet


def _flops(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_window_flops_match_the_reference():
    cfg = {"model": "vinet", "clip_size": 32, "input_h": 64, "input_w": 96,
           "audio_window": 70560}
    model = RefViNet().eval()
    assert counts.window_flops(cfg) == _flops(lambda: model(torch.zeros(1, 3, 32, 64, 96)))


def test_soundnet_and_bilinear_flops():
    model = RefAViNet((4, 2, 3)).eval()
    audio = torch.zeros(1, 1, 70560)
    assert counts.soundnet_flops(70560) == _flops(lambda: model.audionet(audio))
    assert counts.soundnet_len(70560) == 3
    # 1024 channels, pooled (1, 2, 2), 3 audio features, (4, 2, 3) tokens
    assert counts.bilinear_flops(64, 96, 70560) == 2 * 1024 * 4 * 3 * 24


def test_live_count_is_below_a_window_and_above_the_backbone_frame():
    cfg = {"model": "avinet", "clip_size": 32, "input_h": 224, "input_w": 384,
           "audio_window": 70560}
    live, window = counts.live_flops_per_map(cfg), counts.window_flops(cfg)
    per_frame = sum(f for f, _ in counts.backbone_layers(32, 224, 384))
    assert per_frame < live < window
    assert window == 229_594_695_680


def test_head_roofline_bound_is_the_bytes():
    cfg = {"input_h": 224, "input_w": 384}
    nbytes, flops = counts.head_bytes_flops(cfg, 16)
    assert nbytes == 16 * (32 * 2 * 112 * 192 * 2 + 224 * 384 * 4)
    assert counts.roofline_s(nbytes, flops) == nbytes / 3.35e12
