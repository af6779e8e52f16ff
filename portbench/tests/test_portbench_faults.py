"""Whole runs at a tiny size on the CPU, past the look for a card: sound,
each comes out correct; with the timed path broken underneath, where each
map is produced, ``correct`` comes out false."""

import torch

import portbench.run as run
from portbench.tests.helpers import small_cell


def _alter(maps: torch.Tensor, rows=slice(0, 1)) -> torch.Tensor:
    """maps with the given rows inverted."""
    maps = maps.clone()
    maps[rows] = 255 - maps[rows] if maps.dtype == torch.uint8 else 1 - maps[rows]
    return maps


def test_parity_sound_then_altered_map(monkeypatch):
    from vinet_tpu_torch.inference.engine import SlidingWindowPredictor

    torch.set_num_threads(4)
    assert run.measure(small_cell("vinet-dhf1k.parity"))["correct"]
    orig = SlidingWindowPredictor.run_batch
    monkeypatch.setattr(SlidingWindowPredictor, "run_batch",
                        lambda self, *a, **k: _alter(orig(self, *a, **k)))
    out = run.measure(small_cell("vinet-dhf1k.parity"))
    assert not out["correct"], out["compared"]


def test_live_sound_then_altered_map(monkeypatch):
    from vinet_tpu_torch.inference.streaming import StreamingPredictor

    torch.set_num_threads(4)
    assert run.measure(small_cell("avinet-stavis.live-cams"))["correct"]
    orig = StreamingPredictor._post
    monkeypatch.setattr(StreamingPredictor, "_post",
                        staticmethod(lambda *a: _alter(orig(*a), slice(None))))
    out = run.measure(small_cell("avinet-stavis.live-cams"))
    assert not out["correct"], out["compared"]


def test_train_sound_then_state_unchanged(monkeypatch):
    from vinet_tpu_torch.training import trainer

    torch.set_num_threads(4)
    assert run.measure(small_cell("avinet-stavis.train-b8"))["correct"]
    monkeypatch.setattr(trainer, "apply_update",
                        lambda ts: torch.zeros(()))  # the step leaves its state as it was
    out = run.measure(small_cell("avinet-stavis.train-b8"))
    assert not out["correct"], out["compared"]


def test_train_half_batch(monkeypatch):
    from vinet_tpu_torch.cli import train as train_cli

    torch.set_num_threads(4)
    orig = train_cli.to_device
    monkeypatch.setattr(train_cli, "to_device", lambda batch, device: {
        k: v[: v.shape[0] // 2] for k, v in orig(batch, device).items()})
    out = run.measure(small_cell("avinet-stavis.train-b8"))
    assert not out["correct"], out["compared"]
