"""vinet_tpu_torch/inference/live.py and generate_result --live, against the
port's chunked streaming predictor and vinet_tpu's live server, with the
committed ViNet(3, 32) fixture weights, f32 on the CPU, 32 x 32 frames,
clip 32.

The exactness anchor (as in tests/test_live.py): away from the stream's
edges the overlap-save advance computes the chunked timelines, so interior
maps agree to max|err| < 1e-4 and median < 1e-6, and warm-up maps, from the
same flipped chunk, to 1e-5. Against JAX: max|err| < 2e-3 on every frame.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.fixtures import make_dhf1k
from tests.torch_port_util import TORCH_THREADS, fixture_trees, folded_port_model
from vinet_tpu.inference import live as jax_live
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu_torch.cli.generate_result import main as generate_main
from vinet_tpu_torch.inference import LiveStreamingPredictor, StreamingPredictor, live

torch.set_num_threads(TORCH_THREADS)
T, HW, N = 32, (32, 32), 208
# one chunked chunk covers the stream, and the live warm-up pass is that
# same flipped chunk; the span holds it plus one 8-frame phase block
LIVE = dict(clip_size=T, batch=4, micro=16, span=N + 8, warmup_chunk=N)


def _frames(n, seed=7):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, *HW, 3)).astype(np.uint8)
    for f in range(n):
        cy, cx = 4 + (f * 2) % 18, 2 + (f * 3) % 20
        frames[f, cy:cy + 8, cx:cx + 8] = 230
    return frames


@pytest.fixture(scope="module")
def trees():
    return fixture_trees()


def _run_live(pred, frames, step=16):
    got = []
    for lo in range(0, len(frames), step):
        got.extend(pred.feed(frames[lo:lo + step]))
    got.extend(pred.flush())
    return got


@pytest.fixture(scope="module")
def port_live(trees):
    pred = LiveStreamingPredictor(folded_port_model(trees), dtype=torch.float32, device="cpu",
                                  **LIVE)
    return _run_live(pred, _frames(N))


def test_live_matches_chunked_interior_and_warmup(trees, port_live):
    chunked = dict(StreamingPredictor(folded_port_model(trees), clip_size=T, batch=4, chunk=N,
                                      dtype=torch.float32, device="cpu").predict_video(_frames(N)))
    idxs = [i for i, _ in port_live]
    assert idxs == list(range(N))  # every frame once, in order
    maps = dict(port_live)
    warm = max(float(np.abs(maps[i] - chunked[i]).max()) for i in range(T - 1))
    # interior: past the stream start (zero tails against zero padding) and
    # before the flush tail (the repeated last frame)
    d = np.array([float(np.abs(maps[i] - chunked[i]).max()) for i in range(96, N - 70)])
    print(f"warm-up max|err| {warm:.3g}; interior max {d.max():.3g}, median {np.median(d):.3g}")
    assert warm < 1e-5
    assert d.max() < 1e-4 and np.median(d) < 1e-6
    for i in range(N):
        assert np.isfinite(maps[i]).all() and 0.0 <= maps[i].min() and maps[i].max() <= 1.0


def test_live_matches_jax(trees, port_live):
    """The JAX package's live server, fed the same frames the same way."""
    pred = jax_live.LiveStreamingPredictor(JaxViNet(3, 32), *trees, dtype=jnp.float32, **LIVE)
    want = _run_live(pred, _frames(N))
    assert [i for i, _ in port_live] == [i for i, _ in want]
    err = max(float(np.abs(g - np.asarray(w)).max()) for (_, g), (_, w) in zip(port_live, want))
    print(f"max|err| {err:.3g}")
    assert err < 2e-3


def test_live_feed_granularity_invariance(trees):
    """Maps do not depend on how the caller batches feed() calls."""
    model = folded_port_model(trees)
    frames = _frames(128, seed=3)
    runs = [dict(_run_live(LiveStreamingPredictor(model, clip_size=T, batch=4, micro=16,
                                                  span=168, dtype=torch.float32, device="cpu"),
                           frames, step)) for step in (16, 40)]
    assert sorted(runs[0]) == sorted(runs[1]) == list(range(128))
    for i in range(128):
        np.testing.assert_allclose(runs[0][i], runs[1][i], atol=1e-5)


def test_live_short_stream_skipped_and_state_geometry(trees):
    pred = LiveStreamingPredictor(folded_port_model(trees), clip_size=T, batch=4, micro=16,
                                  span=168, dtype=torch.float32, device="cpu")
    assert _run_live(pred, _frames(2 * T - 2)) == []  # fewer than 2T - 1 frames
    assert {k: tuple(v.shape) for k, v in pred._bufs.items()} == {
        "y3": (2, 192, 84, 8, 8), "y2": (2, 480, 84, 4, 4), "y1": (4, 832, 42, 2, 2),
        "y0": (8, 1024, 21, 1, 1), "c1u": (8, 832, 21, 2, 2), "c2y": (4, 480, 42, 2, 2),
        "c3y": (2, 192, 84, 4, 4), "c4y": (2, 64, 84, 8, 8)}


def test_live_constants_match_jax():
    assert live._VIEW_OFF == jax_live.LiveStreamingPredictor._VIEW_OFF
    assert (live._TAIL_A, live._TAIL_B, live._TAIL_C, live._TAIL_D1, live._TAIL_D2,
            live._TAIL_E1, live._TAIL_E2) == (jax_live._TAIL_A, jax_live._TAIL_B,
                                              jax_live._TAIL_C, jax_live._TAIL_D1,
                                              jax_live._TAIL_D2, jax_live._TAIL_E1,
                                              jax_live._TAIL_E2)
    for n in (0, 16, 104, 1000):
        assert {k: f(n) for k, f in live._NEWEST.items()} == \
            {k: f(n) for k, f in jax_live._NEWEST.items()}


def test_live_cli_writes_a_map_per_frame_and_rejects_streaming(tmp_path):
    data = make_dhf1k(str(tmp_path / "data"), n_videos=1, n_frames=70, size=(24, 40))
    out = tmp_path / "out"
    flags = ["--path_indata", data, "--save_path", str(out), "--clip_size", "32", "--input_h",
             "32", "--input_w", "32", "--dtype", "float32", "--device", "cpu"]
    assert generate_main(flags + ["--live", "--live_micro", "16"]) == 0
    frames = sorted(os.listdir(os.path.join(data, "001", "images")))
    assert sorted(os.listdir(out / "001")) == frames and len(frames) == 70
    for extra in (["--streaming"], ["--pad_short"]):
        with pytest.raises(SystemExit):
            generate_main(flags + ["--live"] + extra)


@pytest.mark.slow
def test_live_cli_matches_jax_cli(tmp_path):
    """Both CLIs --live with the fixture weights at f32 on one 90-frame
    video write the same PNGs, within one gray level."""
    from PIL import Image

    from tests.torch_port_util import FIXTURE
    from vinet_tpu.cli.generate_result import main as jax_generate_main

    data = make_dhf1k(str(tmp_path / "data"), n_videos=1, n_frames=90, size=(40, 56))
    flags = ["--path_indata", data, "--file_weight", FIXTURE, "--live", "--live_micro", "16",
             "--clip_size", "32", "--input_h", "32", "--input_w", "32", "--dtype", "float32"]
    assert jax_generate_main(flags + ["--save_path", str(tmp_path / "jax")]) == 0
    assert generate_main(flags + ["--save_path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax" / "001"))
    assert names == sorted(os.listdir(tmp_path / "port" / "001")) and len(names) == 90
    err = max(np.abs(np.asarray(Image.open(tmp_path / "jax" / "001" / n), int)
                     - np.asarray(Image.open(tmp_path / "port" / "001" / n), int)).max()
              for n in names)
    print(f"max|err| {err} gray levels")
    assert err <= 1
