"""vinet_tpu_torch/inference/streaming.py and generate_result --streaming
against vinet_tpu's streaming inference, with the committed full-width
ViNet(3, 32) fixture weights, BatchNorm folded, f32 on the CPU, 32 x 32
frames, clip 32 (the plan-(3, 32) dense-front decode).

Tolerances: the gather exactly; timelines, decodes and maps max|err| < 2e-3
(the port's parity anchor); uint8 maps within 1 level (rounding ties).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.fixtures import make_dhf1k
from tests.torch_port_util import (TORCH_THREADS, fixture_trees, folded_port_model,
                                   ncdhw_to_ndhwc, ndhwc_to_ncdhw)
from vinet_tpu.inference import streaming as jax_streaming
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu_torch.cli.generate_result import main as generate_main
from vinet_tpu_torch.inference import StreamingPredictor, streaming
from vinet_tpu_torch.ops import saliency_head as head

torch.set_num_threads(TORCH_THREADS)
TOL = 2e-3
HW = (32, 32)


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def trees():
    return fixture_trees()


@pytest.fixture(scope="module")
def port_model(trees):
    return folded_port_model(trees)


def _frames(n, seed=0):
    """Structured frames: a bright square moving over dark noise."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, *HW, 3)).astype(np.uint8)
    for f in range(n):
        cy, cx = 4 + (f * 2) % 18, 2 + (f * 3) % 20
        frames[f, cy:cy + 8, cx:cx + 8] = 230
    return frames


@pytest.mark.parametrize("t", [6, 7])
def test_split_time_matches_jax_and_keeps_streams_apart(t):
    x = np.random.default_rng(t).standard_normal((6, t, 2, 3, 4)).astype(np.float32)
    want = np.asarray(jax_streaming._split_time(jnp.asarray(x)))
    got = streaming._split_time(torch.from_numpy(ndhwc_to_ncdhw(x)))
    np.testing.assert_array_equal(ncdhw_to_ndhwc(got.numpy()), want)
    # three streams of two timelines each: each stream split on its own
    got3 = streaming._split_time(torch.from_numpy(ndhwc_to_ncdhw(x)), streams=3)
    for s in range(3):
        one = np.asarray(jax_streaming._split_time(jnp.asarray(x[2 * s: 2 * s + 2])))
        np.testing.assert_array_equal(ncdhw_to_ndhwc(got3[4 * s: 4 * s + 4].numpy()), one)


def test_gather_windows_matches_jax_per_stream():
    """Two streams' timelines stacked stream-major: each stream's windows
    are the JAX package's gather of that stream's timelines, exactly."""
    rng = np.random.default_rng(2)
    phases = (8, 4, 2, 2)
    tl = [rng.random((2 * p, 72 // r, hh, ww, c)).astype(np.float32)
          for p, r, hh, ww, c in ((8, 8, 1, 1, 16), (4, 4, 2, 2, 8), (2, 2, 4, 4, 8),
                                  (2, 2, 8, 8, 4))]
    starts = np.asarray([0, 8, 16, 5, 13, 31, 32], np.int32)
    got = streaming.gather_windows([torch.from_numpy(ndhwc_to_ncdhw(t)) for t in tl],
                                   torch.from_numpy(starts).long())
    for s in range(2):
        want = jax_streaming.gather_windows(
            [jnp.asarray(t[s * p:(s + 1) * p]) for t, p in zip(tl, phases)], jnp.asarray(starts))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(ncdhw_to_ndhwc(g[s * 7:(s + 1) * 7].numpy()),
                                          np.asarray(w))


@pytest.fixture(scope="module")
def jax_predictor(trees):
    """The JAX package's predictor; its jitted timeline and decode functions
    compile once for this file's shapes (64-frame chunks, batch 4)."""
    return jax_streaming.StreamingPredictor(JaxViNet(3, 32), *trees, clip_size=32, batch=4,
                                            chunk=64, dtype=jnp.float32)


@pytest.fixture(scope="module")
def chunk_timelines(jax_predictor, port_model):
    """One flipped 64-frame chunk through both packages' timeline function:
    (JAX (timelines, dense front), the port's)."""
    frames = _frames(64)
    want = jax_predictor._timeline_fn()(jnp.asarray(frames), jnp.asarray(True))
    port = StreamingPredictor(port_model, batch=4, chunk=64, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = port._timeline(torch.from_numpy(frames)[None], flip=True)
    return want, got


def test_timelines_and_dense_front_match_jax(chunk_timelines):
    (want_tl, want_dense), (got_tl, got_dense) = chunk_timelines
    n, (h, w) = 64, HW
    shapes = [(8, n // 8, h // 32, w // 32, 1024), (4, n // 4, h // 16, w // 16, 832),
              (2, n // 2, h // 8, w // 8, 480), (2, n // 2, h // 4, w // 4, 192)]
    for level, (g, wt, shape) in enumerate(zip(got_tl, want_tl, shapes)):
        g = ncdhw_to_ndhwc(g.numpy())
        assert g.shape == np.shape(wt) == shape, level
        print(f"y{level}: max|err| {_max_err(g, wt):.3g}")
        assert _max_err(g, wt) < TOL, level
    for name, g, wt in zip(("c1u", "c2y", "c3y", "c4y"), got_dense, want_dense):
        g = ncdhw_to_ndhwc(g.numpy())
        assert g.shape == np.shape(wt), name
        print(f"{name}: max|err| {_max_err(g, wt):.3g}")
        assert _max_err(g, wt) < TOL, name
    assert streaming.TEMPORAL_HALO == jax_streaming.TEMPORAL_HALO


def test_decode_v2_matches_jax_and_the_gathered_decoder(jax_predictor, port_model,
                                                        chunk_timelines):
    """decode_windows_v2 (dense front, windowed up-mixing positions, folded
    conv5, the fused head) against the JAX package's on the same timelines,
    and against the port's own decoder on the gathered windows."""
    (want_tl, want_dense), _ = chunk_timelines
    starts = np.asarray([0, 5, 17, 32], np.int32)
    want = jax_predictor._decode_fn()(want_tl, want_dense, jnp.asarray(starts))
    tl = [torch.from_numpy(ndhwc_to_ncdhw(np.asarray(t))) for t in want_tl]
    st = torch.from_numpy(starts).long()
    with torch.no_grad():
        got = streaming.decode_windows_v2(port_model.decoder, tl,
                                          streaming.dense_decoder_front(port_model.decoder, tl),
                                          st)
        v1 = port_model.decoder(streaming.gather_windows(tl, st))
    assert tuple(got.shape) == want.shape == (4, 32, 32)
    print(f"v2 vs JAX {_max_err(got.numpy(), want):.3g}, v2 vs v1 {_max_err(got, v1):.3g}")
    assert _max_err(got.numpy(), want) < TOL
    assert _max_err(got, v1) < 1e-5


def test_predictor_matches_jax(trees, jax_predictor):
    """96 frames in two 64-frame chunks (a seam, the flipped warm-up chunk):
    the same frames in the same order, f32 maps; and the port's uint8 maps
    against the JAX package's quantisation of its own f32 maps."""
    from vinet_tpu.ops.image import quantize_maps_u8 as jax_quantize_maps_u8

    frames = _frames(96, seed=1)
    port = StreamingPredictor(folded_port_model(trees), batch=4, chunk=64,
                              dtype=torch.float32, device="cpu")
    before = head.launches
    want = list(jax_predictor.predict_video(frames, out_size=(40, 56)))
    got = list(port.predict_video(frames, out_size=(40, 56)))
    assert [i for i, _ in got] == [i for i, _ in want] and len(got) == 96
    err = max(_max_err(g, w) for (_, g), (_, w) in zip(got, want))
    print(f"f32 maps: max|err| {err:.3g}")
    assert got[0][1].shape == (40, 56) and err < TOL, err
    got_u8 = np.stack([m for _, m in port.predict_video(frames, out_size=(40, 56),
                                                        quantize_u8=True)])
    want_u8 = np.asarray(jax_quantize_maps_u8(jnp.asarray(np.stack([m for _, m in want]))))
    err = np.abs(got_u8.astype(int) - want_u8.astype(int)).max()
    print(f"uint8 maps: max|err| {err} levels")
    assert got_u8.dtype == np.uint8 and err <= 1, err
    assert head.launches == before  # the CPU runs the plain head


def test_predictor_short_videos_and_padding(port_model):
    pred = StreamingPredictor(port_model, batch=8, chunk=64, dtype=torch.float32, device="cpu")
    frames = _frames(62)  # < 2T - 1
    assert list(pred.predict_video(frames)) == []
    got = [i for i, _ in pred.predict_video(frames, pad_short=True)]
    assert sorted(got) == list(range(62))


def test_predictor_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from vinet_tpu_torch.models import ViNet

    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingPredictor(ViNet(3, 32))


def test_streaming_cli_writes_a_map_per_frame(tmp_path):
    """Two videos, one too short to predict (skipped), one of 66 frames."""
    data = make_dhf1k(str(tmp_path / "data"), n_videos=2, n_frames=66, size=(24, 40))
    for f in range(60, 67):
        os.remove(tmp_path / "data" / "002" / "images" / f"{f:04d}.png")
    out = tmp_path / "out"
    rc = generate_main(["--path_indata", data, "--save_path", str(out), "--streaming",
                        "--chunk", "64", "--clip_size", "32", "--input_h", "32", "--input_w",
                        "32", "--window_batch", "8", "--dtype", "float32", "--device", "cpu"])
    assert rc == 0
    frames = sorted(os.listdir(os.path.join(data, "001", "images")))
    assert sorted(os.listdir(out / "001")) == frames and len(frames) == 66
    assert not os.path.exists(out / "002")


def test_hollywood_ucf_cli_pads_short_videos(tmp_path):
    """The Hollywood-2 / UCF-Sports wrapper always pads: a 40-frame video
    (< 2T - 1) gets a map per frame, and --live, which cannot pad, is
    refused."""
    from vinet_tpu_torch.cli.generate_result_hollywood_ucf import main as hollywood_main

    data = make_dhf1k(str(tmp_path / "data"), n_videos=1, n_frames=40, size=(24, 40))
    out = tmp_path / "out"
    flags = ["--path_indata", data, "--save_path", str(out), "--clip_size", "32", "--input_h",
             "32", "--input_w", "32", "--window_batch", "8", "--dtype", "float32", "--device",
             "cpu"]
    assert hollywood_main(flags + ["--streaming", "--chunk", "64"]) == 0
    frames = sorted(os.listdir(os.path.join(data, "001", "images")))
    assert sorted(os.listdir(out / "001")) == frames and len(frames) == 40
    with pytest.raises(SystemExit):
        hollywood_main(flags + ["--live"])


@pytest.mark.slow
def test_streaming_cli_matches_jax_cli(tmp_path):
    """Both CLIs --streaming with the fixture weights at f32 on one 80-frame
    video write the same PNGs, within one gray level."""
    from PIL import Image

    from tests.torch_port_util import FIXTURE
    from vinet_tpu.cli.generate_result import main as jax_generate_main

    data = make_dhf1k(str(tmp_path / "data"), n_videos=1, n_frames=80, size=(40, 56))
    flags = ["--path_indata", data, "--file_weight", FIXTURE, "--streaming", "--chunk", "64",
             "--clip_size", "32", "--input_h", "32", "--input_w", "32", "--window_batch", "4",
             "--dtype", "float32"]
    assert jax_generate_main(flags + ["--save_path", str(tmp_path / "jax")]) == 0
    assert generate_main(flags + ["--save_path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax" / "001"))
    assert names == sorted(os.listdir(tmp_path / "port" / "001")) and len(names) == 80
    err = max(np.abs(np.asarray(Image.open(tmp_path / "jax" / "001" / n), int)
                     - np.asarray(Image.open(tmp_path / "port" / "001" / n), int)).max()
              for n in names)
    print(f"max|err| {err} gray levels")
    assert err <= 1
