"""vinet_tpu_torch's AVStreamingPredictor against vinet_tpu's, and the live
predictor's excerpts from its rolling sample buffer against
``audio_excerpt``, AViNet(3, 32) with the refinement encoder at 32 x 32
(fixture visual weights, numpy-seeded audio and fusion), f32 on the CPU.

JAX's predictor runs its own timeline and decode functions jitted with the
trees as arguments (``tests/torch_port_util.py::trees_as_arguments``).

Tolerances: streaming maps max|err| < 2e-3 against JAX (the port's anchor);
the windowed AV decode against the port's decoder on the gathered, fused
windows 1e-5; excerpts bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import (TORCH_THREADS, av_trees, jax_folded, port_avinet,
                                   trees_as_arguments)
from vinet_tpu.data.audio import audio_excerpt as jax_audio_excerpt
from vinet_tpu.inference.streaming import AVStreamingPredictor as JaxAVStreamingPredictor
from vinet_tpu_torch.data.audio import AudioInfo, audio_excerpt, frame_sample_ranges
from vinet_tpu_torch.inference import (AVLiveStreamingPredictor, AVMultiLiveServer,
                                       AVStreamingPredictor, streaming)
from vinet_tpu_torch.inference.accuracy import synthetic_audio_info

torch.set_num_threads(TORCH_THREADS)
HW = (32, 32)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, *HW, 3)).astype(np.uint8)
    for f in range(n):
        cy, cx = 4 + (f * 2) % 18, 2 + (f * 3) % 20
        frames[f, cy:cy + 8, cx:cx + 8] = 230
    return frames


@pytest.fixture(scope="module")
def trees():
    return av_trees(True, input_hw=HW)


@pytest.fixture(scope="module")
def port_model(trees):
    return port_avinet(*trees)


def test_av_streaming_matches_jax(trees, port_model):
    """64 frames in one 64-frame chunk, run flipped for the warm-up windows
    and as it is for the others (chunk seams are the visual predictor's,
    held in test_torch_streaming.py), batch 8 (padded window batches), each
    window with its excerpt."""
    model, params, state = trees
    n = 64
    frames = _frames(n)
    info = synthetic_audio_info(n, fps=24.0, seed=4)
    jp = JaxAVStreamingPredictor(model, *jax_folded(params, state), clip_size=32, batch=8,
                                 chunk=64, dtype=jnp.float32, fold=False)
    trees_as_arguments(jp, "timeline", jp._build_timeline())
    trees_as_arguments(jp, "decode", jp._build_decode())
    want = list(jp.predict_video(frames, audio_fn=lambda s: jax_audio_excerpt(info, 32, s)))
    pred = AVStreamingPredictor(port_model, batch=8, chunk=64, dtype=torch.float32,
                                device="cpu")
    got = list(pred.predict_video(frames, audio_fn=lambda s: audio_excerpt(info, 32, s)))
    assert [i for i, _ in got] == [i for i, _ in want] and sorted(i for i, _ in got) == \
        list(range(n))
    err = max(float(np.abs(g - np.asarray(w)).max()) for (_, g), (_, w) in zip(got, want))
    print(f"AV streaming max|err| {err:.3g}")
    assert err < 2e-3


def test_av_decode_v2_equals_the_decoder_on_fused_windows(port_model):
    """The AV window decode (no conv1 series in the dense front; conv1 on
    the fused y0) = the port's decoder on the gathered windows with y0
    fused; the visual predictor's dense front keeps its conv1 series."""
    pred = AVStreamingPredictor(port_model, batch=4, chunk=64, dtype=torch.float32,
                                device="cpu")
    assert pred.v2 and not pred.dense_conv1
    rng = np.random.default_rng(5)
    audio = torch.from_numpy((rng.standard_normal((4, 70560, 1)) * 0.1).astype(np.float32))
    starts = torch.tensor([0, 5, 17, 32])
    with torch.no_grad():
        tl, dense = pred._timeline(torch.from_numpy(_frames(64, 1))[None], flip=False)
        assert dense[0] is None
        got = pred._decode(tl, dense, starts, audio)
        pyr = streaming.gather_windows(tl, starts)
        pyr[0] = pred.model.fuse(pyr[0], audio)
        want = pred.visual.decoder(pyr)
        assert streaming.dense_decoder_front(pred.visual.decoder, tl)[0] is not None
    assert tuple(got.shape) == (4, *HW)
    assert float((got - want).abs().max()) < 1e-5
    with pytest.raises(ValueError, match="audio"):
        pred._decode(tl, dense, starts)


def _info(n, fps, fs, seed=11):
    rng = np.random.default_rng(seed)
    n_samp = int((n + 2) * fs / fps)
    wav = (rng.standard_normal((1, n_samp)) * 0.01).astype(np.float32)
    starts, ends = frame_sample_ranges(n_samp, n, fs, fps)
    return AudioInfo(wav=wav, fs=fs, starts=starts, ends=ends)


def test_window_audio_matches_audio_excerpt(port_model):
    """The live buffer's excerpt = JAX's audio_excerpt over the whole wav
    (the same truncation, window and centring), reversed for warm-up
    windows; each stream of the multi-stream server reads its own buffer;
    a batch's missing rows are zeros."""
    n, fps, fs = 120, 29.97, 22050
    infos = [_info(n, fps, fs, seed) for seed in (11, 12)]
    starts = [0, 1, 5, 37, n - 32]
    want = [np.stack([jax_audio_excerpt(i, 32, s) for s in starts]) for i in infos]
    live = AVLiveStreamingPredictor(port_model, fps=fps, audio_fs=fs, batch=8,
                                    dtype=torch.float32, device="cpu")
    live._samples = [infos[0].wav[0].copy()]
    got = live._window_audio(starts, flipped=False).numpy()
    assert got.shape == (8, 70560, 1) and float(np.abs(got[len(starts):]).max()) == 0.0
    assert np.array_equal(got[: len(starts)], want[0])
    gotf = live._window_audio(starts, flipped=True).numpy()
    assert np.array_equal(gotf[: len(starts)], want[0][:, ::-1])
    multi = AVMultiLiveServer(port_model, streams=2, fps=fps, audio_fs=fs, batch=8,
                              dtype=torch.float32, device="cpu")
    multi._samples = [i.wav[0].copy() for i in infos]
    got2 = multi._window_audio(starts, flipped=False).numpy().reshape(2, 8, 70560, 1)
    for s in range(2):
        assert np.array_equal(got2[s, : len(starts)], want[s])


def test_window_audio_raises_once_an_excerpt_left_the_buffer(port_model):
    live = AVLiveStreamingPredictor(port_model, fps=25.0, batch=4,
                                    dtype=torch.float32, device="cpu")
    live._samples, live._samples_base = [np.zeros(50000, np.float32)], [30000]
    with pytest.raises(RuntimeError, match="fell off"):
        live._window_audio([0], flipped=False)
    with pytest.raises(ValueError, match="fps"):
        list(AVLiveStreamingPredictor(port_model, batch=4, dtype=torch.float32,
                                      device="cpu").feed(_frames(8)))
