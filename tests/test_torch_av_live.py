"""vinet_tpu_torch's AVLiveStreamingPredictor and AVMultiLiveServer against
the port's chunked AVStreamingPredictor and single-stream live server,
AViNet(3, 32) at 32 x 32 (fixture visual weights, numpy-seeded audio and
fusion), f32 on the CPU. (The chunked predictor is held against JAX in
test_torch_av_streaming.py.)

The anchors, as in tests/test_live.py and tests/test_serving.py: away from
the stream's edges the overlap-save advance computes the chunked timelines
and every window reads the same excerpt, so interior maps agree to
max|err| < 1e-4 and median < 1e-6, warm-up maps to 1e-5; each stream of the
multi-stream server is a dedicated live server's to 1e-5.
"""

import numpy as np
import pytest
import torch

from tests.torch_port_util import TORCH_THREADS, av_trees, port_avinet
from vinet_tpu_torch.data.audio import audio_excerpt
from vinet_tpu_torch.inference import (AVLiveStreamingPredictor, AVMultiLiveServer,
                                       AVStreamingPredictor)
from vinet_tpu_torch.inference.accuracy import synthetic_audio_info

torch.set_num_threads(TORCH_THREADS)
T, HW, FPS, FS = 32, (32, 32), 25.0, 22050


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, *HW, 3)).astype(np.uint8)
    for f in range(n):
        cy, cx = 2 + (f * (2 + seed % 3)) % 20, 2 + (f * 3) % 20
        frames[f, cy:cy + 8, cx:cx + 8] = 230
    return frames


@pytest.fixture(scope="module")
def model():
    return port_avinet(*av_trees(False, input_hw=HW))


def _feed_all(pred, frames, wavs, step=16):
    """Frames step at a time with the samples of those frames on the stream
    clock, then the rest of the samples with no frames, then the flush.
    One stream: frames (n, ...), wavs [wav]; several: (S, n, ...)."""
    multi = frames.ndim == 5
    n = frames.shape[1] if multi else frames.shape[0]
    spf = FS / FPS
    got = []
    for lo in range(0, n, step):
        chunk = [w[int(lo * spf): int(min(lo + step, n) * spf)] for w in wavs]
        f = frames[:, lo:lo + step] if multi else frames[lo:lo + step]
        got.extend(pred.feed(f, audio=chunk if multi else chunk[0]))
    rest = [w[int(n * spf):] for w in wavs]
    f = frames[:, :0] if multi else frames[:0]
    got.extend(pred.feed(f, audio=rest if multi else rest[0]))
    got.extend(pred.flush())
    return got


def test_av_live_matches_chunked_interior_and_warmup(model):
    """176 frames: one chunk covers them and the live warm-up pass is that
    same flipped chunk; frames 96..105 are interior."""
    n = 176
    frames = _frames(n, 7)
    info = synthetic_audio_info(n, fps=FPS, fs=FS, seed=3)
    chunked = dict(AVStreamingPredictor(model, batch=8, chunk=n, dtype=torch.float32,
                                        device="cpu")
                   .predict_video(frames, audio_fn=lambda s: audio_excerpt(info, T, s)))
    live = AVLiveStreamingPredictor(model, fps=FPS, audio_fs=FS, batch=8, micro=16,
                                    span=n + 8, warmup_chunk=n, dtype=torch.float32,
                                    device="cpu")
    got = _feed_all(live, frames, [info.wav[0]])
    assert [i for i, _ in got] == list(range(n))  # every frame once, in order
    maps = dict(got)
    warm = max(float(np.abs(maps[i] - chunked[i]).max()) for i in range(T - 1))
    d = np.array([float(np.abs(maps[i] - chunked[i]).max()) for i in range(96, n - 70)])
    print(f"warm-up max|err| {warm:.3g}; interior max {d.max():.3g}, median {np.median(d):.3g}")
    assert warm < 1e-5 and d.max() < 1e-4 and np.median(d) < 1e-6
    # samples no window reads any more were dropped from the buffer
    assert live._samples_base[0] > 0


def test_av_multilive_matches_single_streams(model):
    """Two streams with their own frames and audio (one of them silent):
    each stream's maps = a dedicated single-stream live server's."""
    n = 72
    frames = np.stack([_frames(n, 3), _frames(n, 11)])
    wavs = [synthetic_audio_info(n, fps=FPS, fs=FS, seed=5).wav[0],
            np.zeros((0,), np.float32)]
    cfg = dict(fps=FPS, audio_fs=FS, batch=8, micro=16, span=168, warmup_chunk=64,
               dtype=torch.float32, device="cpu")
    got = _feed_all(AVMultiLiveServer(model, streams=2, **cfg), frames, wavs)
    for s in range(2):
        mine = [(i, m) for si, i, m in got if si == s]
        assert [i for i, _ in mine] == list(range(n)), s
        single = dict(_feed_all(AVLiveStreamingPredictor(model, **cfg), frames[s], [wavs[s]]))
        for i, m in mine:
            np.testing.assert_allclose(m, single[i], atol=1e-5, err_msg=f"stream {s} frame {i}")
    with pytest.raises(ValueError, match="2 streams"):
        list(AVMultiLiveServer(model, streams=2, **cfg).feed(frames[:, :8], audio=[wavs[0]]))
