"""The port's audio-visual CLIs on the CPU: generate_result_audio_visual
(parity, --streaming, --live), generate_result_dave (--fps_json) and
generate_theatre (a 44 100 Hz wav, resampled as the JAX package resamples
it), on a one-video STAViS layout of 64 frames at 64 x 96 (tests/fixtures.py),
the model at 32 x 32 with its seed-0 weights.

Each run writes a map for every frame, and its maps are the maps its
predictor yielded (captured before the JPEG encode, so exactly) for the
video's frames and audio: the predictor's calls are recorded and held
against the decoded frames, ``audio_excerpt`` of the video's audio index
and, for --live, the wav cut on the stream clock. The predictors themselves
are held against JAX in the parity, streaming and live test files.
"""

import json
import os
from os.path import join

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.fixtures import make_sound_dataset
from tests.torch_port_util import TORCH_THREADS
from vinet_tpu_torch.cli import generate_result_audio_visual as av_cli
from vinet_tpu_torch.data.audio import audio_excerpt, build_audio_index
from vinet_tpu_torch.inference import (AVLiveStreamingPredictor, AVStreamingPredictor,
                                       SlidingWindowPredictor)
from vinet_tpu_torch.io import images

torch.set_num_threads(TORCH_THREADS)
N, FPS, T = 64, 10.0, 32
MODEL = ["--use_sound", "True", "--input_h", "32", "--input_w", "32", "--dtype", "float32",
         "--device", "cpu", "--window_batch", "8"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root, names = make_sound_dataset(str(tmp_path_factory.mktemp("stavis")), n_frames=N)
    return root, names[0]


@pytest.fixture(scope="module")
def video(data):
    """The video's frames as the CLIs decode them and its audio index entry."""
    from vinet_tpu_torch.io.images import load_frame

    root, name = data
    fdir = join(root, "video_frames", "DIEM", name)
    clip = np.stack([load_frame(join(fdir, f), size=(32, 32))[0] for f in sorted(os.listdir(fdir))])
    info = build_audio_index([name], {name: N}, {name: FPS}, join(root, "video_audio", "DIEM"),
                             gt_root=join(root, "annotations", "DIEM"))[name]
    return clip, info


@pytest.fixture
def saved(monkeypatch):
    """{path: map} of every save_map call."""
    out = {}
    real = images.save_map
    monkeypatch.setattr(images, "save_map", lambda a, p: (out.__setitem__(p, a), real(a, p)))
    return out


@pytest.fixture
def recorded(monkeypatch):
    """(calls, maps): every predict_video, start, feed and flush call on a
    predictor, as (class, method, args, kwargs), and {frame: map} of every
    map a predictor yielded."""
    calls, maps = [], {}

    def spy(cls, name):
        real = getattr(cls, name)

        def call(self, *args, **kwargs):
            calls.append((type(self), name, args, kwargs))
            out = real(self, *args, **kwargs)
            if name == "start":
                return out
            return ((i, maps.setdefault(i, m)) for i, m in out)

        monkeypatch.setattr(cls, name, call)

    spy(SlidingWindowPredictor, "predict_video")
    spy(AVStreamingPredictor, "predict_video")
    for name in ("start", "feed", "flush"):
        spy(AVLiveStreamingPredictor, name)
    return calls, maps


def _check_excerpts(audio_fn, info):
    for start in range(N - T + 1):
        assert np.array_equal(audio_fn(start), audio_excerpt(info, T, start)), start


def _check_saved(saved, maps, out_dir, names, dtype=np.uint8):
    assert sorted(os.listdir(out_dir)) == sorted(names) and sorted(maps) == list(range(N))
    for i, name in enumerate(names):
        got = saved[join(str(out_dir), name)]
        assert got.dtype == dtype and got.shape == (64, 96)
        assert got is maps[i], i


def _jpgs(root, name):
    return [os.path.splitext(f)[0] + ".jpg"
            for f in sorted(os.listdir(join(root, "video_frames", "DIEM", name)))]


@pytest.mark.parametrize("mode,cls", [([], SlidingWindowPredictor),
                                      (["--streaming"], AVStreamingPredictor)])
def test_av_cli_writes_the_predictors_maps(mode, cls, data, video, saved, recorded, tmp_path):
    root, name = data
    clip, info = video
    argv = ["--path_data", root, "--save_path", str(tmp_path / "out")] + MODEL + mode
    assert av_cli.main(argv) == 0
    calls, maps = recorded
    [(kind, method, args, kw)] = calls
    assert (kind, method) == (cls, "predict_video") and np.array_equal(args[0], clip)
    assert kw["out_size"] == (64, 96) and kw["quantize_u8"] is True
    _check_excerpts(kw["audio_fn"], info)
    _check_saved(saved, maps, tmp_path / "out" / name, _jpgs(root, name))


def test_av_live_cli_feeds_frames_and_samples_on_the_stream_clock(data, video, saved, recorded,
                                                                  tmp_path):
    """--live --live_micro 16: each feed carries 16 frames and the samples
    of those frames, int(f * fs / fps) for frame f; the rest of the wav
    comes with no frames, then the flush."""
    root, name = data
    clip, info = video
    argv = ["--path_data", root, "--save_path", str(tmp_path / "out"), "--live",
            "--live_micro", "16"] + MODEL
    assert av_cli.main(argv) == 0
    calls, maps = recorded
    assert all(kind is AVLiveStreamingPredictor for kind, *_ in calls)
    assert [m for _, m, *_ in calls] == ["start"] + ["feed"] * 5 + ["flush"]
    assert calls[0][3] == dict(out_size=(64, 96), quantize_u8=True, fps=FPS)
    feeds = [(args[0], kw["audio"]) for _, m, args, kw in calls if m == "feed"]
    spf = 22050 / FPS
    wav = info.wav[0]
    for k, (frames, audio) in enumerate(feeds[:4]):
        lo = 16 * k
        assert np.array_equal(frames, clip[lo: lo + 16])
        assert np.array_equal(audio, wav[int(lo * spf): int((lo + 16) * spf)])
    assert len(feeds[4][0]) == 0 and np.array_equal(feeds[4][1], wav[int(N * spf):])
    _check_saved(saved, maps, tmp_path / "out" / name, _jpgs(root, name))


def test_dave_cli_takes_the_fps_json(data, video, saved, recorded, tmp_path):
    from vinet_tpu_torch.cli.generate_result_dave import main

    root, name = data
    clip, info = video
    fps_json = tmp_path / "fps.json"
    fps_json.write_text(json.dumps({name: FPS}))
    with pytest.raises(SystemExit):
        main(["--path_data", root, "--save_path", str(tmp_path / "x")] + MODEL)
    assert main(["--path_data", root, "--save_path", str(tmp_path / "dave"),
                 "--fps_json", str(fps_json)] + MODEL) == 0
    calls, maps = recorded
    [(kind, _, args, kw)] = calls
    assert kind is SlidingWindowPredictor and np.array_equal(args[0], clip)
    _check_excerpts(kw["audio_fn"], info)
    _check_saved(saved, maps, tmp_path / "dave" / name, _jpgs(root, name))


def test_theatre_cli_on_a_44100_hz_wav(data, video, saved, recorded, tmp_path):
    """Raw-footage layout with a 44.1 kHz stereo wav: the resampled samples
    equal the JAX package's, the excerpts are cut from them at 22050 Hz, and
    a map is written for every frame under the frame's own name."""
    from vinet_tpu.cli.generate_theatre import _load_resampled_wav
    from vinet_tpu_torch.cli.generate_theatre import audio_info, load_resampled_wav, main

    root, name = data
    theatre = tmp_path / "theatre"
    os.makedirs(theatre / "video_frames")
    os.symlink(join(root, "video_frames", "DIEM", name), theatre / "video_frames" / name)
    os.makedirs(theatre / "video_audio")
    t = np.arange(int(44100 * N / FPS)) / 44100.0
    wav = (8000 * np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 97 * t)], 1))
    path = str(theatre / "video_audio" / f"{name}.wav")
    wavfile.write(path, 44100, wav.astype(np.int16))
    (theatre / "fps.json").write_text(json.dumps({name: FPS}))
    got, fs = load_resampled_wav(path)
    want, jfs = _load_resampled_wav(path)
    assert fs == jfs == 22050 and got.shape == (2, int(22050 * N / FPS))
    assert np.array_equal(got, want)
    info = audio_info(path, N, FPS)
    assert np.array_equal(info.wav, got) and info.fs == 22050
    assert main(["--path_indata", str(theatre), "--save_path", str(tmp_path / "out")]
                + MODEL) == 0
    calls, maps = recorded
    [(kind, _, args, kw)] = calls
    assert kind is SlidingWindowPredictor and np.array_equal(args[0], video[0])
    _check_excerpts(kw["audio_fn"], info)
    frames = sorted(os.listdir(theatre / "video_frames" / name))
    _check_saved(saved, maps, tmp_path / "out" / name, frames, np.float32)  # quantized on save
