"""vinet_tpu_torch/data/audio.py and inference/accuracy.py's synthetic audio
against vinet_tpu's, bit for bit; the audio-visual CLIs' flags against
JAX's; and the rule that every new entry point refuses CUDA without a card.
"""

import importlib

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vinet_tpu.data import audio as jax_audio
from vinet_tpu.inference.accuracy import synthetic_audio_info as jax_synthetic_audio_info
from vinet_tpu_torch.data import audio
from vinet_tpu_torch.inference.accuracy import synthetic_audio_info


def _same_info(a, b):
    assert a.fs == b.fs
    for k in ("wav", "starts", "ends"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("n_total,n_frames,fs,fps", [
    (70560, 96, 22050, 30.0), (44100, 50, 22050, 29.97), (1000, 64, 22050, 25.0),
    (123457, 301, 44100, 23.976), (0, 10, 22050, 30.0)])
def test_frame_sample_ranges_match_jax(n_total, n_frames, fs, fps):
    got = audio.frame_sample_ranges(n_total, n_frames, fs, fps)
    want = jax_audio.frame_sample_ranges(n_total, n_frames, fs, fps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("n_samples", [200000, 30000, 700, 0])
def test_audio_excerpt_matches_jax(n_samples):
    """Every window start of a 96-frame video, edges included, on long,
    short (the excerpt shorter than the buffer, then the wav ending inside
    the clip) and empty audio, and missing audio (None): bit for bit."""
    rng = np.random.default_rng(n_samples)
    wav = (rng.standard_normal((1, n_samples)) * 0.01).astype(np.float32)
    starts, ends = audio.frame_sample_ranges(n_samples, 96, 22050, 29.97)
    info = audio.AudioInfo(wav=wav, fs=22050, starts=starts, ends=ends)
    jinfo = jax_audio.AudioInfo(wav=wav, fs=22050, starts=starts, ends=ends)
    for s in list(range(0, 96 - 32 + 1)) + [80, 95]:
        got = audio.audio_excerpt(info, 32, s)
        assert got.shape == (audio.MAX_AUDIO_WIN, 1) and got.dtype == np.float32
        assert np.array_equal(got, jax_audio.audio_excerpt(jinfo, 32, s)), s
    assert np.array_equal(audio.audio_excerpt(None, 32, 3), jax_audio.audio_excerpt(None, 32, 3))
    assert audio.MAX_AUDIO_WIN == jax_audio.MAX_AUDIO_WIN == 70560


@pytest.mark.parametrize("channels,dtype", [(1, np.int16), (2, np.int16), (2, np.int32)])
def test_load_wav_raw_matches_jax(tmp_path, channels, dtype):
    rng = np.random.default_rng(channels)
    info = np.iinfo(dtype)
    data = rng.integers(info.min, info.max, (4410, channels) if channels > 1 else 4410,
                        dtype=dtype)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 22050, data)
    got, fs = audio.load_wav_raw(path)
    want, jfs = jax_audio.load_wav_raw(path)
    assert fs == jfs == 22050 and got.shape == (channels, 4410)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_build_audio_index_matches_jax(tmp_path):
    """Wavs present, missing, and a video whose GT maps count its frames."""
    root, gt = tmp_path / "audio", tmp_path / "gt"
    for v, n in (("a", 3000), ("b", 9000)):
        (root / v).mkdir(parents=True)
        wavfile.write(str(root / v / f"{v}.wav"), 22050,
                      np.arange(n, dtype=np.int16))
    (gt / "b" / "maps").mkdir(parents=True)
    for f in range(7):
        (gt / "b" / "maps" / f"{f}.png").write_bytes(b"")
    args = (["a", "b", "c"], {"a": 40, "b": 40, "c": 40}, {"a": 30.0, "b": 25.0, "c": 30.0},
            str(root))
    got = audio.build_audio_index(*args, gt_root=str(gt))
    want = jax_audio.build_audio_index(*args, gt_root=str(gt))
    assert sorted(got) == sorted(want) == ["a", "b"]
    for v in got:
        _same_info(got[v], want[v])
    assert len(got["b"].starts) == 8


@pytest.mark.parametrize("n_frames,fps,seed", [(96, 30.0, 0), (72, 25.0, 3)])
def test_synthetic_audio_info_matches_jax(n_frames, fps, seed):
    _same_info(synthetic_audio_info(n_frames, fps=fps, seed=seed),
               jax_synthetic_audio_info(n_frames, fps=fps, seed=seed))


AV_CLIS = ["generate_result_audio_visual", "generate_result_dave", "generate_theatre",
           "diem_val"]


def _actions(parser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cli", AV_CLIS)
def test_av_cli_flags_match_jax(cli, capsys):
    """The port's parser takes every flag of JAX's, with JAX's default; it
    adds --device (default cuda) alone. --help names the port's module."""
    port = importlib.import_module(f"vinet_tpu_torch.cli.{cli}").build_parser()
    jax_parser = importlib.import_module(f"vinet_tpu.cli.{cli}").build_parser()
    got, want = _actions(port), _actions(jax_parser)
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"
    for dest, default in want.items():
        assert got[dest] == default, dest
    assert {a.dest for a in port._actions if a.required} == \
        {a.dest for a in jax_parser._actions if a.required}
    with pytest.raises(SystemExit) as e:
        port.parse_args(["--help"])
    assert e.value.code == 0 and "--use_sound" in capsys.readouterr().out


def _stavis(tmp_path, n_frames=4):
    from tests.fixtures import make_sound_dataset

    data, _ = make_sound_dataset(str(tmp_path / "data"), n_videos=1, n_frames=n_frames)
    return data


def test_cuda_without_a_card_raises_on_every_av_entry_point(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from vinet_tpu_torch.inference import (AVLiveStreamingPredictor, AVMultiLiveServer,
                                           AVStreamingPredictor)
    from vinet_tpu_torch.inference.accuracy import evaluate_av_agreement
    from vinet_tpu_torch.models import AViNet
    from vinet_tpu_torch.models.inference import make_inference_fn

    model = AViNet(input_hw=(32, 32))
    makers = [lambda: AVStreamingPredictor(model),
              lambda: AVLiveStreamingPredictor(model, fps=30.0),
              lambda: AVMultiLiveServer(model, streams=2, fps=30.0),
              lambda: make_inference_fn(model),
              lambda: evaluate_av_agreement(model, kinds=("blob",))]
    for make in makers:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    data = _stavis(tmp_path)
    out = str(tmp_path / "out")
    flags = ["--use_sound", "True", "--input_h", "32", "--input_w", "32"]
    for cli, argv in (
            ("generate_result_audio_visual", ["--path_data", data, "--save_path", out]),
            ("generate_result_dave", ["--path_data", data, "--save_path", out,
                                      "--fps_json", str(tmp_path / "fps.json")]),
            ("generate_theatre", ["--path_indata", data, "--save_path", out]),
            ("diem_val", ["--path_data", data])):
        main = importlib.import_module(f"vinet_tpu_torch.cli.{cli}").main
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + flags)
