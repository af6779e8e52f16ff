"""Audio indexing and per-window excerpts, ``vinet_tpu/data/audio.py``.

As the reference's make_dataset/get_audio_feature: a video's whole wav is
held in memory at raw integer scale times 2^-23, per-frame sample ranges
come from fps, and a clip's excerpt is Hanning-windowed and centred in a
fixed 70 560-sample buffer (22050 Hz / 10 fps x 32 frames), so SoundNet
always sees one shape.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

MAX_AUDIO_FS = 22050
MIN_VIDEO_FPS = 10
MAX_AUDIO_WIN = int(MAX_AUDIO_FS / MIN_VIDEO_FPS * 32)  # 70560


def load_wav_raw(path: str) -> tuple[np.ndarray, int]:
    """A wav at raw integer amplitude times 2^-23 (the reference's
    torchaudio.load(normalization=False) * 2**-23). Returns (samples (C, N)
    float32, sample rate)."""
    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    data = np.atleast_2d(np.asarray(data))
    if data.shape[0] > data.shape[1]:
        data = data.T  # (C, N)
    return data.astype(np.float32) * (2.0**-23), fs


@dataclass
class AudioInfo:
    wav: np.ndarray  # (C, N) float32
    fs: int
    starts: np.ndarray  # (n_frames+1,) int
    ends: np.ndarray


def frame_sample_ranges(n_samples_total: int, n_frames: int, fs: float, fps: float):
    """Per-frame [start, end) sample ranges centred on the frame timestamps,
    fs/fps samples a frame, truncated with int(). Index 0 is a sentinel."""
    spf = fs / float(fps)
    starts = np.zeros(n_frames + 1, dtype=np.int64)
    ends = np.zeros(n_frames + 1, dtype=np.int64)
    for f in range(1, n_frames + 1):
        t = (f - 1) * (1.0 / float(fps)) * fs
        starts[f] = int(max(0.0, t - spf / 2))
        ends[f] = int(min(n_samples_total, abs(t + spf / 2)))
    return starts, ends


def build_audio_index(video_names, nframes_by_video, fps_by_video, audio_root, *, gt_root=None):
    """Video name -> AudioInfo of <audio_root>/<name>/<name>.wav. The frame
    count is that of the GT maps when gt_root has them; videos without a wav
    or with at most one frame are left out."""
    index = {}
    for name in video_names:
        wav_path = os.path.join(audio_root, name, f"{name}.wav")
        if not os.path.exists(wav_path):
            continue
        n_frames = nframes_by_video[name]
        if gt_root is not None:
            maps_dir = os.path.join(gt_root, name, "maps")
            if os.path.isdir(maps_dir):
                n_frames = len(os.listdir(maps_dir))
        if n_frames <= 1:
            continue
        wav, fs = load_wav_raw(wav_path)
        starts, ends = frame_sample_ranges(wav.shape[1], n_frames, fs, fps_by_video[name])
        index[name] = AudioInfo(wav=wav, fs=fs, starts=starts, ends=ends)
    return index


def windowed_excerpt(samples: np.ndarray) -> np.ndarray:
    """An excerpt's samples -> (70560, 1) float32: the Hanning window of the
    whole excerpt's length, cut to the buffer with the excerpt, centred."""
    buf = np.zeros((MAX_AUDIO_WIN,), np.float32)
    n = samples.shape[0]
    if n > 0:
        m = min(n, MAX_AUDIO_WIN)
        lo = MAX_AUDIO_WIN // 2 - m // 2
        buf[lo: lo + m] = samples[:m] * np.hanning(n)[:m].astype(np.float32)
    return buf[:, None]


def audio_excerpt(info: AudioInfo | None, clip_size: int, start_idx: int) -> np.ndarray:
    """The excerpt of frames [start_idx+1, start_idx+clip_size], windowed
    (``windowed_excerpt``). Missing audio gives zeros (the reference prints
    and returns zeros)."""
    if info is None:
        return np.zeros((MAX_AUDIO_WIN, 1), np.float32)
    s = int(info.starts[start_idx + 1])
    e = int(info.ends[min(start_idx + clip_size, len(info.ends) - 1)])
    return windowed_excerpt(info.wav[0, s: e + 1])
