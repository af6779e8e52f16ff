"""vinet_tpu_torch/inference/serving.py and cli/serve.py against dedicated
single-stream live servers and vinet_tpu's multi-stream server, with the
committed ViNet(3, 32) fixture weights, f32 on the CPU, 32 x 32 frames,
clip 32.

The exactness anchor (as in tests/test_serving.py): the stream axis folds
into the batch axis and no op mixes batch elements, so each stream's maps
are a dedicated LiveStreamingPredictor's to max|err| 1e-5. Against JAX:
max|err| < 2e-3 on every map.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.fixtures import make_dhf1k
from tests.torch_port_util import TORCH_THREADS, fixture_trees, folded_port_model
from vinet_tpu.inference.serving import MultiLiveServer as JaxMultiLiveServer
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu_torch.cli.serve import main as serve_main
from vinet_tpu_torch.inference import LiveStreamingPredictor, MultiLiveServer

torch.set_num_threads(TORCH_THREADS)
T, HW, N = 32, (32, 32), 96
LIVE = dict(clip_size=T, batch=4, micro=16, span=168, warmup_chunk=64)


def _stream_frames(seed, n=N):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, *HW, 3)).astype(np.uint8)
    for f in range(n):
        cy, cx = 2 + (f * (2 + seed % 3)) % 20, 2 + (f * 3) % 20
        frames[f, cy:cy + 8, cx:cx + 8] = 230
    return frames


@pytest.fixture(scope="module")
def trees():
    return fixture_trees()


@pytest.fixture(scope="module")
def streams():
    return np.stack([_stream_frames(3), _stream_frames(11)])


def _run_multi(server, stacked):
    got = []
    for lo in range(0, stacked.shape[1], 16):
        got.extend(server.feed(stacked[:, lo:lo + 16]))
    got.extend(server.flush())
    per_stream = {s: [(i, m) for si, i, m in got if si == s] for s in range(stacked.shape[0])}
    for s, maps in per_stream.items():  # every (stream, frame) once, frames in order
        assert [i for i, _ in maps] == list(range(stacked.shape[1])), s
    return {s: dict(maps) for s, maps in per_stream.items()}


@pytest.fixture(scope="module")
def port_multi(trees, streams):
    server = MultiLiveServer(folded_port_model(trees), streams=2, dtype=torch.float32,
                             device="cpu", **LIVE)
    return _run_multi(server, streams)


def test_multilive_matches_single_streams(trees, streams, port_multi):
    model = folded_port_model(trees)
    for s in range(2):
        live = LiveStreamingPredictor(model, dtype=torch.float32, device="cpu", **LIVE)
        single = [m for lo in range(0, N, 16) for m in live.feed(streams[s, lo:lo + 16])]
        single = dict(single + list(live.flush()))
        assert sorted(single) == list(range(N))
        for i in range(N):
            np.testing.assert_allclose(port_multi[s][i], single[i], atol=1e-5,
                                       err_msg=f"stream {s} frame {i}")


def test_multilive_matches_jax(trees, streams, port_multi):
    server = JaxMultiLiveServer(JaxViNet(3, 32), *trees, streams=2, dtype=jnp.float32, **LIVE)
    want = _run_multi(server, streams)
    err = max(float(np.abs(port_multi[s][i] - np.asarray(want[s][i])).max())
              for s in range(2) for i in range(N))
    print(f"max|err| {err:.3g}")
    assert err < 2e-3


def test_multilive_rejects_frames_of_another_stream_count(trees):
    server = MultiLiveServer(folded_port_model(trees), streams=2, dtype=torch.float32,
                             device="cpu", **LIVE)
    with pytest.raises(ValueError, match="frames must be"):
        list(server.feed(np.zeros((3, 16, *HW, 3), np.uint8)))
    with pytest.raises(ValueError, match="streams"):
        MultiLiveServer(folded_port_model(trees), streams=0, device="cpu")


def test_serve_cli_writes_a_map_per_frame(tmp_path):
    """Three videos of one size served two at a time: the second group pads
    its missing stream, a shorter video its missing frames; a video shorter
    than 2T - 1 frames is skipped."""
    data = make_dhf1k(str(tmp_path / "data"), n_videos=4, n_frames=70, size=(24, 40))
    for f in range(64, 71):  # video 002: 63 frames
        os.remove(tmp_path / "data" / "002" / "images" / f"{f:04d}.png")
    for f in range(60, 71):  # video 004: too short
        os.remove(tmp_path / "data" / "004" / "images" / f"{f:04d}.png")
    out = tmp_path / "out"
    rc = serve_main(["--path_indata", data, "--save_path", str(out), "--streams", "2",
                     "--live_micro", "16", "--clip_size", "32", "--input_h", "32", "--input_w",
                     "32", "--dtype", "float32", "--device", "cpu"])
    assert rc == 0
    for video, n in (("001", 70), ("002", 63), ("003", 70)):
        frames = sorted(os.listdir(os.path.join(data, video, "images")))
        assert sorted(os.listdir(out / video)) == frames and len(frames) == n
    assert not os.path.exists(out / "004")


@pytest.mark.slow
def test_serve_cli_matches_jax_cli(tmp_path):
    """Both serve CLIs with the fixture weights at f32 on two 80-frame videos
    write the same PNGs, within one gray level."""
    from PIL import Image

    from tests.torch_port_util import FIXTURE
    from vinet_tpu.cli.serve import main as jax_serve_main

    data = make_dhf1k(str(tmp_path / "data"), n_videos=2, n_frames=80, size=(40, 56))
    flags = ["--path_indata", data, "--file_weight", FIXTURE, "--streams", "2", "--live_micro",
             "16", "--clip_size", "32", "--input_h", "32", "--input_w", "32", "--dtype",
             "float32"]
    assert jax_serve_main(flags + ["--save_path", str(tmp_path / "jax")]) == 0
    assert serve_main(flags + ["--save_path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    err = 0
    for video in ("001", "002"):
        names = sorted(os.listdir(tmp_path / "jax" / video))
        assert names == sorted(os.listdir(tmp_path / "port" / video)) and len(names) == 80
        err = max(err, max(np.abs(np.asarray(Image.open(tmp_path / "jax" / video / n), int)
                                  - np.asarray(Image.open(tmp_path / "port" / video / n), int)
                                  ).max() for n in names))
    print(f"max|err| {err} gray levels")
    assert err <= 1
