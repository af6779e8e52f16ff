"""vinet_tpu_torch's sliding-window engine and CLI against vinet_tpu's, the
device rule, and import hygiene (the port never imports JAX or vinet_tpu).

predict_video runs a stub model with the same trivial function on both sides
(sigmoid of the time- and channel-mean), so the test covers gather, flip,
padding, resize, blur and quantisation in seconds.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.fixtures import make_dhf1k
from tests.torch_port_util import TORCH_THREADS
from vinet_tpu.cli.common import shard_video_list as jax_shard_video_list
from vinet_tpu.inference.engine import SlidingWindowPredictor as JaxPredictor
from vinet_tpu.inference.engine import window_plan as jax_window_plan
from vinet_tpu_torch.cli.common import shard_video_list
from vinet_tpu_torch.cli.generate_result import main as generate_main
from vinet_tpu_torch.device import resolve_device
from vinet_tpu_torch.inference import SlidingWindowPredictor, window_plan

torch.set_num_threads(TORCH_THREADS)
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("t", [4, 32])
@pytest.mark.parametrize("pad_short", [False, True])
def test_window_plan_matches_jax(t, pad_short):
    for n in (1, 2 * t - 2, 2 * t - 1, 2 * t + 5):
        got = [(w.out_frame, w.start, w.flipped) for w in window_plan(n, t, pad_short=pad_short)]
        want = [(w.out_frame, w.start, w.flipped)
                for w in jax_window_plan(n, t, pad_short=pad_short)]
        assert got == want, n


class _JaxStub:
    def apply(self, params, state, x):
        return jax.nn.sigmoid(x.mean(axis=(1, 4))), state


class _TorchStub(torch.nn.Module):
    def forward(self, x):
        return torch.sigmoid(x.mean(dim=(1, 4)))


# (frames, out_size, pad_short, quantize): native size, upscale, downscale,
# and a video shorter than 2T-1 padded with its first frame
@pytest.mark.parametrize("n,out_size,pad_short,quantize", [
    (13, None, False, False),
    (13, (30, 44), False, True),
    (9, (11, 14), False, True),
    (5, (20, 30), True, True),
    (5, None, True, False),
])
def test_predict_video_matches_jax(n, out_size, pad_short, quantize):
    t, batch = 4, 3
    frames = np.random.default_rng(n).integers(0, 256, (n, 16, 24, 3), dtype=np.uint8)
    jp = JaxPredictor(_JaxStub(), {}, {}, clip_size=t, batch=batch, dtype=jnp.float32)
    want = list(jp.predict_video(frames, out_size=out_size, pad_short=pad_short,
                                 quantize_u8=quantize))
    tp = SlidingWindowPredictor(_TorchStub(), clip_size=t, batch=batch,
                                dtype=torch.float32, device="cpu")
    got = list(tp.predict_video(frames, out_size=out_size, pad_short=pad_short,
                                quantize_u8=quantize))
    assert [i for i, _ in got] == [i for i, _ in want]
    assert len(got) == n
    err = max(np.abs(g.astype(np.float64) - np.asarray(w, np.float64)).max()
              for (_, g), (_, w) in zip(got, want))
    print(f"max|err| {err:.3g}")
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape == (out_size or (16, 24))
        if quantize:
            assert g.dtype == np.uint8
            assert np.abs(g.astype(int) - np.asarray(w).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


def test_predict_video_skips_short_video_without_padding():
    tp = SlidingWindowPredictor(_TorchStub(), clip_size=4, batch=2, dtype=torch.float32,
                                device="cpu")
    frames = np.zeros((6, 8, 8, 3), np.uint8)
    assert list(tp.predict_video(frames)) == []


@pytest.mark.parametrize("start_idx,num_parts", [(-1, 4), (1, 4), (3, 4), (2, 3)])
def test_shard_video_list_matches_jax(start_idx, num_parts):
    names = [f"{i:03d}" for i in range(10)]
    assert shard_video_list(names, start_idx, num_parts) == \
        jax_shard_video_list(names, start_idx, num_parts)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlidingWindowPredictor(_TorchStub(), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("exact_quantize", [False, True])
def test_generate_result_cli_writes_a_map_per_frame(exact_quantize, tmp_path):
    """Maps quantised on the device, or in f64 on the host (--exact_quantize)."""
    data = make_dhf1k(str(tmp_path / "data"), n_videos=2, n_frames=16, size=(24, 40))
    out = tmp_path / "out"
    rc = generate_main(["--path_indata", data, "--save_path", str(out), "--clip_size", "8",
                        "--input_h", "32", "--input_w", "32", "--window_batch", "4",
                        "--dtype", "float32", "--device", "cpu"]
                       + (["--exact_quantize"] if exact_quantize else []))
    assert rc == 0
    for video in ("001", "002"):
        frames = sorted(os.listdir(os.path.join(data, video, "images")))
        written = sorted(os.listdir(out / video))
        assert written == frames and len(written) == 16
        from PIL import Image

        im = np.asarray(Image.open(out / video / written[0]))
        assert im.shape == (24, 40) and im.dtype == np.uint8 and im.max() == 255


@pytest.mark.slow
def test_generate_result_cli_matches_jax_cli(tmp_path):
    """Both CLIs with the fixture weights at f32 on one 63-frame video write
    the same PNGs, within one gray level (rounding ties)."""
    from PIL import Image

    from tests.torch_port_util import FIXTURE
    from vinet_tpu.cli.generate_result import main as jax_generate_main

    data = make_dhf1k(str(tmp_path / "data"), n_videos=1, n_frames=63, size=(40, 56))
    flags = ["--path_indata", data, "--file_weight", FIXTURE, "--clip_size", "32",
             "--input_h", "32", "--input_w", "32", "--window_batch", "4", "--dtype", "float32"]
    assert jax_generate_main(flags + ["--save_path", str(tmp_path / "jax")]) == 0
    assert generate_main(flags + ["--save_path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax" / "001"))
    assert names == sorted(os.listdir(tmp_path / "port" / "001")) and len(names) == 63
    err = max(np.abs(np.asarray(Image.open(tmp_path / "jax" / "001" / n), int)
                     - np.asarray(Image.open(tmp_path / "port" / "001" / n), int)).max()
              for n in names)
    print(f"max|err| {err} gray levels")
    assert err <= 1


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_vinet_tpu():
    # the port, its chip check, and the card tests that run where JAX is absent
    sources = sorted((REPO / "vinet_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_kernels.py",
        REPO / "tests" / "test_torch_maxpool.py", REPO / "tests" / "test_torch_stemconv.py",
        REPO / "tests" / "test_torch_run_in_time.py"]
    assert len(sources) > 10
    names = {p.relative_to(REPO / "vinet_tpu_torch").as_posix() for p in sources[:-5]}
    assert {"models/soundnet.py", "models/transformer.py", "models/avinet.py", "data/audio.py",
            "cli/generate_result_audio_visual.py", "cli/generate_result_dave.py",
            "cli/generate_theatre.py", "parallel/mesh.py", "parallel/partition.py",
            "parallel/collectives.py", "models/tased.py", "tools/validate_released.py",
            "ops/maxpool.py", "ops/stemconv.py"} <= names
    for path in sources:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "vinet_tpu", "flax", "optax"), (path, name)
    # the port's EMD is its own library, built from its own copy of the source
    from vinet_tpu_torch.metrics import emd

    lib = Path(emd._load_native()._name).resolve()
    assert emd.SOURCE == REPO / "vinet_tpu_torch" / "native" / "emd" / "emd_hat.cpp"
    assert lib.parent == REPO / "vinet_tpu_torch" / "_build" and lib.name.startswith("libemd_hat-")
    assert "native" not in lib.parts and not lib.is_relative_to(REPO / "vinet_tpu")


@pytest.mark.parametrize("kind", ["sliding", "streaming", "live", "serve"])
def test_predictors_leave_the_callers_model_untouched(kind):
    """A predictor folds, casts and moves a copy: the caller's model (here a
    model in training, unfolded, f32) keeps its parameters, dtype, BatchNorms
    and mode, as the JAX predictors leave (params, state)."""
    from vinet_tpu_torch.inference import (LiveStreamingPredictor, MultiLiveServer,
                                           StreamingPredictor)
    from vinet_tpu_torch.models import ViNet

    torch.manual_seed(0)
    model = ViNet(3, 32).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n_bn = sum(isinstance(m, torch.nn.BatchNorm3d) for m in model.modules())
    make = {"sliding": lambda: SlidingWindowPredictor(model, device="cpu"),
            "streaming": lambda: StreamingPredictor(model, device="cpu"),
            "live": lambda: LiveStreamingPredictor(model, device="cpu"),
            "serve": lambda: MultiLiveServer(model, streams=2, device="cpu")}[kind]
    pred = make()
    assert pred.model is not model and pred.model.backbone.base1[0].conv_s.weight.dtype == \
        torch.bfloat16
    assert model.training and all(m.training for m in model.modules())
    assert sum(isinstance(m, torch.nn.BatchNorm3d) for m in model.modules()) == n_bn
    after = model.state_dict()
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
