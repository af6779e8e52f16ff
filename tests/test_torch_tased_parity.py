"""TASEDv2 on the port's parity path (``models/tased.py``,
``cli/common.py::build_model``, ``inference/engine.py``) against the
benchmark's plain reference ``portbench/reference/tased.py::RefTASED`` on the
CPU, at small sizes, in f32: the folded model's maps, the fold of a
ConvTranspose3d's BatchNorm, the CLI's model choice and its refusals, the
sliding windows' uint8 maps, the operation count, the ``tased.forward-b8``
cell end to end, the ``tased.decode`` span and the decoder roofline's
reader. The JAX-parity tests of TASEDv2 are ``tests/test_torch_tased.py``."""

import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

import portbench.run as run
from portbench import core, counts_tased
from portbench.drivers import tased as drivers_tased
from portbench.drivers.parity import window_clip
from portbench.reference.post import normalise, post
from portbench.reference.tased import RefTASED
from portbench.tests.helpers import small_cell
from tests.torch_port_util import TORCH_THREADS
from vinet_tpu_torch.cli.common import build_model
from vinet_tpu_torch.cli.generate_result import build_parser, main
from vinet_tpu_torch.inference import SlidingWindowPredictor
from vinet_tpu_torch.models import TASEDv2, fold_batchnorms, tased
from vinet_tpu_torch.utils import trace

torch.set_num_threads(TORCH_THREADS)


def _clips(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 32, h, w, 3), generator=g) * 4.0 - 2.0


@pytest.fixture(scope="module")
def weights():
    """The ``tased`` configuration's weights at 64 x 96 (the benchmark's
    ``drivers/tased.py::weights``): S3D from the fixture, the decoder seeded,
    its BatchNorm not the identity (weight 1 + N(0, 0.1²), bias N(0, 0.1²),
    running statistics those of one train-mode pass over two seeded clips,
    so every layer's output stays of unit scale and the maps are not
    flat)."""
    cfg = core.load_json(core.BENCH_DIR / "configs" / "tased.json")
    cfg.update(input_h=64, input_w=96)
    return drivers_tased.weights(SimpleNamespace(config=cfg, seed=20, device="cpu"))


def _reference(weights):
    ref = RefTASED()
    ref.load_state_dict(weights, strict=True)
    return ref.eval()


def _folded_port(weights):
    model = TASEDv2()
    model.load_state_dict(weights, strict=True)
    return fold_batchnorms(model.eval())


def test_folded_port_matches_the_reference(weights):
    """Folded f32 port against the unfolded f32 reference at 32 x 64 x 96.
    Both compute the same f32 maths in other orders (the fold multiplies
    the BatchNorm scale into the weights): about 70 convolutions of f32
    rounding, which reaches about 1e-5 on the sigmoid maps (4e-6 to 9e-6 at
    three seeds); 1e-4 leaves room and still fails a wrong fold, which moves
    the maps by 1e-2 and more."""
    model = _folded_port(weights)
    assert not [m for m in model.modules() if isinstance(m, nn.BatchNorm3d)]
    x = _clips(1, 64, 96, 2)
    tased.folded_calls = 0
    with torch.no_grad():
        got = model(x)
        want = _reference(weights)(x.permute(0, 4, 1, 2, 3))
    assert tased.folded_calls == 5  # the five ConvTranspose3d that had a BatchNorm
    assert got.shape == want.shape == (1, 64, 96)
    assert float(want.std()) > 1e-3  # not flat
    assert torch.allclose(got, want, atol=1e-4, rtol=0), float((got - want).abs().max())


def test_transposed_fold_is_exact_at_f32():
    """A ConvTranspose3d (I 6 != O 4) + BatchNorm folds within 1e-5: the
    scale on the weight's dim 1 (O), the shift into the new bias."""
    torch.manual_seed(3)
    stage = tased.DecoderStage(*tased._ct_block(6, 4))
    bn = stage[1]
    with torch.no_grad():
        bn.weight.copy_(torch.rand(4) + 0.5)
        bn.bias.copy_(torch.randn(4))
        bn.running_mean.copy_(torch.randn(4))
        bn.running_var.copy_(torch.rand(4) + 0.5)
    stage.eval()
    x = torch.randn(2, 6, 2, 5, 7)
    with torch.no_grad():
        want = stage(x)
        stage.fold_bn()
        got = stage(x)
    assert isinstance(stage[1], nn.Identity) and stage[0].bias.shape == (4,)
    assert torch.allclose(got, want, atol=1e-5, rtol=0), float((got - want).abs().max())


def _args(*extra):
    return build_parser().parse_args(["--path_indata", "-", "--save_path", "-", "--device",
                                      "cpu", *extra])


def test_build_model_builds_tased():
    assert isinstance(build_model(_args("--model", "tased")), TASEDv2)
    assert not isinstance(build_model(_args()), TASEDv2)


@pytest.mark.parametrize("args, message", [
    (dict(clip_size=16), "--clip_size 32"),
    (dict(use_sound=True), "no --use_sound"),
    (dict(dtype="int8"), "no int8"),
])
def test_build_model_refuses_what_tased_cannot_do(args, message):
    ns = vars(_args("--model", "tased"))
    with pytest.raises(ValueError, match=message):
        build_model(SimpleNamespace(**{**ns, **args}))


def test_cli_refuses_tased_off_the_sliding_windows(capsys):
    with pytest.raises(SystemExit):
        main(["--path_indata", "-", "--save_path", "-", "--model", "tased", "--streaming"])
    assert "sliding windows only" in capsys.readouterr().err


def test_predict_video_matches_the_reference_windows(weights):
    """The sliding windows of a 63-frame video (32 causal, 31 flipped
    warm-up) at 32 x 32 through the predictor: the uint8 maps at 36 x 48
    against RefTASED's per window (the flipped window, resize, blur, min-max
    and rounding of ``reference/post.py``) within one grey level (f32 sums
    in other orders can cross a rounding step). Then one window batch under
    a profiler: its ``tased.decode`` span inside ``engine.run_batch``, with
    the video's request and the batch's rows."""
    g = np.random.default_rng(5)
    video = g.integers(0, 256, (63, 32, 32, 3), dtype=np.uint8)
    model = TASEDv2()
    model.load_state_dict(weights, strict=True)
    pred = SlidingWindowPredictor(model, clip_size=32, batch=8, dtype=torch.float32,
                                  device="cpu")
    maps = dict(pred.predict_video(video, out_size=(36, 48), quantize_u8=True))
    assert sorted(maps) == list(range(63))
    frames = [0, 17, 30, 31, 45, 62]
    ref = _reference(weights)
    with torch.no_grad():
        x = torch.stack([normalise(torch.from_numpy(np.ascontiguousarray(
            window_clip(video, f, 32)))) for f in frames])
        want = post(ref(x), (36, 48)).numpy()
    got = np.stack([maps[f] for f in frames])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    trace.clear()
    idx = torch.arange(32).repeat(8, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.run_batch(torch.from_numpy(video), idx, (36, 48), True)
    assert {"engine.run_batch", "tased.decode"} <= {e.name for e in prof.events()}
    (decode,) = [r for r in trace.records() if r["name"] == "tased.decode"]
    assert (decode["parent"], decode["request"], decode["attrs"]) == \
        ("engine.run_batch", 0, {"rows": 8})
    trace.clear()


def test_window_flops_match_the_reference():
    cfg = {"clip_size": 32, "input_h": 64, "input_w": 96}
    model = RefTASED().eval()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(torch.zeros(1, 3, 32, 64, 96))
    assert counts_tased.window_flops(cfg) == fc.get_total_flops()
    full = {"clip_size": 32, "input_h": 224, "input_w": 384}
    assert counts_tased.decoder_flops(224, 384) == 52_090_601_472
    assert counts_tased.window_flops(full) == 175_370_797_056


def _roofline_reader():
    path = core.ROOT / "portbench" / "layer_metrics" / "decoder_roofline.tased.py"
    spec = importlib.util.spec_from_file_location("decoder_roofline_tased", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decoder_roofline_reader(monkeypatch):
    """The reader divides the decoder's least time for each traced span's
    rows by the spans' device time, and reads nothing without the folded
    route's calls or a span."""
    mod = _roofline_reader()
    cfg = {"clip_size": 32, "input_h": 224, "input_w": 384}
    trace_ = SimpleNamespace(spans=[("tased.decode", 0.0, 0.001), ("tased.decode", 0.1, 0.001)])
    ctx = {"trace": trace_, "cell": SimpleNamespace(config=cfg)}
    recs = [{"name": "tased.decode", "attrs": {"rows": 8}, "device_ms": 5.0}] * 3
    monkeypatch.setattr(mod.spans, "program_records", lambda: recs)
    monkeypatch.setattr(tased, "folded_calls", 0)
    assert mod.read(ctx) is None
    monkeypatch.setattr(tased, "folded_calls", 10)
    assert mod.read({**ctx, "trace": None}) is None
    least = counts_tased.decoder_least_s(cfg, 8)
    assert mod.read(ctx) == pytest.approx(100.0 * 2 * least / 10e-3)
    # at least the operations over the bf16 peak; the small convs bind by bytes
    assert 8 * 52_090_601_472 / 989e12 < least < 1.2 * 8 * 52_090_601_472 / 989e12


def test_cell_runs_on_the_cpu():
    """``tased.forward-b8`` end to end (set-up, window, check) at 32 x 32,
    one 63-frame video, in f32: correct, with its end-to-end metrics."""
    cell = small_cell("tased.forward-b8")
    cell.config.update({"input_h": 32, "input_w": 32, "frame_h": 36, "frame_w": 36})
    cell.traffic.update({"lengths": [63], "window_batch": 8, "sample_maps": 4})
    out = run.measure(cell)
    assert out["correct"], out
    assert set(out["metrics"]) == {"maps_per_s", "setup_s"}
    assert out["attempted"] == 63 and out["failed"] == 0
