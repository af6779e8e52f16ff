"""The ReLU + 2x upsample route (``vinet_tpu_torch/ops/upsample.py``) on the
CPU: the plain version against the upsample's arithmetic in float64 at the
decoder's shapes, cut down; the route's decisions; the wrapper's checks; the
call sites, whose outputs on the CPU stay what the stages' ``Sequential``s
gave them; and the benchmark's reader of the kernel's roofline share. The
kernel itself is compared with ``F.interpolate(torch.relu(x))`` on the card
in ``tests/test_torch_kernels.py``."""

import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vinet_tpu_torch.models.decoder as decoder_module
from vinet_tpu_torch.inference import streaming
from vinet_tpu_torch.models import Decoder, ViNet, decoder_plan
from vinet_tpu_torch.models.decoder import run_stage
from vinet_tpu_torch.ops import upsample

torch.set_num_threads(2)

# (name, x shape): the decoder's upsample inputs with channels cut (conv1's
# 7 x 12, conv2's 14 x 24, conv3's 28 x 48 at 224 x 384), odd H and W, and
# H or W of 1, 2 and 3
SHAPES = [
    ("conv1", (2, 6, 4, 7, 12)),
    ("conv2", (2, 5, 4, 14, 24)),
    ("conv3", (1, 3, 4, 28, 48)),
    ("odd", (2, 3, 3, 7, 11)),
    ("h1", (1, 2, 2, 1, 5)),
    ("w1", (1, 2, 2, 5, 1)),
    ("h2_w2", (1, 2, 2, 2, 2)),
    ("h3_w3", (1, 2, 1, 3, 3)),
    ("one", (1, 1, 1, 1, 1)),
]
IDS = [s[0] for s in SHAPES]


def _x(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _up1d(x, dim):
    """x doubled along dim: output 2i = 0.25 x[i - 1] + 0.75 x[i] (x[0] at
    i = 0), output 2i + 1 = 0.75 x[i] + 0.25 x[i + 1] (x[n - 1] at the end)."""
    n = x.shape[dim]
    i = torch.arange(n)
    prev = x.index_select(dim, (i - 1).clamp(min=0))
    nxt = x.index_select(dim, (i + 1).clamp(max=n - 1))
    return torch.stack([0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt], dim + 1).flatten(dim,
                                                                                      dim + 1)


def _reference(x):
    """relu, then the 2x upsample of H and W, in float64."""
    return _up1d(_up1d(torch.relu(x.double()), 3), 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,shape", SHAPES, ids=IDS)
def test_plain_version_is_relu_then_the_half_pixel_upsample(name, shape, dtype):
    """The plain version is F.interpolate(torch.relu(x)), and its arithmetic
    is the kernel's: weights 0.75 / 0.25, half-pixel centres, clamped edges,
    time untouched; within one rounding to x's dtype of float64."""
    x = _x(shape, dtype)
    got = upsample.relu_up2x_plain(x)
    assert got.dtype == dtype and got.shape == (*shape[:3], 2 * shape[3], 2 * shape[4])
    assert torch.equal(got, F.interpolate(torch.relu(x), scale_factor=(1, 2, 2),
                                          mode="trilinear", align_corners=False))
    want = _reference(x)
    step = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert float(((got.double() - want).abs() - step * want.abs()).max()) <= 1e-30
    assert bool((got >= 0).all())


def test_nan_propagates_through_the_plain_version():
    x = _x((1, 2, 2, 5, 7), torch.bfloat16)
    x[0, 1, 1, 2, 3] = float("nan")
    got = upsample.relu_up2x(x)
    nan = torch.isnan(got)
    assert bool(nan[0, 1, 1, 3:7, 5:9].all()) and int(nan.sum()) == 16  # its 4 x 4 outputs


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(upsample, "relu_up2x_cuda", lambda *a: pytest.fail("launched"))
    x = _x((2, 3, 4, 7, 12), torch.bfloat16)
    before = upsample.launches
    assert not upsample.routes(x) and upsample.kernel_takes(x)
    with torch.no_grad():
        got = upsample.relu_up2x(x)
    assert upsample.launches == before
    assert torch.equal(got, upsample.relu_up2x_plain(x))


def test_a_tensor_requiring_grad_keeps_the_plain_version_and_gets_its_gradient():
    x = _x((2, 3, 4, 5, 6), torch.float32).requires_grad_()
    assert not upsample.kernel_takes(x)  # autograd would record: the plain version
    with torch.no_grad():
        assert upsample.kernel_takes(x)  # nothing records: the kernel on the card
    for other in (torch.float16, torch.float64):
        assert not upsample.kernel_takes(x.detach().to(other))  # not the kernel's dtypes
    upsample.relu_up2x(x).square().sum().backward()
    want = x.detach().clone().requires_grad_()
    upsample.upsample2x_hw(torch.relu(want)).square().sum().backward()
    assert x.grad is not None and torch.equal(x.grad, want.grad)


def test_autocast_keeps_the_plain_version_with_autocasts_dtype():
    """Inside autocast the route gives the dtype and values that relu then
    F.interpolate give there (on the CPU autocast runs the upsample in
    f32)."""
    x = _x((2, 3, 4, 7, 12), torch.bfloat16)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        assert not upsample.kernel_takes(x)
        got = upsample.relu_up2x(x)
        want = F.interpolate(torch.relu(x), scale_factor=(1, 2, 2), mode="trilinear",
                             align_corners=False)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert upsample.kernel_takes(x)


@pytest.mark.parametrize("case,error", [("shape", ValueError), ("dtype", TypeError),
                                        ("device", ValueError)])
def test_cuda_entry_rejects_what_the_kernel_does_not_take(case, error):
    x = _x((1, 2, 3, 5, 7), torch.bfloat16)
    if case == "shape":
        x = x[0]
    elif case == "dtype":
        x = x.half()
    before = upsample.launches
    with pytest.raises(error):
        upsample.relu_up2x_cuda(x)
    assert upsample.launches == before


def test_cuda_entry_refuses_autograd_first():
    x = _x((1, 2, 3, 5, 7), torch.float32).requires_grad_()
    with pytest.raises(RuntimeError, match="relu_up2x_cuda has no backward"):
        upsample.relu_up2x_cuda(x)


def _decoder(dtype, seed=0):
    torch.manual_seed(seed)
    return Decoder(decoder_plan(3, 32)).eval().to(dtype)


def _pyramid(b, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    shapes = [(b, 1024, 4, 1, 2), (b, 832, 8, 2, 4), (b, 480, 16, 4, 8), (b, 192, 16, 8, 16)]
    return [torch.relu(torch.randn(s, generator=g)).to(dtype) for s in shapes]


def _sequential_front(dec, pyramid):
    """conv1-conv3's stages as the decoder ran them before the route: each
    stage's Sequential (conv, nn.ReLU, Upsample2x), skips on time."""
    y0, y1, y2, y3 = pyramid
    z = torch.cat([dec.convtsp1(y0), y1], dim=2)
    z = torch.cat([dec.convtsp2(z), y2], dim=2)
    return torch.cat([dec.convtsp3(z), y3], dim=2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_run_stage_gives_what_each_stages_sequential_gives(dtype):
    dec = _decoder(dtype)
    y0, y1, y2, _ = _pyramid(1, dtype)
    with torch.no_grad():
        z1 = run_stage(dec.convtsp1, y0)
        assert torch.equal(z1, dec.convtsp1(y0))
        z = torch.cat([z1, y1], dim=2)
        z2 = run_stage(dec.convtsp2, z)
        assert torch.equal(z2, dec.convtsp2(z))
        z = torch.cat([z2, y2], dim=2)
        assert torch.equal(run_stage(dec.convtsp3, z), dec.convtsp3(z))


def test_decoder_forward_in_eval_gives_what_the_sequentials_gave(monkeypatch):
    dec = _decoder(torch.bfloat16)
    pyr = _pyramid(2, torch.bfloat16)
    calls = []
    routed = decoder_module.relu_up2x
    monkeypatch.setattr(decoder_module, "relu_up2x",
                        lambda x: calls.append(tuple(x.shape)) or routed(x))
    with torch.no_grad():
        got = dec(pyr)
        z = _sequential_front(dec, pyr)
        want = dec.tail(torch.relu(dec.convtsp4[0](z)))
    assert calls == [(2, 832, 4, 1, 2), (2, 480, 4, 2, 4), (2, 192, 4, 4, 8)]
    assert got.shape == (2, 32, 64) and torch.equal(got, want)


def test_decoder_forward_in_train_gives_what_the_sequentials_gave():
    """The train graph: the same values and the same gradients as the stages'
    Sequentials and convtsp4's own Upsample2x modules."""
    dec = _decoder(torch.float32).train()
    pyr = _pyramid(1, torch.float32)
    got = dec(pyr)
    got.square().mean().backward()
    grads = [p.grad.clone() for p in dec.parameters()]
    dec.zero_grad()
    want = dec.convtsp4(_sequential_front(dec, pyr))[:, 0, 0]
    want.square().mean().backward()
    assert torch.equal(got, want)
    assert all(torch.equal(a, p.grad) for a, p in zip(grads, dec.parameters()))


@pytest.mark.parametrize("fused", [False, True])
def test_decode_windows_v2_gives_what_it_gave_before(fused, monkeypatch):
    """The windowed decode with relu_up2x at z3 (and at conv1 where y0 is
    fused per window, AViNet's form) gives what relu then upsample2x_hw gave
    there."""
    dec = _decoder(torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    n = 64  # a chunk's timelines
    shapes = [(8, 1024, n // 8, 1, 1), (4, 832, n // 4, 2, 2), (2, 480, n // 2, 4, 4),
              (2, 192, n // 2, 8, 8)]
    tl = [torch.relu(torch.randn(s, generator=g)).to(torch.bfloat16) for s in shapes]
    starts = torch.tensor([0, 5, 17, 32])
    y0 = streaming.gather_y0(tl[0], starts) if fused else None
    calls = []

    def run():
        with torch.no_grad():
            dense = streaming.dense_decoder_front(dec, tl, with_conv1=not fused)
            return streaming.decode_windows_v2(dec, tl, dense, starts, y0_fused=y0)

    for module in (streaming, decoder_module):
        routed = module.relu_up2x
        monkeypatch.setattr(module, "relu_up2x",
                            lambda x, routed=routed: calls.append(tuple(x.shape)) or routed(x))
    got = run()
    conv1 = [(4, 832, 4, 1, 1)] if fused else [(8, 832, 8, 1, 1)]
    assert calls == conv1 + [(4, 192, 4, 4, 4)]
    before = lambda x: upsample.upsample2x_hw(torch.relu(x))  # noqa: E731
    for module in (streaming, decoder_module):
        monkeypatch.setattr(module, "relu_up2x", before)
    assert got.shape == (4, 32, 32) and torch.equal(got, run())


def _roofline_reader():
    from portbench import core

    path = core.ROOT / "portbench" / "layer_metrics" / "upsample_roofline.parity.py"
    spec = importlib.util.spec_from_file_location("upsample_roofline_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_reader_counts_the_upsamples_the_decoder_runs(monkeypatch):
    """The benchmark's byte count walks the three stage upsamples: the shapes
    it assumes are those ViNet(3, 32) upsamples at a small clip, and at the
    parity cell's window batch of 16 they move 313.1 MB (19,568,640 bytes a
    window: 3,913,728 read, 15,654,912 written)."""
    mod = _roofline_reader()
    seen = []
    routed = decoder_module.relu_up2x
    monkeypatch.setattr(decoder_module, "relu_up2x",
                        lambda x: seen.append(tuple(x.shape[1:])) or routed(x))
    with torch.no_grad():
        ViNet(3, 32).eval()(torch.zeros(1, 32, 64, 96, 3))
    assert seen == mod.stages(32, 64, 96)
    cfg = {"clip_size": 32, "input_h": 224, "input_w": 384}
    assert mod.window_bytes(cfg) == 19_568_640
    assert 16 * mod.window_bytes(cfg) == 313_098_240


def test_roofline_reader_reads_the_kernels_time(monkeypatch):
    mod = _roofline_reader()
    cfg = {"clip_size": 32, "input_h": 224, "input_w": 384}
    trace = SimpleNamespace(
        kernels=[("void (anonymous namespace)::relu_up2x_kernel<unsigned short, 8>(...)", 0.0,
                  2e-4),
                 ("void at::native::upsample_trilinear3d_out_frame<c10::BFloat16, float>", 0.0,
                  8e-3)],
        spans=[("engine.run_batch", 0.0, 0.05)])
    ctx = {"trace": trace, "cell": SimpleNamespace(config=cfg)}
    monkeypatch.setattr(mod.spans, "program_records",
                        lambda: [{"name": "engine.run_batch", "attrs": {"rows": 16}}])
    monkeypatch.setattr(upsample, "launches", 0)
    assert mod.read(ctx) is None  # no launch: nothing to read
    monkeypatch.setattr(upsample, "launches", 3)
    assert mod.read({**ctx, "trace": None}) is None
    assert mod.read(ctx) == pytest.approx(100.0 * 313_098_240 / 3.35e12 / 2e-4)
    trace.kernels = trace.kernels[1:]  # PyTorch's upsample alone
    assert mod.read(ctx) is None
    monkeypatch.delattr(upsample, "launches")  # a program without the kernel
    assert mod.read(ctx) is None


def test_reference_helper_is_exact_on_a_ramp():
    """_up1d on a linear ramp gives the half-pixel positions' values, clamped
    at the ends: (0, 0.25, 0.75, 1.25, ..., n - 1.25, n - 1)."""
    x = torch.arange(5, dtype=torch.float64).reshape(1, 1, 1, 1, 5)
    got = _up1d(x, 4).flatten().numpy()
    want = np.clip((np.arange(10) + 0.5) / 2 - 0.5, 0, 4)
    np.testing.assert_array_equal(got, want)
