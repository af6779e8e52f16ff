"""The stem convolution's route (``vinet_tpu_torch/ops/stemconv.py``) on the
CPU: the plain version against float64; the route's decisions; the wrapper's
checks; the parity, streaming and live paths, which take the route, with
their outputs unchanged; and the benchmark's reader of the stem's roofline share. The
kernel itself is compared with its plain version on the card in
``tests/test_torch_kernels.py``."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.inference import streaming
from vinet_tpu_torch.models.inference import cast_floating, fold_batchnorms
from vinet_tpu_torch.models.layers import SepConv3d
from vinet_tpu_torch.models.s3d import S3DBackbone, run_in_time
from vinet_tpu_torch.ops import stemconv
from vinet_tpu_torch.ops.quant import QuantConv3d

torch.set_num_threads(2)


def _args(shape=(2, 3, 3, 13, 17), dtype=torch.float32, seed=0, bias=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    w = torch.randn((64, 3, 1, 7, 7), generator=g) / 147 ** 0.5
    b = torch.randn((64,), generator=g) * 0.3 if bias else None
    return tuple(None if t is None else t.to(dtype) for t in (x, w, b))


def _stem(dtype=torch.bfloat16, fold=True):
    torch.manual_seed(0)
    sep = SepConv3d(3, 64, 7, 2, 3).eval()
    if fold:
        sep.fold_bn()
    return sep.to(dtype)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 3, 13, 17), (1, 3, 2, 1, 1), (1, 3, 1, 8, 30)])
def test_plain_version_is_relu_of_the_float64_conv(shape, bias):
    x, w, b = _args(shape, bias=bias)
    got = stemconv.stemconv_plain(x, w, b)
    want = torch.relu(F.conv3d(x.double(), w.double(), None if b is None else b.double(),
                               stride=(1, 2, 2), padding=(0, 3, 3)))
    assert got.dtype == torch.float32
    assert got.shape == (shape[0], 64, shape[2], *stemconv.out_hw(*shape[3:]))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_plain_version_keeps_bf16():
    x, w, b = _args(dtype=torch.bfloat16)
    got = stemconv.stemconv_plain(x, w, b)
    assert got.dtype == torch.bfloat16 and bool((got >= 0).all())
    want = torch.relu(F.conv3d(x.double(), w.double(), b.double(), stride=(1, 2, 2),
                               padding=(0, 3, 3)))
    torch.testing.assert_close(got.double(), want, rtol=2 ** -6, atol=2 ** -6)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch(monkeypatch):
    monkeypatch.setattr(stemconv, "stemconv_cuda", lambda *a: pytest.fail("launched"))
    x, w, b = _args(dtype=torch.bfloat16)
    before = stemconv.launches
    assert torch.equal(stemconv.stemconv(x, w, b), stemconv.stemconv_plain(x, w, b))
    sep = _stem()
    with torch.no_grad():
        assert stemconv.kernel_takes(sep, x) and not stemconv.routes(sep, x)
        got = stemconv.sep_spatial(sep, x)
    assert stemconv.launches == before
    assert torch.equal(got, torch.relu(sep.conv_s(x)))


def test_route_decisions():
    """The kernel takes the stem folded, bf16 and outside autograd; f32, an
    unfolded BatchNorm, parameters autograd records, a QuantConv3d and every
    other SepConv3d of S3D keep the module's expression."""
    x = _args(dtype=torch.bfloat16)[0]
    sep = _stem()
    with torch.no_grad():
        assert stemconv.kernel_takes(sep, x)
        assert not stemconv.kernel_takes(sep, x.float())  # the dtype
        assert not stemconv.kernel_takes(_stem(torch.float32), x.float())
        assert not stemconv.kernel_takes(_stem(fold=False), x)  # bn_s unfolded
    assert not stemconv.kernel_takes(sep, x)  # its parameters require grad: a train step
    sep.requires_grad_(False)
    assert stemconv.kernel_takes(sep, x)
    assert not stemconv.kernel_takes(sep, x.clone().requires_grad_())
    quant = _stem()
    quant.conv_s = QuantConv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=True)  # the int8 path
    with torch.no_grad():
        assert not stemconv.kernel_takes(quant, x)
    backbone = cast_floating(fold_batchnorms(S3DBackbone().eval()), torch.bfloat16)
    seps = [m for m in backbone.modules() if isinstance(m, SepConv3d)]
    assert len(seps) == 20  # the stem, sep192 and two in each of nine Mixed blocks
    assert [stemconv.stem_form(m) for m in seps] == [True] + [False] * 19
    assert seps[0] is backbone.base1[0]


@pytest.mark.parametrize("case,error", [
    ("x_channels", ValueError), ("w_shape", ValueError), ("bias_shape", ValueError),
    ("x_dims", ValueError), ("dtype", TypeError), ("bias_dtype", TypeError),
    ("device", ValueError), ("w_device", ValueError)])
def test_cuda_entry_rejects_what_the_kernel_does_not_take(case, error):
    x, w, b = _args(dtype=torch.bfloat16)
    if case == "x_channels":
        x = torch.cat([x, x[:, :1]], dim=1)
    elif case == "w_shape":
        w = w[:, :, :, :5, :5]
    elif case == "bias_shape":
        b = b[:32]
    elif case == "x_dims":
        x = x[0]
    elif case == "dtype":
        x = x.half()
    elif case == "bias_dtype":
        b = b.float()
    elif case == "w_device":
        w = w.to("meta")
    before = stemconv.launches
    with pytest.raises(error):
        stemconv.stemconv_cuda(x, w, b)
    assert stemconv.launches == before


def test_cuda_entry_refuses_autograd_first():
    x, w, b = _args(dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="stemconv_cuda has no backward"):
        stemconv.stemconv_cuda(x, w.requires_grad_(), b)


def _hooked(monkeypatch):
    """Route every sep_spatial call through a hook that records the module
    and checks the result against the expression the call sites held
    before the route: relu(bn_s(conv_s(x)))."""
    calls = []
    routed = stemconv.sep_spatial

    def hook(sep, x):
        y = routed(sep, x)
        calls.append(sep)
        assert torch.equal(y, torch.relu(sep.bn_s(sep.conv_s(x))))
        return y

    monkeypatch.setattr(stemconv, "sep_spatial", hook)
    return calls


def test_parity_forward_takes_the_route_and_keeps_its_output(monkeypatch):
    """SepConv3d.forward (parity, serve, TASEDv2): every S3D SepConv3d goes
    through the route, the stem first, and its output is the one before."""
    backbone = fold_batchnorms(S3DBackbone().eval())
    calls = _hooked(monkeypatch)
    x = _args((1, 3, 8, 32, 32))[0]
    stem = backbone.base1[0]
    with torch.no_grad():
        got = stem(x)
        want = torch.relu(stem.bn_t(stem.conv_t(torch.relu(stem.bn_s(stem.conv_s(x))))))
        assert torch.equal(got, want)
        backbone(x)
    assert calls[0] is stem and calls[1] is stem and len(calls) == 1 + 20


def test_streaming_pyramid_takes_the_route_for_the_stem(monkeypatch):
    backbone = fold_batchnorms(S3DBackbone().eval())
    calls = _hooked(monkeypatch)
    with torch.no_grad():
        streaming.streaming_pyramid(backbone, _args((1, 3, 8, 32, 32))[0])
    assert calls[0] is backbone.base1[0] and len(calls) == 20


def test_live_segment_a_takes_the_route_with_its_valid_in_time_conv(monkeypatch):
    """run_in_time(stem, x, "valid"), live's segment A: the spatial half
    through the route, the temporal half without its time padding; the
    radius and the output as before."""
    backbone = fold_batchnorms(S3DBackbone().eval())
    stem = backbone.base1[0]
    calls = _hooked(monkeypatch)
    x = _args((2, 3, 9, 32, 32))[0]
    with torch.no_grad():
        y, r = run_in_time(stem, x, "valid")
        s = torch.relu(F.conv3d(x, stem.conv_s.weight, stem.conv_s.bias, stride=(1, 2, 2),
                                padding=(0, 3, 3)))
        t = F.conv3d(s, stem.conv_t.weight, stem.conv_t.bias, stride=1, padding=0)
    assert calls == [stem] and r == 3
    assert torch.equal(y, torch.relu(t))


def _roofline_reader():
    from portbench import core

    path = core.ROOT / "portbench" / "layer_metrics" / "stem_roofline.parity.py"
    spec = importlib.util.spec_from_file_location("stem_roofline_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_reader_counts_the_stem_the_backbone_runs(monkeypatch):
    """The benchmark's byte count is the stem's hooked input and output, in
    bf16, at a small clip; at the parity cell's window batch of 16 the stem
    moves 1.674 GB and computes 207.2 GFLOP."""
    mod = _roofline_reader()
    seen = []
    routed = stemconv.sep_spatial
    monkeypatch.setattr(stemconv, "sep_spatial", lambda sep, x: seen.append(
        (x.shape, sep.conv_s.weight.numel())) or routed(sep, x))
    backbone = cast_floating(fold_batchnorms(S3DBackbone().eval()), torch.bfloat16)
    cfg = {"clip_size": 8, "input_h": 32, "input_w": 64}
    out = []
    backbone.base1[0].conv_s.register_forward_hook(lambda m, i, o: out.append(o.shape))
    with torch.no_grad():
        backbone(torch.zeros((1, 3, 8, 32, 64), dtype=torch.bfloat16))
    (x_shape, w_numel), o_shape = seen[0], out[0]
    nbytes, flops = mod.window_bytes_flops(cfg)
    assert nbytes == 2 * (x_shape.numel() + o_shape.numel())
    assert flops == 2 * o_shape.numel() * w_numel // 64
    parity = {"clip_size": 32, "input_h": 224, "input_w": 384}
    nbytes, flops = mod.window_bytes_flops(parity)
    assert 16 * nbytes == 1_673_527_296 and 16 * flops == 207_165_063_168


def test_roofline_reader_reads_the_stem_kernels_time(monkeypatch):
    mod = _roofline_reader()
    cfg = {"clip_size": 32, "input_h": 224, "input_w": 384}
    trace = SimpleNamespace(kernels=[("void stemconv_bf16_kernel<true, true>(...)", 0.0, 1e-3),
                                     ("sm80_xmma_fprop_implicit_gemm_indexed_f32f32", 0.0, 5e-3)],
                            spans=[("engine.run_batch", 0.0, 0.05)])
    ctx = {"trace": trace, "cell": SimpleNamespace(config=cfg)}
    monkeypatch.setattr(mod.spans, "program_records",
                        lambda: [{"name": "engine.run_batch", "attrs": {"rows": 16}}])
    monkeypatch.setattr(stemconv, "launches", 0)
    assert mod.read(ctx) is None  # no launch: nothing to read
    monkeypatch.setattr(stemconv, "launches", 1)
    assert mod.read({**ctx, "trace": None}) is None
    least = (1_673_527_296 + 2 * (64 * 147 + 64)) / 3.35e12
    assert mod.read(ctx) == pytest.approx(100.0 * least / 1e-3)
    trace.kernels = trace.kernels[1:]  # cuDNN's kernel alone
    assert mod.read(ctx) is None


def test_the_stem_is_the_only_sepconv_of_its_form_in_each_model():
    """Every model built on S3D routes one SepConv3d, its stem: ViNet,
    AViNet and TASEDv2 (the streaming and live paths run the same modules)."""
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.models.avinet import AViNet
    from vinet_tpu_torch.models.tased import TASEDv2

    for model in (ViNet(3, 32), AViNet(input_hw=(64, 96)), TASEDv2()):
        seps = [m for m in fold_batchnorms(model.eval()).modules() if isinstance(m, SepConv3d)]
        assert sum(stemconv.stem_form(m) for m in seps) == 1, type(model).__name__


def test_a_replaced_conv_s_runs_its_own_forward(monkeypatch):
    """A SepConv3d whose conv_s is another module (the int8 path puts a
    QuantConv3d there) runs that module's forward, never the stem kernel."""
    monkeypatch.setattr(stemconv, "stemconv", lambda *a: pytest.fail("routed"))
    sep = _stem(torch.float32)
    sep.conv_s = nn.Identity()
    x = _args((1, 3, 2, 9, 9))[0]
    with torch.no_grad():
        assert not stemconv.stem_form(sep)
        assert torch.equal(stemconv.sep_spatial(sep, x), torch.relu(x))
