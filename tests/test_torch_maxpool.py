"""The max-pool route (``vinet_tpu_torch/ops/maxpool.py``) on the CPU: every
pool geometry the port meets, through ``MaxPool3d`` and ``max_pool3d``,
against ``F.max_pool3d``; the route's decisions; the wrapper's checks; the call
sites that hold the routed pool; and the benchmark's reader of the pools'
roofline share. The kernel itself is compared with
``F.max_pool3d`` on the card in ``tests/test_torch_kernels.py``."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.models.avinet import AViNet
from vinet_tpu_torch.models.s3d import S3DBackbone, run_in_time
from vinet_tpu_torch.ops import maxpool

torch.set_num_threads(2)

# (name, x shape, kernel, stride, padding): each pool the port runs, at small
# shapes with odd H and W where the pool's input allows them
POOLS = [
    # S3D (models/s3d.py), a (2, 3, 16, 44, 76) clip's shapes, channels cut
    ("stem", (2, 4, 8, 23, 39), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("maxp2", (2, 6, 8, 11, 19), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("mixed_3b", (2, 6, 8, 7, 11), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("mixed_3c", (2, 8, 8, 7, 11), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("maxp3", (2, 5, 8, 7, 11), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("mixed_4b", (2, 5, 4, 5, 7), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("mixed_4c", (2, 6, 4, 5, 7), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("mixed_4d", (2, 6, 4, 5, 7), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("mixed_4e", (2, 6, 4, 5, 7), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("mixed_4f", (2, 7, 4, 5, 7), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("maxt4", (2, 9, 4, 5, 7), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ("maxp4", (2, 9, 2, 5, 7), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("mixed_5b", (2, 9, 2, 3, 3), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("mixed_5c", (2, 9, 2, 3, 3), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    # streaming timelines, dense in time (models/s3d.py::run_in_time)
    ("maxp3_dense", (4, 5, 9, 7, 11), (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    ("maxt4_dense", (8, 9, 5, 5, 7), (2, 1, 1), (1, 1, 1), (0, 0, 0)),
    # the live path's valid-in-time forms (models/s3d.py::run_in_time)
    ("live_mixed_valid", (4, 6, 6, 7, 11), (3, 3, 3), (1, 1, 1), (0, 1, 1)),
    ("live_maxp3_valid", (4, 5, 6, 7, 11), (3, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("live_maxt4_valid", (8, 9, 3, 5, 7), (2, 1, 1), (1, 1, 1), (0, 0, 0)),
    # AViNet's fusion pool (models/avinet.py)
    ("avinet_fusion", (2, 16, 4, 3, 5), (4, 1, 1), (2, 1, 2), (0, 0, 0)),
]
IDS = [p[0] for p in POOLS]


def _x(shape, dtype, seed=0, nans=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    if nans:
        flat = x.view(-1)
        flat[torch.randint(0, flat.numel(), (nans,), generator=g)] = float("nan")
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,shape,kernel,stride,padding", POOLS, ids=IDS)
def test_routed_module_equals_f_max_pool3d(name, shape, kernel, stride, padding, dtype):
    x = _x(shape, dtype)
    before = maxpool.launches
    got = maxpool.MaxPool3d(kernel, stride, padding)(x)
    assert maxpool.launches == before
    assert got.shape == (*shape[:2], *maxpool.out_size(shape, kernel, stride, padding))
    assert torch.equal(got, F.max_pool3d(x, kernel, stride, padding))
    assert torch.equal(maxpool.max_pool3d(x, kernel, stride, padding), got)


@pytest.mark.parametrize("name,shape,kernel,stride,padding", POOLS, ids=IDS)
def test_nan_propagates_through_the_route(name, shape, kernel, stride, padding):
    x = _x(shape, torch.bfloat16, seed=1, nans=3)
    got = maxpool.MaxPool3d(kernel, stride, padding)(x)
    want = F.max_pool3d(x, kernel, stride, padding)
    assert bool(torch.isnan(got).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(maxpool, "max_pool3d_cuda", lambda *a, **k: pytest.fail("launched"))
    x = _x((2, 3, 4, 9, 11), torch.bfloat16)
    assert not maxpool.routes(x) and maxpool.kernel_takes(x)
    with torch.no_grad():
        got = maxpool.max_pool3d(x, 3, 1, 1)
    assert torch.equal(got, F.max_pool3d(x, 3, 1, 1))


def test_a_tensor_requiring_grad_keeps_f_max_pool3d_and_gets_its_gradient():
    x = _x((2, 3, 4, 9, 11), torch.float32).requires_grad_()
    assert not maxpool.kernel_takes(x)  # autograd would record: F.max_pool3d
    with torch.no_grad():
        assert maxpool.kernel_takes(x)  # nothing records: the kernel on the card
    assert not maxpool.kernel_takes(x.detach().double())  # not the kernel's dtype
    maxpool.MaxPool3d(3, 2, 1)(x).sum().backward()
    want = x.detach().clone().requires_grad_()
    F.max_pool3d(want, 3, 2, 1).sum().backward()
    assert x.grad is not None and torch.equal(x.grad, want.grad)


@pytest.mark.parametrize("setting", [{"dilation": 2}, {"ceil_mode": True},
                                     {"return_indices": True}])
def test_other_module_settings_keep_the_modules_own_forward(setting, monkeypatch):
    monkeypatch.setattr(maxpool, "max_pool3d", lambda *a, **k: pytest.fail("routed"))
    x = _x((1, 2, 6, 9, 11), torch.float32)
    pool = maxpool.MaxPool3d(2, 2, 0, **setting)
    got = pool(x)
    want = nn.MaxPool3d(2, 2, 0, **setting)(x)
    for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,error", [
    ("shape", ValueError), ("padding", ValueError), ("small", ValueError),
    ("dtype", TypeError), ("device", ValueError)])
def test_cuda_entry_rejects_what_the_kernel_does_not_take(case, error):
    x, k, p = _x((1, 2, 3, 5, 7), torch.bfloat16), (3, 3, 3), (1, 1, 1)
    if case == "shape":
        x = x[0]
    elif case == "padding":  # more than half the window, as F.max_pool3d refuses
        p = (2, 1, 1)
    elif case == "small":
        k, p = (4, 1, 1), (0, 0, 0)
    elif case == "dtype":
        x = x.half()
    before = maxpool.launches
    with pytest.raises(error):
        maxpool.max_pool3d_cuda(x, k, 1, p)
    assert maxpool.launches == before


def test_cuda_entry_refuses_autograd_first():
    x = _x((1, 2, 3, 5, 7), torch.float32).requires_grad_()
    with pytest.raises(RuntimeError, match="max_pool3d_cuda has no backward"):
        maxpool.max_pool3d_cuda(x, 3, 1, 1)


def _pools(module):
    return [m for m in module.modules() if isinstance(m, nn.MaxPool3d)]


def test_every_s3d_pool_is_the_routed_module():
    pools = _pools(S3DBackbone())
    assert len(pools) == 14  # stem, maxp2, nine Mixed branch3, maxp3, maxt4, maxp4
    assert all(type(m) is maxpool.MaxPool3d for m in pools)
    assert all(not m.state_dict() for m in pools)


def test_the_streaming_live_and_fusion_pools_are_routed(monkeypatch):
    """The streaming (dense) and live (valid) forms of maxp3 and maxt4 take
    the route with time stride 1, maxp3 with its time padding or without."""
    backbone = S3DBackbone()
    assert type(backbone.maxp3) is type(backbone.maxt4) is maxpool.MaxPool3d
    fusion = AViNet(input_hw=(64, 96)).maxpool
    assert type(fusion) is maxpool.MaxPool3d
    assert (fusion.kernel_size, fusion.stride) == ((4, 1, 1), (2, 1, 2))
    calls = []
    monkeypatch.setattr(maxpool, "max_pool3d",
                        lambda x, k, s, p: calls.append((k, s, p)) or F.max_pool3d(x, k, s, p))
    x = _x((4, 5, 6, 7, 11), torch.bfloat16)
    for form, pt in (("dense", 1), ("valid", 0)):
        y, r = run_in_time(backbone.maxp3, x, form)
        assert calls.pop() == ((3, 3, 3), (1, 2, 2), (pt, 1, 1)) and r == 1
        assert torch.equal(y, F.max_pool3d(x, 3, (1, 2, 2), (pt, 1, 1)))
        y, r = run_in_time(backbone.maxt4, x, form)
        assert calls.pop() == ((2, 1, 1), (1, 1, 1), (0, 0, 0)) and r == 0
        assert torch.equal(y, F.max_pool3d(x, (2, 1, 1), 1, 0))
    assert not calls


def _roofline_reader():
    from portbench import core

    path = core.ROOT / "portbench" / "layer_metrics" / "maxpool_roofline.parity.py"
    spec = importlib.util.spec_from_file_location("maxpool_roofline_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_reader_counts_the_pools_the_backbone_runs():
    """The benchmark's byte count walks S3D's fourteen pools: the shapes it
    assumes are those the port's backbone pools at a small clip, and at the
    parity cell's window batch they move 3.155 GB."""
    mod = _roofline_reader()
    seen = []
    backbone = S3DBackbone().eval()
    for m in _pools(backbone):
        m.register_forward_hook(lambda m, i, o: seen.append(
            (i[0].shape[1], tuple(i[0].shape[2:]), tuple(o.shape[2:]))))
    with torch.no_grad():
        backbone(torch.zeros(1, 3, 16, 64, 96))
    assert seen == mod.pools(16, 64, 96)
    cfg = {"clip_size": 32, "input_h": 224, "input_w": 384}
    assert 16 * mod.window_bytes(cfg) == 3_155_066_880


def test_roofline_reader_reads_the_pool_kernels_time(monkeypatch):
    mod = _roofline_reader()
    cfg = {"clip_size": 32, "input_h": 224, "input_w": 384}
    trace = SimpleNamespace(kernels=[("void maxpool3d_rows<1>(...)", 0.0, 1e-3),
                                     ("max_pool3d_with_indices_single_out_frame", 0.0, 5e-3)],
                            spans=[("engine.run_batch", 0.0, 0.08)])
    ctx = {"trace": trace, "cell": SimpleNamespace(config=cfg)}
    monkeypatch.setattr(mod.spans, "program_records",
                        lambda: [{"name": "engine.run_batch", "attrs": {"rows": 16}}])
    monkeypatch.setattr(maxpool, "launches", 0)
    assert mod.read(ctx) is None  # no launch: nothing to read
    monkeypatch.setattr(maxpool, "launches", 14)
    assert mod.read({**ctx, "trace": None}) is None
    assert mod.read(ctx) == pytest.approx(100.0 * 3_155_066_880 / 3.35e12 / 1e-3)
    trace.kernels = trace.kernels[1:]  # PyTorch's pool alone
    assert mod.read(ctx) is None
