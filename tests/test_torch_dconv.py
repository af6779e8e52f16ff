"""The decoder-conv route (``vinet_tpu_torch/ops/dconv.py``) on the CPU: the
plain version against float64 ``F.conv3d``, the wrapper's checks, and the
call sites, whose outputs on the CPU stay what ``F.conv3d`` gave them. The
kernel itself is compared with the plain version on the card in
``tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from vinet_tpu_torch.inference import streaming
from vinet_tpu_torch.models import Decoder, decoder_plan
from vinet_tpu_torch.ops import dconv, quant
from vinet_tpu_torch.ops.phasefold import FoldedConvUp2x

torch.set_num_threads(2)


def _rand(rng, shape, scale=1.0, dtype=torch.float64):
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("stride_t", [1, 3, 5])
@pytest.mark.parametrize("kt", [1, 3, 5])
def test_dconv_plain_equals_float64_conv3d(kt, stride_t, padding, bias):
    rng = np.random.default_rng(kt * 100 + stride_t * 10 + padding)
    x = _rand(rng, (2, 8, 11, 5, 6))
    w = _rand(rng, (5, 8, kt, 3, 3))
    b = _rand(rng, (5,)) if bias else None
    pad_t = kt // 2
    got = dconv.dconv_plain(x, w, b, stride_t=stride_t, pad_t=pad_t, padding=padding)
    want = F.conv3d(x, w, b, stride=(stride_t, 1, 1), padding=(pad_t, padding, padding))
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _args(dtype=torch.bfloat16, device="cpu"):
    rng = np.random.default_rng(0)
    return (_rand(rng, (1, 8, 4, 5, 6), dtype=dtype).to(device),
            _rand(rng, (4, 8, 3, 3, 3), dtype=dtype).to(device))


@pytest.mark.parametrize("case,error", [
    ("dtype", TypeError), ("shape", ValueError), ("kernel", ValueError),
    ("channels", ValueError), ("bias", ValueError), ("padding", ValueError),
    ("small", ValueError), ("device", ValueError)])
def test_dconv_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    x, w = _args()
    kw = {}
    if case == "dtype":
        x, w = _args(torch.float32)
    elif case == "shape":
        x = x[0]
    elif case == "kernel":
        w = w[..., :2]
    elif case == "channels":  # C_in 4: the kernel needs a multiple of 8
        x, w = x[:, :4], w[:, :4]
    elif case == "bias":
        kw["bias"] = torch.zeros(3, dtype=torch.bfloat16)
    elif case == "padding":
        kw["padding"] = 2
    elif case == "small":
        x = x[:, :, :2]
    with pytest.raises(error):
        dconv.dconv_cuda(x, w, **kw)


@pytest.mark.parametrize("view,copied", [
    (lambda t: t, False),
    (lambda t: t[:, :, 1:3], False),  # a slice along T keeps (H, W) contiguous
    (lambda t: t[:, :, 2:3], False),
    (lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), False),  # T outside C
    (lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)[:, :, 1:3], False),
    (lambda t: t.transpose(0, 2).contiguous().transpose(0, 2), False),  # T outermost
    (lambda t: t[..., 1:], True),
    (lambda t: t.transpose(3, 4), True),
])
def test_trailing_contiguous_copies_only_what_the_transpose_cannot_read(view, copied):
    base = torch.arange(2 * 8 * 4 * 3 * 5, dtype=torch.float32).reshape(2, 8, 4, 3, 5)
    t = view(base)
    got, size = dconv.trailing_contiguous(t)
    assert size == t.shape[3] * t.shape[4]
    assert (got.data_ptr() != t.data_ptr()) == copied
    torch.testing.assert_close(got, t, rtol=0, atol=0)
    # what the transpose reads: element (b, c, t, p) at b stride(0) + c
    # stride(1) + t stride(2) + p
    flat = torch.as_strided(got, (*t.shape[:3], size), (*got.stride()[:3], 1),
                            got.storage_offset())
    torch.testing.assert_close(flat, t.reshape(*t.shape[:3], size), rtol=0, atol=0)


def _kmajor_want(w):
    return w.detach().permute(0, 2, 3, 4, 1).contiguous()


@pytest.mark.parametrize("case", ["weight", "kt_slices", "in_place", "new_data", "inference",
                                  "freed"])
def test_kmajor_keeps_a_copy_while_the_weight_stays_as_it_is(case):
    rng = np.random.default_rng(4)
    conv = nn.Conv3d(8, 4, (5, 3, 3), bias=False).to(torch.bfloat16)
    w = conv.weight
    with torch.no_grad():
        w.copy_(_rand(rng, w.shape, dtype=torch.bfloat16))
    if case == "weight":
        got = dconv.kmajor(w)
        assert got.shape == (4, 5, 3, 3, 8) and got.is_contiguous()
        torch.testing.assert_close(got, _kmajor_want(w), rtol=0, atol=0)
        assert dconv.kmajor(w) is got
    elif case == "kt_slices":  # a copy for each view of the storage, each kept
        views = [w[:, :, 0:4], w[:, :, 4:5], w[:, :, 1:3]]
        got = [dconv.kmajor(v) for v in views]
        for v, g in zip(views, got):
            torch.testing.assert_close(g, _kmajor_want(v), rtol=0, atol=0)
        assert all(dconv.kmajor(v) is g for v, g in zip([w[:, :, 0:4], w[:, :, 4:5]], got))
    elif case == "in_place":  # a write through any view moves the shared version
        old = dconv.kmajor(w[:, :, 1:3])
        with torch.no_grad():
            w[:, :, 2].mul_(-2)
        got = dconv.kmajor(w[:, :, 1:3])
        assert got is not old
        torch.testing.assert_close(got, _kmajor_want(w[:, :, 1:3]), rtol=0, atol=0)
    elif case == "new_data":
        old = dconv.kmajor(w)
        w.data = _rand(rng, w.shape, dtype=torch.bfloat16)
        torch.testing.assert_close(dconv.kmajor(w), _kmajor_want(w), rtol=0, atol=0)
        assert not torch.equal(dconv.kmajor(w), old)
    elif case == "inference":  # no version counter: copied on every call
        with torch.inference_mode():
            wi = w.detach().clone()
        got = dconv.kmajor(wi)
        torch.testing.assert_close(got, _kmajor_want(wi), rtol=0, atol=0)
        assert dconv.kmajor(wi) is not got
    else:  # the copies go with the tensor that owns the storage
        t = w.detach().clone()
        dconv.kmajor(t[:, :, 0:2])
        assert t in dconv._kmajor
        n = len(dconv._kmajor)
        del t
        assert len(dconv._kmajor) == n - 1


def test_dconv_refuses_autograd_and_counts_no_cpu_launch():
    x, w = _args()
    before = dconv.launches
    got = dconv.dconv(x, w, stride_t=3)
    assert dconv.launches == before
    torch.testing.assert_close(got, F.conv3d(x, w, stride=(3, 1, 1), padding=(0, 1, 1)),
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="dconv_cuda has no backward"):
        dconv.dconv_cuda(x, w.requires_grad_())
    assert dconv.launches == before


def test_route_takes_bf16_outside_autograd_only(monkeypatch):
    calls = []
    monkeypatch.setattr(dconv, "dconv", lambda *a, **k: calls.append(1) or F.conv3d(*a[:3]))
    x, w = _args()
    conv = nn.Conv3d(8, 4, (3, 3, 3), padding=(0, 1, 1), bias=False).to(torch.bfloat16)
    conv32 = nn.Conv3d(8, 4, (3, 3, 3), padding=(0, 1, 1), bias=False)
    dconv.conv_module(conv, x)  # the parameters require grad: autograd keeps F.conv3d
    assert calls == []
    with torch.no_grad():
        dconv.conv_module(conv, x)
        assert calls == [1]
        dconv.conv_module(conv32, x.float())  # f32: F.conv3d, cuDNN on the card
        dconv.conv3d(x.float(), w.float())
        assert calls == [1]
        dconv.conv3d(x, w)
        assert calls == [1, 1]
    conv.requires_grad_(False)
    dconv.conv_module(conv, x)  # no graph would record: routed under grad mode too
    assert calls == [1, 1, 1]
    dconv.conv_module(conv, x.requires_grad_())
    assert calls == [1, 1, 1]


def test_quant_conv_keeps_its_own_forward(monkeypatch):
    """The int8 path replaces a decoder conv by QuantConv3d: the route is
    taken on the module's type, so it runs the module's own forward."""
    monkeypatch.setattr(dconv, "dconv", lambda *a, **k: pytest.fail("routed a QuantConv3d"))
    x, _ = _args()
    torch.manual_seed(0)
    conv = nn.Conv3d(8, 4, (3, 3, 3), padding=(0, 1, 1), bias=True)
    q = quant.QuantConv3d.from_conv(conv, amax=3.0).to(torch.bfloat16)
    with torch.no_grad():
        got = dconv.conv_module(q, x)
        torch.testing.assert_close(got, q(x), rtol=0, atol=0)


def _unrouted(monkeypatch):
    """Every call site as before the route: F.conv3d."""
    monkeypatch.setattr(dconv, "routes", lambda *a: False)


def _decoder(seed=0):
    torch.manual_seed(seed)
    return Decoder(decoder_plan(3, 32)).eval().to(torch.bfloat16)


def _pyramid(rng, b, size=32):
    s = size // 32
    shapes = [(b, 1024, 4, s, s), (b, 832, 8, 2 * s, 2 * s), (b, 480, 16, 4 * s, 4 * s),
              (b, 192, 16, 8 * s, 8 * s)]
    return [_rand(rng, sh, dtype=torch.bfloat16).relu() for sh in shapes]


def test_decoder_eval_outputs_as_before_on_cpu(monkeypatch):
    dec = _decoder()
    pyr = _pyramid(np.random.default_rng(1), 2)
    before = dconv.launches
    with torch.no_grad():
        got = dec(pyr)
        _unrouted(monkeypatch)
        want = dec(pyr)
    assert dconv.launches == before
    assert got.shape == (2, 32, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dense_front_and_decode_v2_outputs_as_before_on_cpu(monkeypatch):
    dec = _decoder(1)
    rng = np.random.default_rng(2)
    n = 64  # a chunk's timelines: (8, 1024, n/8, 1, 1) ... (2, 192, n/2, 8, 8)
    shapes = [(8, 1024, n // 8, 1, 1), (4, 832, n // 4, 2, 2), (2, 480, n // 2, 4, 4),
              (2, 192, n // 2, 8, 8)]
    tl = [_rand(rng, sh, dtype=torch.bfloat16).relu() for sh in shapes]
    starts = torch.tensor([0, 5, 17, 32])

    def run():
        with torch.no_grad():
            dense = streaming.dense_decoder_front(dec, tl)
            return dense, streaming.decode_windows_v2(dec, tl, dense, starts)

    (dense, maps) = run()
    _unrouted(monkeypatch)
    dense0, maps0 = run()
    for a, b in zip(dense, dense0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(maps, maps0, rtol=0, atol=0)
    x, w = tl[2], dec.convtsp3[0].weight
    torch.testing.assert_close(streaming.valid_tconv(x, w),
                               F.conv3d(x, w, padding=(0, 1, 1)), rtol=0, atol=0)


def test_folded_conv_up2x_outputs_as_before_on_cpu(monkeypatch):
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 16, 4, 5, 7), dtype=torch.bfloat16)
    fold = FoldedConvUp2x(_rand(rng, (8, 16, 2, 3, 3), 0.1, torch.bfloat16),
                          _rand(rng, (8,), 0.1, torch.bfloat16))
    got = fold(x, stride_t=2)
    _unrouted(monkeypatch)
    torch.testing.assert_close(got, fold(x, stride_t=2), rtol=0, atol=0)
    assert got.shape == (2, 8, 2, 10, 14)
