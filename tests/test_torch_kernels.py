"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so its card tests also run
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tests marked ``gpu`` need a CUDA card and skip without one; the others check
the wrappers' input validation and device rule on the CPU.
"""

import numpy as np
import pytest
import torch

from vinet_tpu_torch.ops import int8_mm, quant, saliency_head, tconv

torch.set_num_threads(2)


def _head_args(b, kt, h, w, bias, seed=0):
    """Port-layout head inputs: z (B, 32, kt, H, W), conv6 (32, 32, kt, 1, 1),
    b6 (32,) or None, conv7 (1, 32, 1, 1, 1), b7 (1,), all f32 on the CPU."""
    rng = np.random.default_rng(seed)
    z = np.maximum(rng.standard_normal((b, 32, kt, h, w)), 0).astype(np.float32)
    w6 = (rng.standard_normal((32, 32, kt, 1, 1)) * 0.1).astype(np.float32)
    b6 = (rng.standard_normal(32) * 0.1).astype(np.float32) if bias else None
    w7 = (rng.standard_normal((1, 32, 1, 1, 1)) * 0.3).astype(np.float32)
    b7 = np.asarray([0.1], np.float32)
    return tuple(None if a is None else torch.from_numpy(a) for a in (z, w6, b6, w7, b7))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_head_cuda_entry_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        saliency_head.saliency_head_cuda(*_head_args(1, 2, 8, 8, False))


def test_head_on_cpu_takes_the_plain_version_and_counts_no_launch():
    args = _head_args(2, 2, 5, 7, True)
    before = saliency_head.launches
    got = saliency_head.saliency_head(*args)
    assert saliency_head.launches == before
    torch.testing.assert_close(got, saliency_head.saliency_head_plain(*args), rtol=0, atol=0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5, 7)


def _bad(case):
    z, w6, b6, w7, b7 = _head_args(1, 2, 4, 6, True)
    if case == "dtype":
        z = z.half()
    elif case == "layout":
        z = z.transpose(3, 4)  # not contiguous NCDHW
    elif case == "channels":
        z, w6 = z[:, :16].contiguous(), w6[:16, :16].contiguous()
    elif case == "kt":
        z = torch.zeros((1, 32, saliency_head.MAX_KT + 1, 4, 6))
    elif case == "w6":
        w6 = w6[:, :, :1].contiguous()
    elif case == "b6":
        b6 = b6[:16]
    elif case == "w7":
        w7 = torch.zeros((1, 16, 1, 1, 1))
    elif case == "device":
        w6 = w6.to("meta")
    return z, w6, b6, w7, b7


@pytest.mark.parametrize("case,error", [
    ("dtype", TypeError), ("layout", ValueError), ("channels", ValueError),
    ("kt", ValueError), ("w6", ValueError), ("b6", ValueError), ("w7", ValueError),
    ("device", ValueError),
])
def test_head_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    with pytest.raises(error):
        saliency_head._check(*_bad(case))


def test_head_up2x_cuda_entry_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        saliency_head.saliency_head_up2x_cuda(*_head_args(1, 2, 8, 8, False))


def test_head_up2x_on_cpu_takes_the_plain_version_and_counts_no_launch():
    """On the CPU the fused entry is the full-resolution plain head on the
    f32 upsample of z5, bit for bit."""
    from vinet_tpu_torch.ops.upsample import upsample2x_hw

    z5, w6, b6, w7, b7 = _head_args(2, 2, 5, 7, True)
    z5 = z5.to(torch.bfloat16)
    before = (saliency_head.launches, saliency_head.launches_up2x)
    got = saliency_head.saliency_head_up2x(z5, w6, b6, w7, b7)
    assert (saliency_head.launches, saliency_head.launches_up2x) == before
    want = saliency_head.saliency_head_plain(upsample2x_hw(z5.float()), w6, b6, w7, b7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10, 14)


@pytest.mark.parametrize("case,error", [
    ("dtype", TypeError), ("layout", ValueError), ("channels", ValueError),
    ("kt", ValueError), ("w6", ValueError), ("b6", ValueError), ("w7", ValueError),
    ("device", ValueError), ("height", ValueError),
])
def test_head_up2x_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    """The fused entry validates before it looks for a card."""
    if case == "height":  # more 8-row tiles than the grid's 65535 (no storage)
        z, w6, b6, w7, b7 = (None if a is None else a.to("meta")
                             for a in _head_args(1, 2, 4, 6, True))
        z = torch.empty((1, 32, 2, 8 * 65535 + 1, 6), device="meta")
    else:
        z, w6, b6, w7, b7 = _bad(case)
    with pytest.raises(error) as info:
        saliency_head.saliency_head_up2x_cuda(z, w6, b6, w7, b7)
    assert "needs a CUDA tensor" not in str(info.value)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kt,h,w,bias", [(2, 32, 48, False), (3, 13, 21, True),
                                         (2, 224, 384, False)])
def test_head_kernel_matches_plain_on_card(cuda, dtype, kt, h, w, bias):
    """Both versions read the same values and accumulate in f32 (bf16 z:
    conv6's weights as bf16 hi + lo on the tensor cores): 1e-5."""
    z, w6, b6, w7, b7 = (None if a is None else a.to(cuda)
                         for a in _head_args(3, kt, h, w, bias))
    z = z.to(dtype)
    before = saliency_head.launches
    got = saliency_head.saliency_head(z, w6, b6, w7, b7)
    torch.cuda.synchronize()
    assert saliency_head.launches == before + 1
    want = saliency_head.saliency_head_plain(z, w6, b6, w7, b7)
    assert saliency_head.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kt,h,w,bias", [
    (16, 2, 112, 192, False),  # the clip-32 main path's z5
    (2, 3, 56, 96, True),  # the clip-48 tail, with b6
    (3, 2, 13, 21, True),  # ragged tiles; w % 8 != 0: element loads
    (2, 2, 9, 40, False),  # one 8-wide chunk past a tile
    (2, 2, 1, 1, True),  # every neighbour clamps to the one pixel
    (1, 8, 7, 3, False),  # MAX_KT
])
def test_head_up2x_kernel_matches_plain_on_card(cuda, dtype, b, kt, h, w, bias):
    """The fused kernel on z5 against the plain head on the f32 upsample of
    the same z5: 1e-5. Counts one launch of the head, in the fused mode."""
    z5, w6, b6, w7, b7 = (None if a is None else a.to(cuda)
                          for a in _head_args(b, kt, h, w, bias))
    z5 = z5.to(dtype)
    before = (saliency_head.launches, saliency_head.launches_up2x)
    got = saliency_head.saliency_head_up2x(z5, w6, b6, w7, b7)
    torch.cuda.synchronize()
    assert (saliency_head.launches, saliency_head.launches_up2x) == (before[0] + 1,
                                                                     before[1] + 1)
    want = saliency_head.saliency_head_up2x_plain(z5, w6, b6, w7, b7)
    assert tuple(got.shape) == (b, 2 * h, 2 * w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- int8_mm, tconv


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _operands(dtype, shapes, seed=0):
    rng = np.random.default_rng(seed)
    make = _ints if dtype == torch.int8 else _bf16
    return [make(rng, s) for s in shapes]


def _assert_matches_plain(got, want, dtype):
    """int8: exact. bf16: both sum exact f32 products in f32, in other
    orders: 1e-5 of the largest output."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= 1e-5, err


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_gemm_kernels_on_cpu_take_the_plain_versions_and_count_no_launch(dtype):
    a, b = _operands(dtype, [(6, 9), (9, 5)])
    x, w = _operands(dtype, [(7, 6, 9), (3, 9, 4)])
    before = (int8_mm.launches, tconv.launches)
    torch.testing.assert_close(int8_mm.int8_mm(a, b), int8_mm.int8_mm_plain(a, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(tconv.tconv(x, w, 2), tconv.tconv_plain(x, w, 2), rtol=0, atol=0)
    assert (int8_mm.launches, tconv.launches) == before
    assert int8_mm.int8_mm(a, b).dtype == int8_mm.ACC[dtype]
    assert tuple(tconv.tconv(x, w, 2).shape) == (3, 6, 4)


def test_int8_plain_versions_are_exact():
    a, b = _operands(torch.int8, [(5, 300), (300, 7)])
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    np.testing.assert_array_equal(int8_mm.int8_mm_plain(a, b).numpy(), want)
    x, w = _operands(torch.int8, [(9, 4, 200), (3, 200, 6)])
    xs, ws = x.numpy().astype(np.int64), w.numpy().astype(np.int64)
    want = np.stack([sum(xs[2 * t + k] @ ws[k] for k in range(3)) for t in range(4)])
    np.testing.assert_array_equal(tconv.tconv_plain(x, w, 2).numpy(), want)


def test_gemm_cuda_entries_reject_cpu_tensors():
    a, b = _operands(torch.int8, [(4, 4), (4, 4)])
    with pytest.raises(ValueError, match="CUDA"):
        int8_mm.int8_mm_cuda(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        tconv.tconv_cuda(a[None], b[None], 1)


@pytest.mark.parametrize("case,error", [
    ("mixed", TypeError), ("f32", TypeError), ("inner", ValueError), ("rank", ValueError),
    ("device", ValueError),
])
def test_int8_mm_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    a, b = _operands(torch.int8, [(4, 6), (6, 3)])
    if case == "mixed":
        b = b.to(torch.bfloat16)
    elif case == "f32":
        a, b = a.float(), b.float()
    elif case == "inner":
        b = b[:5]
    elif case == "rank":
        a = a[None]
    elif case == "device":
        b = b.to("meta")
    with pytest.raises(error):
        int8_mm._check(a, b)


@pytest.mark.parametrize("case,error", [
    ("mixed", TypeError), ("channels", ValueError), ("short", ValueError),
    ("stride", ValueError), ("device", ValueError),
])
def test_tconv_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    x, w = _operands(torch.int8, [(5, 4, 6), (3, 6, 2)])
    stride = 1
    if case == "mixed":
        w = w.to(torch.bfloat16)
    elif case == "channels":
        w = w[:, :5]
    elif case == "short":
        x = x[:2]
    elif case == "stride":
        stride = 0
    elif case == "device":
        w = w.to("meta")
    with pytest.raises(error):
        tconv._check(x, w, stride)


def _as_layout(b, layout):
    """b as it is ("kn": contiguous (K, N) or (kt, C, CO)), or the same values
    as a view of a contiguous K-major tensor ("nk": (N, K) or (CO, kt, C))."""
    return b if layout == "kn" else int8_mm.k_major_view(b)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("shape", [(40, 24), (3, 16, 8)])
def test_k_major_passes_a_k_major_view_on_and_copies_a_row_major_b_once(dtype, shape):
    """The kernels' B operand: a view of a contiguous K-major tensor goes
    through without a copy (same storage), a contiguous (K, N) or (kt, C,
    CO) tensor is copied once into that layout."""
    (b,) = _operands(dtype, [shape])
    bt = int8_mm.k_major(b)
    assert bt.is_contiguous() and bt.data_ptr() != b.data_ptr()
    assert torch.equal(bt, b.permute(b.dim() - 1, *range(b.dim() - 1)))
    view = _as_layout(b, "nk")
    assert torch.equal(view, b) and not view.is_contiguous()
    again = int8_mm.k_major(view)
    assert again.data_ptr() == view.data_ptr() and torch.equal(again, bt)


def test_gemm_sweep_builds_each_tiling_with_its_macros_and_counts_spills(monkeypatch):
    """The tiling sweep covers the package's own tiling, passes each tiling
    to nvcc as the core's macros, and reads ptxas's spill bytes."""
    import subprocess
    import types

    from vinet_tpu_torch.tools import sweep_gemm

    assert sweep_gemm.DEFAULT in sweep_gemm.TILINGS
    assert len(set(sweep_gemm.TILINGS)) == 18
    cmds = []

    def fake_run(cmd, **kwargs):
        cmds.append(cmd)
        log = "ptxas info : Used 128 registers\n  8 bytes spill stores, 8 bytes spill loads\n"
        return types.SimpleNamespace(returncode=0, stdout="", stderr=log)

    monkeypatch.setattr(sweep_gemm.build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", fake_run)
    so, spills = sweep_gemm._build("int8_mm", (128, 3, 64))
    assert spills == 16 and so.name == "libint8_mm-r128-s3-n64.so"
    assert {"-DGEMM_ROW_BYTES=128", "-DGEMM_STAGES=3", "-DGEMM_MAX_BN=64"} <= set(cmds[0])
    assert cmds[0][-1].endswith("csrc/int8_mm.cu")


@pytest.mark.parametrize("cin", [3, 24])  # the stem conv_s, K 147; Mixed-4c/4d conv_s, K 216
def test_conv_acc_gemm_pads_im2col_k_to_16_with_a_k_major_weight(cin, monkeypatch):
    kernel, stride, padding = ((1, 7, 7), (1, 2, 2), (0, 3, 3)) if cin == 3 else \
        ((1, 3, 3), (1, 1, 1), (0, 1, 1))
    rng = np.random.default_rng(cin)
    xq = _ints(rng, (2, cin, 3, 9, 11))
    wq = _ints(rng, (16, cin, *kernel))
    k = cin * kernel[1] * kernel[2]
    seen = []

    def record(a, b):
        seen.append((a.shape, b.shape, int8_mm.k_major(b).data_ptr() == b.data_ptr(),
                     bool((a[:, k:] == 0).all()), bool((b[k:] == 0).all())))
        return int8_mm.int8_mm_plain(a, b)

    monkeypatch.setattr(quant, "int8_mm", record)
    got = quant.conv_acc_gemm(xq, wq, stride, padding)
    assert torch.equal(got, quant.conv_acc_plain(xq, wq, stride, padding))
    ((a_shape, b_shape, no_copy, a_pad_zero, b_pad_zero),) = seen
    kp = -(-k // 16) * 16
    assert a_shape[1] == b_shape[0] == kp and kp > k and b_shape[1] == 16
    assert no_copy and a_pad_zero and b_pad_zero


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (4096, 1024, 1024),  # the experiment's shape
    (1000, 333, 77),  # ragged M, K, N
    (129, 1, 130),
    (5, 147, 64),  # the stem conv_s im2col's K and N: the masked variant
    (300, 40, 16),
    (3001, 160, 64),  # the stem conv_s im2col with K padded to 160
    (1000, 216, 24),  # Mixed-4c/4d conv_s im2col, unpadded K: masked
    (777, 147, 16),
    (1, 160, 24),
    (2000, 832, 832),  # the decoder's widest N
])
def test_int8_mm_kernel_matches_plain_on_card(cuda, dtype, m, k, n, layout):
    a, b = (t.to(cuda) for t in _operands(dtype, [(m, k), (k, n)]))
    b = _as_layout(b, layout)
    before = int8_mm.launches
    got = int8_mm.int8_mm(a, b)
    torch.cuda.synchronize()
    assert int8_mm.launches == before + 1
    _assert_matches_plain(got, int8_mm.int8_mm_plain(a, b), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("t_pad,m,c,kt,co,stride", [
    (38, 4096, 64, 7, 64, 2),  # the experiment's stem conv, M cut
    (9, 1000, 20, 3, 37, 2),  # ragged M, CO; C % 16 != 0: the masked variant
    (7, 77, 6, 7, 5, 1),
    (10, 300, 48, 3, 48, 1),
    (6, 130, 384, 3, 384, 1),  # the model's widest conv_t
    (10, 1000, 48, 3, 16, 1),  # C 48, 208: 32-byte K slices straddle two taps
    (6, 1001, 208, 3, 24, 1),
])
def test_tconv_kernel_matches_plain_on_card(cuda, dtype, t_pad, m, c, kt, co, stride, layout):
    x, w = (t.to(cuda) for t in _operands(dtype, [(t_pad, m, c), (kt, c, co)]))
    w = _as_layout(w, layout)
    before = tconv.launches
    got = tconv.tconv(x, w, stride)
    torch.cuda.synchronize()
    assert tconv.launches == before + 1
    _assert_matches_plain(got, tconv.tconv_plain(x, w, stride), dtype)




# (kernel, stride, padding, Cin, Cout): every conv kind of the int8 model, as
# in tests/torch_port_util.py, which this file does not import so that it
# runs alone where JAX is absent
CONV_KINDS = [
    ((1, 1, 1), (1, 1, 1), (0, 0, 0), 16, 24),  # Inception 1x1x1
    ((7, 1, 1), (2, 1, 1), (3, 0, 0), 8, 8),  # stem conv_t
    ((3, 1, 1), (1, 1, 1), (1, 0, 0), 8, 12),  # SepConv3d conv_t
    ((1, 7, 7), (1, 2, 2), (0, 3, 3), 3, 8),  # stem conv_s
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 5, 7),  # SepConv3d conv_s, decoder conv1
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 24, 16),  # Mixed-4c/4d conv_s, K 216
    ((5, 3, 3), (5, 1, 1), (0, 1, 1), 6, 4),  # decoder conv3, conv4
]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,stride,padding,cin,cout", CONV_KINDS)
def test_int8_conv_routes_on_card_match_the_exact_cpu_route(cuda, kernel, stride, padding,
                                                           cin, cout):
    rng = np.random.default_rng(1)
    xq = _ints(rng, (2, cin, 10, 9, 11))
    wq = _ints(rng, (cout, cin, *kernel))
    want = quant.conv_acc_plain(xq, wq, stride, padding)
    before = (int8_mm.launches, tconv.launches)
    got = quant.conv_acc_gemm(xq.to(cuda), wq.to(cuda), stride, padding)
    torch.cuda.synchronize()
    temporal = kernel[0] > 1 and kernel[1:] == (1, 1)
    assert (int8_mm.launches, tconv.launches) == (before[0] + (not temporal),
                                                  before[1] + temporal)
    assert torch.equal(got.cpu(), want)


# ------------------------------------------------- the serving paths on the card


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_up2x_with_identity_conv6_at_t1_matches_plain_on_card(cuda, dtype):
    """The tail of the plans without conv6: the fused kernel with conv6 the
    identity (kt 1, no b6) on z5 with T 1 equals the plain version and
    sigmoid(conv7(up(z5))): 1e-5."""
    from vinet_tpu_torch.ops.upsample import upsample2x_hw

    z5, _, _, w7, b7 = (None if a is None else a.to(cuda) for a in _head_args(4, 1, 16, 24, False))
    z5 = z5.to(dtype)
    w6 = torch.eye(32, device=cuda).reshape(32, 32, 1, 1, 1)
    before = saliency_head.launches_up2x
    got = saliency_head.saliency_head_up2x(z5, w6, None, w7, b7)
    torch.cuda.synchronize()
    assert saliency_head.launches_up2x == before + 1
    want = saliency_head.saliency_head_up2x_plain(z5, w6, None, w7, b7)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    direct = torch.sigmoid(torch.nn.functional.conv3d(upsample2x_hw(z5.float()), w7, b7))[:, 0, 0]
    torch.testing.assert_close(got, direct, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_conv_after_up2x_bf16_on_card_matches_the_cpu(cuda):
    """conv5's folded route in bf16 (cuDNN on the card, the CPU's conv
    there): each output is within one bf16 rounding of the f32 sum of the
    same rounded weights, plus one on the border strips, so the two stay
    within 2^-6 of the sum of |terms|."""
    from vinet_tpu_torch.ops.phasefold import conv_after_up2x

    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.maximum(rng.standard_normal((2, 64, 4, 14, 24)), 0).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, 64, 2, 3, 3)) / np.sqrt(64 * 18))
                         .astype(np.float32))
    x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
    got = conv_after_up2x(x16.to(cuda), w16.to(cuda), stride_t=2)
    torch.cuda.synchronize()
    want = conv_after_up2x(x16, w16, stride_t=2)
    scale = conv_after_up2x(x16.float().abs(), w16.float().abs(), stride_t=2)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 32, 2, 28, 48)
    err = (got.cpu().float() - want.float()).abs()
    assert bool((err <= 2.0 ** -6 * scale).all()), float((err / scale).max())


@pytest.mark.gpu
def test_streaming_predictor_on_card_matches_the_cpu(cuda):
    """One small --streaming video (64 frames of 32 x 32, clip 32, f32,
    seeded random weights) on the card and on the CPU: maps within 2e-3,
    the card's through the fused head kernel."""
    import copy

    from vinet_tpu_torch.inference import StreamingPredictor
    from vinet_tpu_torch.models import ViNet

    torch.manual_seed(0)
    model = ViNet(3, 32)
    frames = np.random.default_rng(6).integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = dict(StreamingPredictor(copy.deepcopy(model), chunk=64, batch=8,
                                      dtype=torch.float32, device="cpu").predict_video(frames))
        before = saliency_head.launches_up2x
        card = dict(StreamingPredictor(model, chunk=64, batch=8, dtype=torch.float32,
                                       device=cuda).predict_video(frames))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert saliency_head.launches_up2x > before
    assert sorted(card) == sorted(cpu) == list(range(64))
    err = max(float(np.abs(card[i] - cpu[i]).max()) for i in range(64))
    assert err < 2e-3, err
