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
import torch.nn.functional as F

from vinet_tpu_torch.ops import (dconv, int8_mm, maxpool, quant, saliency_head, stemconv, tconv,
                                 upsample)

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




# (x, w, stride_t, pad_t, padding, bias): the decoder's (kt, 3, 3) convs at
# the main paths' shapes, bf16 at 224 x 384 (chip_smoke.py's DCONV_CASES)
DCONV_SHAPES = [
    ((16, 1024, 4, 7, 12), (832, 1024, 1, 3, 3), 1, 0, 1, False),  # parity conv1, batch 16
    ((16, 832, 12, 14, 24), (480, 832, 3, 3, 3), 3, 0, 1, False),  # conv2
    ((16, 480, 20, 28, 48), (192, 480, 5, 3, 3), 5, 0, 1, False),  # conv3
    ((16, 192, 20, 56, 96), (64, 192, 5, 3, 3), 5, 0, 1, False),  # conv4
    ((24, 480, 12, 28, 48), (192, 480, 5, 3, 3), 1, 0, 1, False),  # live c3y, 12 streams x 8 new
    ((192, 480, 4, 16, 26), (768, 480, 4, 3, 3), 1, 0, 0, False),  # conv3's folded taps
    ((3, 64, 5, 7, 9), (37, 64, 3, 3, 3), 2, 1, 1, True),  # ragged M (567) and N, a bias
]


@pytest.mark.gpu
@pytest.mark.parametrize("xs,ws,stride_t,pad_t,padding,bias", DCONV_SHAPES)
def test_dconv_kernel_matches_plain_on_card(cuda, xs, ws, stride_t, pad_t, padding, bias):
    """The kernel against its plain version in bf16 (cuDNN's F.conv3d)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(xs, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(ws, generator=g, device=cuda) / (ws[1] * ws[2] * 9) ** 0.5)
    w = w.to(torch.bfloat16)
    b = torch.randn(ws[0], generator=g, device=cuda).to(torch.bfloat16) if bias else None
    _assert_dconv_matches_plain(x, w, b, stride_t=stride_t, pad_t=pad_t, padding=padding)


def _assert_dconv_matches_plain(x, w, b=None, **kw):
    """Both versions sum the same bf16 products in f32 and round to bf16:
    the kernel once, after its bias; cuDNN once before a bias and again
    after it. So they differ by at most a bf16 step (2^-7) of the value and
    of the value before the bias, plus the f32 sums' order, far below 1e-3
    of the largest output."""
    before = dconv.launches
    got = dconv.dconv(x, w, b, **kw)
    torch.cuda.synchronize()
    assert dconv.launches == before + 1
    want = dconv.dconv_plain(x, w, b, **kw)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    want = want.float()
    unbiased = want if b is None else want - b.float()[:, None, None, None]
    tol = 2.0 ** -7 * (want.abs() + unbiased.abs()) + 1e-3 * float(want.abs().max())
    err = (got.float() - want).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.gpu
def test_dconv_kernel_reads_strided_inputs_on_card(cuda):
    """What the live decode hands the kernel: x with T outermost (a gather's
    layout), a slice of it along T, and weights sliced along kt (a storage
    offset, rows not 16-byte aligned)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    base = torch.randn((2, 24, 64, 14, 24), generator=g, device=cuda).to(torch.bfloat16)
    x = base.permute(1, 2, 0, 3, 4)  # (24, 64, 2, 14, 24), T outermost in memory
    w = (torch.randn((40, 64, 5, 3, 3), generator=g, device=cuda) / 24.0).to(torch.bfloat16)
    _assert_dconv_matches_plain(x, w[:, :, 1:3])
    _assert_dconv_matches_plain(x.contiguous()[:, :, 1:2], w[:, :, 4:5])
    gathered = base.reshape(4, 12, 64, 14, 24).transpose(1, 2)  # (4, 64, 12, 14, 24), T outside C
    _assert_dconv_matches_plain(gathered[:, :, 3:8], w, stride_t=2)


@pytest.mark.gpu
def test_dconv_kernel_takes_a_weight_written_in_place_on_card(cuda):
    """The kernel's K-major weight is kept between calls; a write to the
    weight through any of its views makes it anew."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 64, 4, 9, 11), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((24, 64, 5, 3, 3), generator=g, device=cuda) / 24.0).to(torch.bfloat16)
    for _ in range(2):
        _assert_dconv_matches_plain(x, w[:, :, 1:4])
        w[:, :, 2].mul_(-3)


# (name, x shape, kernel, stride, padding): every pool of the main paths at
# 224 x 384: parity's window batch of 16 clips (S3D's fourteen), the live
# path's advance of 16 frames on 12 streams (segment inputs with their
# tails, the valid-in-time forms) and the AV decode's fusion pool over 12 x 16
# windows (chip_smoke.py's MAXPOOL_CASES)
MAXPOOL_SHAPES = [
    ("parity_stem", (16, 64, 16, 112, 192), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("parity_maxp2", (16, 192, 16, 56, 96), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("parity_3b", (16, 192, 16, 28, 48), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("parity_3c", (16, 256, 16, 28, 48), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("parity_maxp3", (16, 480, 16, 28, 48), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("parity_4b", (16, 480, 8, 14, 24), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("parity_4c", (16, 512, 8, 14, 24), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("parity_4f", (16, 528, 8, 14, 24), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("parity_maxt4", (16, 832, 8, 14, 24), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ("parity_maxp4", (16, 832, 4, 14, 24), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("parity_5b", (16, 832, 4, 7, 12), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("live_stem", (24, 64, 10, 112, 192), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("live_maxp2", (24, 192, 12, 56, 96), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("live_3b", (24, 192, 12, 28, 48), (3, 3, 3), (1, 1, 1), (0, 1, 1)),
    ("live_3c", (24, 256, 10, 28, 48), (3, 3, 3), (1, 1, 1), (0, 1, 1)),
    ("live_maxp3", (24, 480, 10, 28, 48), (3, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("live_4b", (48, 480, 14, 14, 24), (3, 3, 3), (1, 1, 1), (0, 1, 1)),
    ("live_4f", (48, 528, 6, 14, 24), (3, 3, 3), (1, 1, 1), (0, 1, 1)),
    ("live_maxt4", (48, 832, 6, 14, 24), (2, 1, 1), (1, 1, 1), (0, 0, 0)),
    ("live_maxp4", (96, 832, 2, 14, 24), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("live_5b", (96, 832, 6, 7, 12), (3, 3, 3), (1, 1, 1), (0, 1, 1)),
    ("live_5c", (96, 832, 4, 7, 12), (3, 3, 3), (1, 1, 1), (0, 1, 1)),
    ("av_fusion", (192, 1024, 4, 7, 12), (4, 1, 1), (2, 1, 2), (0, 0, 0)),
]
# ragged: odd H and W, W not a multiple of 8 or 4 or 2 elements, T shorter
# than the window's reach, strides above the window, every spatial form of
# the kernel's instances and one that takes its generic instance; in bf16 a
# W that is a multiple of 4 takes the row kernel (W_out not always)
MAXPOOL_RAGGED = [
    ((3, 5, 7, 13, 40), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((2, 3, 5, 9, 24), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((2, 7, 5, 9, 16), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((2, 3, 5, 11, 8), (3, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((2, 3, 9, 6, 24), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ((3, 5, 7, 13, 17), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((3, 5, 7, 13, 17), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((2, 7, 5, 9, 14), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((2, 3, 9, 6, 12), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ((2, 3, 4, 11, 10), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ((2, 9, 5, 3, 7), (4, 1, 1), (2, 1, 2), (0, 0, 0)),
    ((1, 4, 7, 8, 9), (3, 2, 4), (3, 1, 3), (1, 1, 2)),
    ((2, 3, 2, 1, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((1, 2, 3, 40, 301), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_pool_matches(x, kernel, stride, padding):
    """The kernel against F.max_pool3d bit for bit: the same comparisons in
    the same order, so the same value, the sign of a zero and a NaN's bits."""
    before = maxpool.launches
    got = maxpool.max_pool3d_cuda(x, kernel, stride, padding)
    torch.cuda.synchronize()
    assert maxpool.launches == before + 1
    want = F.max_pool3d(x, kernel, stride, padding)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,shape,kernel,stride,padding", MAXPOOL_SHAPES,
                         ids=[c[0] for c in MAXPOOL_SHAPES])
def test_maxpool_kernel_equals_f_max_pool3d_on_card(cuda, name, shape, kernel, stride, padding,
                                                     dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.relu(torch.randn(shape, generator=g, device=cuda)).to(dtype)  # activations' zeros
    _assert_pool_matches(x, kernel, stride, padding)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,kernel,stride,padding", MAXPOOL_RAGGED)
def test_maxpool_kernel_ragged_shapes_on_card(cuda, shape, kernel, stride, padding, dtype):
    """Ragged shapes; then NaN, -0.0 and infinities among the values; then x
    one element past an aligned address (element loads, narrow stores)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    _assert_pool_matches(x, kernel, stride, padding)
    flat = x.view(-1)
    for v in (float("nan"), -0.0, 0.0, float("inf"), float("-inf")):
        flat[torch.randint(0, flat.numel(), (max(1, flat.numel() // 40),), generator=g,
                           device=cuda)] = v
    _assert_pool_matches(x, kernel, stride, padding)
    odd = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(shape)
    odd.copy_(x)
    _assert_pool_matches(odd, kernel, stride, padding)


@pytest.mark.gpu
def test_maxpool_route_on_card(cuda):
    """A CUDA tensor outside autograd launches the kernel; one that autograd
    records keeps F.max_pool3d and gets its gradient; f16 keeps F.max_pool3d."""
    x = torch.randn((2, 3, 5, 9, 11), device=cuda)
    before = maxpool.launches
    with torch.no_grad():
        got = maxpool.MaxPool3d(3, 2, 1)(x)
    assert maxpool.launches == before + 1 and torch.equal(got, F.max_pool3d(x, 3, 2, 1))
    xg = x.clone().requires_grad_()
    maxpool.MaxPool3d(3, 2, 1)(xg).sum().backward()
    xf = x.clone().requires_grad_()
    F.max_pool3d(xf, 3, 2, 1).sum().backward()
    assert torch.equal(xg.grad, xf.grad)
    maxpool.max_pool3d(x.half(), 3, 2, 1)
    assert maxpool.launches == before + 1


@pytest.mark.gpu
def test_parity_window_batch_through_maxpool_gives_the_same_maps_on_card(cuda, monkeypatch):
    """One parity window batch (16 clips of 32 x 224 x 384, bf16, seeded
    random weights) through SlidingWindowPredictor.run_batch: S3D's fourteen
    pools on the kernel give the uint8 maps of the same batch with the kernel
    switched off, and the decoder's convs launch dconv as often either way."""
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.models import ViNet

    torch.manual_seed(0)
    pred = SlidingWindowPredictor(ViNet(3, 32), batch=16, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (47, 224, 384, 3), dtype=np.uint8)).to(cuda)
    idx = (torch.arange(16)[:, None] + torch.arange(32)[None]).to(cuda)

    def run():
        counts = (maxpool.launches, dconv.launches)
        maps = pred.run_batch(frames, idx, (360, 640), True)
        torch.cuda.synchronize()
        return maps, maxpool.launches - counts[0], dconv.launches - counts[1]

    got, pools, convs = run()
    monkeypatch.setattr(maxpool, "routes", lambda x: False)
    want, pools_off, convs_off = run()
    assert (pools, pools_off) == (14, 0)
    assert convs == convs_off > 0
    assert got.dtype == want.dtype == torch.uint8 and got.shape == (16, 360, 640)
    assert torch.equal(got, want)


# (name, x shape (B, 3, T, H, W)): the stem's spatial convolution at the
# main paths' 224 x 384, a few frames of parity's window batch and live
# segment A's 23 frames (chip_smoke.py's STEMCONV_CASES time them whole)
STEMCONV_SHAPES = [("parity", (2, 3, 4, 224, 384)), ("live_a", (1, 3, 23, 224, 384))]
# ragged: H and W odd (patch staged and output stored element by element), W
# % 8 == 0 with W_out % 8 != 0, one pixel, tiles cut at both edges, W 8
STEMCONV_RAGGED = [(2, 3, 3, 37, 53), (2, 3, 2, 30, 40), (1, 3, 2, 1, 1), (1, 3, 2, 250, 144),
                   (3, 3, 1, 9, 8)]


def _stem_args(device, shape, seed=0):
    """x (ImageNet-normalised scale), w at fan-in scale and a bias that
    makes some sums negative, bf16 on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    w = torch.randn((64, 3, 1, 7, 7), generator=g, device=device) / 147 ** 0.5
    b = torch.randn((64,), generator=g, device=device) * 0.3
    return tuple(t.to(torch.bfloat16) for t in (x, w, b))


def _stem_conv(x, w):
    return F.conv3d(x, w, stride=stemconv.STRIDE, padding=stemconv.PADDING)


def _assert_stem_matches(x, w, b):
    """The kernel within one bf16 step of its plain version (which rounds
    the sum, then adds the bias in bf16: a step of the biasless sum and one
    of the output), and within one bf16 rounding of the float64 sum of the
    same operands plus f32 summation; NaNs and infinities where the plain
    version has them."""
    before = stemconv.launches
    got = stemconv.stemconv_cuda(x, w, b)
    torch.cuda.synchronize()
    assert stemconv.launches == before + 1
    want = stemconv.stemconv_plain(x, w, b)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    ok = got.isfinite()
    b64 = torch.zeros(64, dtype=torch.float64, device=x.device) if b is None else b.double()
    s = _stem_conv(x.double(), w.double())
    ref = torch.relu(s + b64[None, :, None, None, None])
    scale = _stem_conv(x.double().abs(), w.double().abs()) + b64.abs()[None, :, None, None, None]
    g64, w64 = got.double()[ok], want.double()[ok]
    assert bool(((g64 - w64).abs() <= 2.0 ** -7 * (s[ok].abs() + w64.abs()) + 1e-6).all())
    assert bool(((g64 - ref[ok]).abs() <= 2.0 ** -8 * ref[ok].abs()
                 + 2.0 ** -16 * scale[ok]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", STEMCONV_SHAPES, ids=[c[0] for c in STEMCONV_SHAPES])
def test_stemconv_kernel_matches_plain_on_card(cuda, name, shape):
    _assert_stem_matches(*_stem_args(cuda, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", STEMCONV_RAGGED)
def test_stemconv_kernel_ragged_shapes_on_card(cuda, shape):
    """Ragged shapes, without a bias too; then x one element past an aligned
    address (the patch staged element by element)."""
    x, w, b = _stem_args(cuda, shape, seed=1)
    _assert_stem_matches(x, w, b)
    _assert_stem_matches(x, w, None)
    odd = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(shape)
    odd.copy_(x)
    _assert_stem_matches(odd, w, b)


@pytest.mark.gpu
def test_stemconv_kernel_reads_t_slices_and_keeps_nan_and_inf_on_card(cuda):
    """x a T slice of a longer clip (B, C and T strides read as they are,
    16-byte staging); then NaN and infinities among the pixels: the taps
    that pad each (c, kh) row of K read a real pixel against a zero weight
    and must not turn an infinity into a NaN."""
    x, w, b = _stem_args(cuda, (2, 3, 7, 64, 96), seed=2)
    part = x[:, :, 2:5]
    assert not part.is_contiguous()
    _assert_stem_matches(part, w, b)
    flat = x.view(-1)
    g = torch.Generator(device=cuda).manual_seed(3)
    for v in (float("inf"), float("-inf"), float("nan")):
        flat[torch.randint(0, flat.numel(), (12,), generator=g, device=cuda)] = v
    _assert_stem_matches(x, w, b)


@pytest.mark.gpu
def test_stemconv_route_on_card(cuda):
    """The stem's SepConv3d folded and in bf16 takes the kernel outside
    autograd; f32, an unfolded BatchNorm and autograd keep F.conv3d."""
    from vinet_tpu_torch.models.layers import SepConv3d

    torch.manual_seed(0)
    sep = SepConv3d(3, 64, 7, 2, 3).eval()
    x = _stem_args(cuda, (1, 3, 2, 32, 48))[0]
    unfolded = SepConv3d(3, 64, 7, 2, 3).eval().to(cuda, torch.bfloat16)
    sep.fold_bn()
    f32 = sep.to(cuda)
    before = stemconv.launches
    with torch.no_grad():
        f32(x.float())
        unfolded(x)
    f32(x.float()).sum().backward()
    bf = sep.to(torch.bfloat16)
    bf(x).sum().backward()  # parameters that require grad: autograd keeps F.conv3d
    assert stemconv.launches == before
    with torch.no_grad():
        got = bf(x)
    assert stemconv.launches == before + 1 and got.dtype == torch.bfloat16


@pytest.mark.gpu
def test_parity_window_batch_takes_stemconv_on_card(cuda, monkeypatch):
    """One parity window batch (16 clips of 32 x 224 x 384, bf16, seeded
    random weights) through SlidingWindowPredictor.run_batch launches the
    stem kernel once, and its maps are those of the same batch with the
    route off within a grey level on average (the two paths round the
    stem's output differently, by up to a bf16 step)."""
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.models import ViNet

    torch.manual_seed(0)
    pred = SlidingWindowPredictor(ViNet(3, 32), batch=16, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (47, 224, 384, 3), dtype=np.uint8)).to(cuda)
    idx = (torch.arange(16)[:, None] + torch.arange(32)[None]).to(cuda)

    def run():
        before = stemconv.launches
        maps = pred.run_batch(frames, idx, (360, 640), True)
        torch.cuda.synchronize()
        return maps, stemconv.launches - before

    got, launched = run()
    monkeypatch.setattr(stemconv, "routes", lambda *a: False)
    want, launched_off = run()
    assert (launched, launched_off) == (1, 0)
    gap = (got.float() - want.float()).abs()
    print("parity maps, stem kernel vs route off: mean", float(gap.mean()), "max", float(gap.max()))
    assert got.shape == want.shape == (16, 360, 640) and float(gap.mean()) <= 1.0


@pytest.mark.gpu
def test_train_step_launches_no_stemconv_on_card(cuda):
    """A bf16 autocast train step of ViNet (BatchNorm in train mode,
    autograd) keeps F.conv3d for the stem."""
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.training import LossConfig
    from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

    torch.manual_seed(0)
    ts = init_train_state(ViNet(3, 32).to(cuda))
    step = make_train_step(LossConfig(), compute_dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {"clip": torch.randn((2, 32, 64, 64, 3), generator=g, device=cuda),
             "gt": torch.rand((2, 64, 64), generator=g, device=cuda)}
    before = stemconv.launches
    ts, out = step(ts, batch)
    torch.cuda.synchronize()
    assert stemconv.launches == before and bool(torch.isfinite(torch.as_tensor(out["loss"])))


# (name, x shape): the ReLU + 2x upsample at the main paths' shapes (224 x
# 384, bf16 in the model): parity's three stages (a window batch of 16),
# the live AV decode's conv1 and z3 (12 streams x 16 windows) and the
# streaming dense front's c1u (a 128-frame chunk with its halo)
UP2X_SHAPES = [
    ("parity_conv1", (16, 832, 4, 7, 12)),
    ("parity_conv2", (16, 480, 4, 14, 24)),
    ("parity_conv3", (16, 192, 4, 28, 48)),
    ("live_conv1", (192, 832, 4, 7, 12)),
    ("live_z3", (192, 192, 4, 28, 48)),
    ("streaming_c1u", (8, 832, 30, 7, 12)),
]
# edges: H or W of 1, 2, 3; one plane; runs that do not fill the last unit;
# 2W not a multiple of 8 or 4 (narrow stores); planes larger than a unit
# (bands of rows, with and without a ragged last band)
UP2X_EDGES = [(2, 3, 2, 1, 5), (2, 3, 2, 5, 1), (1, 4, 3, 2, 2), (1, 4, 3, 3, 3),
              (1, 1, 1, 7, 12), (1, 7, 3, 7, 12), (3, 5, 7, 5, 7), (2, 3, 2, 9, 6),
              (1, 2, 1, 100, 80), (1, 2, 3, 61, 96), (1, 1, 1, 1, 1)]


def _up1d(x, dim):
    """x doubled along dim, half-pixel centres clamped at the ends: output 2i
    = 0.25 x[i - 1] + 0.75 x[i] (x[0] at i = 0), 2i + 1 = 0.75 x[i] + 0.25
    x[i + 1] (x[n - 1] at the end)."""
    n = x.shape[dim]
    i = torch.arange(n, device=x.device)
    prev = x.index_select(dim, (i - 1).clamp(min=0))
    nxt = x.index_select(dim, (i + 1).clamp(max=n - 1))
    return torch.stack([0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt], dim + 1).flatten(dim,
                                                                                      dim + 1)


def _up2x_f64(x):
    """relu then the upsample in float64, rounded once to x's dtype: each
    output from the inputs it weighs, so a NaN reaches only those and an
    infinity stays infinite (PyTorch's kernel also adds terms of weight 0,
    which turn both into NaN elsewhere)."""
    return _up1d(_up1d(torch.relu(x.double()), 3), 4).to(x.dtype)


def _assert_up2x_matches(x, want=None):
    """The kernel against the library's result (finite x) or ``_up2x_f64``
    on the card: in bf16 within one rounding step (outputs are >= 0, so their
    bits are ordered), in f32 within 1e-6 relative; NaN and infinities where
    the reference has them."""
    before = upsample.launches
    got = upsample.relu_up2x_cuda(x)
    torch.cuda.synchronize()
    assert upsample.launches == before + 1 and got.is_contiguous()
    want = _up2x_f64(x) if want is None else want
    assert got.dtype == want.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    finite = torch.isfinite(want)
    assert torch.equal(got[~finite].nan_to_num(), want[~finite].nan_to_num())
    got, want = got[finite], want[finite]
    if x.dtype == torch.bfloat16:
        steps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
        assert int((steps > 1).sum()) == 0, int(steps.max())
    else:
        assert int(((got - want).abs() > 1e-6 * want.abs()).sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,shape", UP2X_SHAPES, ids=[c[0] for c in UP2X_SHAPES])
def test_up2x_kernel_matches_the_library_on_card(cuda, name, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)  # half of it below 0
    want = F.interpolate(torch.relu(x), scale_factor=(1, 2, 2), mode="trilinear",
                         align_corners=False)
    _assert_up2x_matches(x, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", UP2X_EDGES)
def test_up2x_kernel_edge_shapes_on_card(cuda, shape, dtype):
    """Edge shapes; then NaN and infinities among the values; then x one
    element past an aligned address (element staging)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    _assert_up2x_matches(x)
    flat = x.view(-1)
    for v in (float("nan"), float("inf"), float("-inf")):
        flat[torch.randint(0, flat.numel(), (max(1, flat.numel() // 50),), generator=g,
                           device=cuda)] = v
    _assert_up2x_matches(x)
    odd = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(shape)
    odd.copy_(x)
    _assert_up2x_matches(odd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_up2x_kernel_reads_strided_inputs_on_card(cuda, dtype):
    """A slice along T, windows gathered with T outside C (the live
    decode's), and H and W not contiguous (copied first); one NaN."""
    g = torch.Generator(device=cuda).manual_seed(2)
    base = torch.randn((3, 6, 9, 7, 12), generator=g, device=cuda).to(dtype)
    base[1, 2, 4, 3, 5] = float("nan")
    for x in (base[:, :, 2:6], base.transpose(1, 2).contiguous().transpose(1, 2),
              base.transpose(3, 4)):
        assert not x.is_contiguous()
        _assert_up2x_matches(x)
    got = upsample.relu_up2x_cuda(base[:, :, 2:6])
    assert int(torch.isnan(got).sum()) == 16  # the NaN's 4 x 4 outputs, its slice alone


@pytest.mark.gpu
def test_up2x_route_on_card(cuda):
    """A CUDA tensor outside autograd and autocast launches the kernel; one
    that autograd records keeps the plain version and gets its gradient; f16
    and autocast keep the plain version."""
    x = torch.randn((2, 3, 4, 7, 12), device=cuda)
    before = upsample.launches
    with torch.no_grad():
        got = upsample.relu_up2x(x)
    assert upsample.launches == before + 1
    _assert_up2x_matches(x, got)
    xg = x.clone().requires_grad_()
    upsample.relu_up2x(xg).square().sum().backward()
    xf = x.clone().requires_grad_()
    upsample.relu_up2x_plain(xf).square().sum().backward()
    # the library's upsample backward sums with atomics, in no fixed order
    torch.testing.assert_close(xg.grad, xf.grad, rtol=1e-6, atol=1e-6)
    upsample.relu_up2x(x.half())
    xb = x.to(torch.bfloat16)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        auto = upsample.relu_up2x(xb)
        plain = F.interpolate(torch.relu(xb), scale_factor=(1, 2, 2), mode="trilinear",
                              align_corners=False)
    assert auto.dtype == plain.dtype and torch.equal(auto, plain)
    assert upsample.launches == before + 2


@pytest.mark.gpu
def test_parity_window_batch_takes_relu_up2x_on_card(cuda, monkeypatch):
    """One parity window batch (16 clips of 32 x 224 x 384, bf16, seeded
    random weights) through SlidingWindowPredictor.run_batch launches the
    kernel 3 times (conv1-conv3) and no library upsample, and its maps are
    those of the route off within a grey level on average (the two round
    the upsample's outputs apart by up to a bf16 step)."""
    from torch.profiler import ProfilerActivity, profile

    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.models import ViNet

    torch.manual_seed(0)
    pred = SlidingWindowPredictor(ViNet(3, 32), batch=16, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(10).integers(
        0, 256, (47, 224, 384, 3), dtype=np.uint8)).to(cuda)
    idx = (torch.arange(16)[:, None] + torch.arange(32)[None]).to(cuda)

    def run():
        before = upsample.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            maps = pred.run_batch(frames, idx, (360, 640), True)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        library = sum(e.count for e in prof.key_averages() if "upsample_trilinear3d" in e.key)
        return maps, upsample.launches - before, library, names

    run()  # warm-up: the kernels' builds and cuDNN's choices
    got, launched, library, names = run()
    monkeypatch.setattr(upsample, "routes", lambda x: False)
    want, launched_off, library_off, _ = run()
    assert (launched, launched_off) == (3, 0) and (library, library_off) == (0, 3)
    assert any("relu_up2x" in k for k in names)
    gap = (got.float() - want.float()).abs()
    print("parity maps, relu_up2x vs route off: mean", float(gap.mean()), "max", float(gap.max()))
    assert got.shape == want.shape == (16, 360, 640) and float(gap.mean()) <= 1.0


@pytest.mark.gpu
def test_train_step_launches_no_relu_up2x_on_card(cuda):
    """A bf16 autocast train step of ViNet keeps relu and F.interpolate, and
    their backward, for the decoder's stages."""
    from vinet_tpu_torch.models import ViNet
    from vinet_tpu_torch.training import LossConfig
    from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

    torch.manual_seed(0)
    ts = init_train_state(ViNet(3, 32).to(cuda))
    step = make_train_step(LossConfig(), compute_dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {"clip": torch.randn((2, 32, 64, 64, 3), generator=g, device=cuda),
             "gt": torch.rand((2, 64, 64), generator=g, device=cuda)}
    before = upsample.launches
    ts, out = step(ts, batch)
    torch.cuda.synchronize()
    assert upsample.launches == before and bool(torch.isfinite(torch.as_tensor(out["loss"])))


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


@pytest.mark.gpu
def test_streaming_predictor_bf16_on_card_takes_dconv(cuda, monkeypatch):
    """--streaming in bf16 (64 frames of 64 x 64, seeded random weights):
    every decoder conv through the kernel (launches > 0), the maps within
    0.02 of the same run with the decoder's convs on cuDNN's F.conv3d (two
    roundings of one bf16 conv differ by a bf16 step; a few such steps
    through four convs and the head's sigmoid)."""
    import copy

    from vinet_tpu_torch.inference import StreamingPredictor
    from vinet_tpu_torch.models import ViNet

    torch.manual_seed(0)
    model = ViNet(3, 32)
    frames = np.random.default_rng(7).integers(0, 256, (64, 64, 64, 3), dtype=np.uint8)
    before = dconv.launches
    card = dict(StreamingPredictor(copy.deepcopy(model), chunk=64, batch=8,
                                   device=cuda).predict_video(frames))
    assert dconv.launches > before
    monkeypatch.setattr(dconv, "routes", lambda *a: False)
    cudnn = dict(StreamingPredictor(model, chunk=64, batch=8, device=cuda).predict_video(frames))
    assert sorted(card) == sorted(cudnn) == list(range(64))
    err = max(float(np.abs(card[i] - cudnn[i]).max()) for i in range(64))
    assert err < 0.02, err


def _grad_entry_calls(device):
    """Each CUDA entry on inputs of which one requires grad."""
    z, w6, b6, w7, b7 = (None if t is None else t.to(device) for t in _head_args(1, 2, 8, 8, True))
    z.requires_grad_()
    a, b = (t.to(device) for t in _operands(torch.bfloat16, [(16, 32), (32, 16)]))
    x, w = (t.to(device) for t in _operands(torch.bfloat16, [(4, 16, 32), (3, 32, 16)]))
    w.requires_grad_()
    xd, wd = (t.to(device) for t in _operands(torch.bfloat16, [(1, 8, 3, 4, 5), (4, 8, 3, 3, 3)]))
    wd.requires_grad_()
    xs, ws, bs = _stem_args(device, (1, 3, 2, 9, 16))
    ws.requires_grad_()
    return {"saliency_head_cuda": lambda: saliency_head.saliency_head_cuda(z, w6, b6, w7, b7),
            "saliency_head_up2x_cuda": lambda: saliency_head.saliency_head_up2x_cuda(
                z, w6, b6, w7, b7),
            "int8_mm_cuda": lambda: int8_mm.int8_mm_cuda(a.requires_grad_(), b),
            "tconv_cuda": lambda: tconv.tconv_cuda(x, w, 1),
            "dconv_cuda": lambda: dconv.dconv_cuda(xd, wd),
            "max_pool3d_cuda": lambda: maxpool.max_pool3d_cuda(xd.detach().requires_grad_(), 3),
            "stemconv_cuda": lambda: stemconv.stemconv_cuda(xs, ws, bs),
            "relu_up2x_cuda": lambda: upsample.relu_up2x_cuda(xd.detach().requires_grad_())}


def _assert_refuses_autograd(entry, call):
    before = (saliency_head.launches, int8_mm.launches, tconv.launches, dconv.launches,
              maxpool.launches, stemconv.launches, upsample.launches)
    with pytest.raises(RuntimeError, match=f"{entry} has no backward"):
        call()
    assert (saliency_head.launches, int8_mm.launches, tconv.launches, dconv.launches,
            maxpool.launches, stemconv.launches, upsample.launches) == before


CUDA_ENTRIES = ["saliency_head_cuda", "saliency_head_up2x_cuda", "int8_mm_cuda", "tconv_cuda",
                "dconv_cuda", "max_pool3d_cuda", "stemconv_cuda", "relu_up2x_cuda"]


@pytest.mark.parametrize("entry", CUDA_ENTRIES)
def test_cuda_entries_refuse_autograd_before_anything_else(entry):
    """The kernels write through ctypes and record no backward, so a graph
    through them would be cut without a word: each entry raises first."""
    _assert_refuses_autograd(entry, _grad_entry_calls("cpu")[entry])


@pytest.mark.gpu
@pytest.mark.parametrize("entry", CUDA_ENTRIES)
def test_cuda_entries_refuse_autograd_on_card(cuda, entry):
    _assert_refuses_autograd(entry, _grad_entry_calls(cuda)[entry])
    with torch.no_grad():  # the same inputs without a graph launch as before
        _grad_entry_calls(cuda)[entry]()


@pytest.mark.gpu
def test_predict_video_fetch_on_card_matches_the_cpu(cuda, monkeypatch):
    """SlidingWindowPredictor.predict_video on the card, whose map groups
    come back through pinned memory one group behind the computation, yields
    the CPU predictor's frames in the same order and its maps (f32, TF32
    off; 80 frames in 20 window batches of 4, so several groups are in
    flight), for ViNet and for TASEDv2."""
    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.models import TASEDv2, ViNet

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    frames = np.random.default_rng(9).integers(0, 256, (80, 32, 64, 3), dtype=np.uint8)
    for model in (ViNet(3, 32), TASEDv2()):
        torch.manual_seed(0)
        kw = dict(clip_size=32, batch=4, dtype=torch.float32)
        want = list(SlidingWindowPredictor(model, device="cpu", **kw).predict_video(frames))
        got = list(SlidingWindowPredictor(model, device=cuda, **kw).predict_video(frames))
        assert [f for f, _ in got] == [f for f, _ in want]
        np.testing.assert_allclose(np.stack([m for _, m in got]),
                                   np.stack([m for _, m in want]), atol=1e-4)


@pytest.mark.gpu
def test_graph_replay_on_card_matches_op_by_op(cuda):
    """SlidingWindowPredictor with graphs captures the forward once for the
    window batch's shape, replays it, and yields the op-by-op predictor's
    frames and uint8 maps (bf16, 80 frames in 10 window batches of 8), for
    ViNet and TASEDv2; under a profiler it runs op by op again, so the pool
    kernel's launch counter moves."""
    from torch.profiler import ProfilerActivity, profile

    from vinet_tpu_torch.inference import SlidingWindowPredictor
    from vinet_tpu_torch.models import TASEDv2, ViNet
    from vinet_tpu_torch.ops import maxpool

    frames = np.random.default_rng(9).integers(0, 256, (80, 32, 64, 3), dtype=np.uint8)
    for model in (ViNet(3, 32), TASEDv2()):
        torch.manual_seed(0)
        kw = dict(clip_size=32, batch=8, device=cuda)
        want = list(SlidingWindowPredictor(model, **kw).predict_video(frames, quantize_u8=True))
        pred = SlidingWindowPredictor(model, graphs=True, **kw)
        got = list(pred.predict_video(frames, quantize_u8=True))
        assert len(pred.graphs) == 1
        assert [f for f, _ in got] == [f for f, _ in want]
        np.testing.assert_array_equal(np.stack([m for _, m in got]),
                                      np.stack([m for _, m in want]))
        before = maxpool.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            again = list(pred.predict_video(frames, quantize_u8=True))
        assert maxpool.launches > before
        np.testing.assert_array_equal(np.stack([m for _, m in again]),
                                      np.stack([m for _, m in want]))
