"""The int8 path's ops against the JAX package on the same numpy inputs, on
the CPU: the plain versions of the two GEMM kernels against the Pallas
kernels of ``scripts/exp_int8_mxu_r5.py`` (run in interpret mode, the script
loaded unedited), the quantisation ops and ``int8_conv3d`` against
``vinet_tpu/ops/quant.py`` for every conv kind of the model, and the card's
routes (im2col + ``int8_mm``, T-major slab + ``tconv``) rehearsed through the
kernels' plain versions.

Tolerances: int8 results are exact. bf16 products sum exact f32 products in
f32, in other orders: 1e-5 of the largest output. Dequantised int8 conv
outputs come from equal int32 accumulators through the same f32 operations,
so they are equal too.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tests.torch_port_util import CONV_KINDS, TORCH_THREADS, ncdhw_to_ndhwc, ndhwc_to_ncdhw
from vinet_tpu.ops import quant as jax_quant
from vinet_tpu_torch.ops import int8_mm, quant, tconv

torch.set_num_threads(TORCH_THREADS)
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "exp_int8_mxu_r5.py"
BF16_RTOL = 1e-5


@pytest.fixture(scope="module")
def exp_module():
    spec = importlib.util.spec_from_file_location("exp_int8_mxu_r5", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def pallas(exp_module, monkeypatch):
    """The experiment's kernels, run by Pallas's interpreter on the CPU."""
    orig = exp_module.pl.pallas_call
    monkeypatch.setattr(exp_module.pl, "pallas_call", functools.partial(orig, interpret=True))
    return exp_module


def _operand(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.int8 if dtype == "int8" else jnp.bfloat16)


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t if dtype == "int8" else t.to(torch.bfloat16)


def _assert_equal_or_close(got: torch.Tensor, want, dtype):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if dtype == "int8":
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32 and want.dtype == np.float32
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        print(f"relative max|err| {err:.3g}")
        assert err <= BF16_RTOL, err


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn", [(16, 40, 24, 8, 8), (32, 300, 16, 16, 8),
                                         (8, 7, 128, 8, 128)])
def test_int8_mm_plain_matches_pallas_mm(pallas, dtype, m, k, n, bm, bn):
    rng = np.random.default_rng(m + k + n)
    a, b = _operand(rng, (m, k), dtype), _operand(rng, (k, n), dtype)
    acc = jnp.int32 if dtype == "int8" else jnp.float32
    want = pallas.pallas_mm(_to_jax(a, dtype), _to_jax(b, dtype), bm=bm, bk=k, bn=bn,
                            acc_dtype=acc)
    got = int8_mm.int8_mm(_to_torch(a, dtype), _to_torch(b, dtype))
    _assert_equal_or_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("t_pad,m,c,kt,co,stride,m_blk", [
    (9, 16, 12, 3, 5, 2, 8),
    (10, 24, 8, 7, 8, 2, 8),  # the stem's 7-tap stride-2 conv, narrow
    (6, 16, 20, 3, 6, 1, 16),
])
def test_tconv_plain_matches_pallas_tconv(pallas, dtype, t_pad, m, c, kt, co, stride, m_blk):
    rng = np.random.default_rng(t_pad * m + c)
    x, w = _operand(rng, (t_pad, m, c), dtype), _operand(rng, (kt, c, co), dtype)
    acc = jnp.int32 if dtype == "int8" else jnp.float32
    want = pallas.pallas_tconv(_to_jax(x, dtype), _to_jax(w, dtype), stride=stride,
                               acc_dtype=acc, m_blk=m_blk)
    got = tconv.tconv(_to_torch(x, dtype), _to_torch(w, dtype), stride)
    _assert_equal_or_close(got, want, dtype)


@pytest.mark.parametrize("shape", [(3, 3, 3, 8, 16), (1, 7, 7, 3, 64), (3, 1, 1, 5, 7)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32)  # DHWIO
    w[..., 2] = 0.0  # an all-zero output channel takes the 1e-12 floor
    want_q, want_s = jax_quant.quantize_weight(w)
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w).permute(4, 3, 0, 1, 2))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.permute(2, 3, 4, 1, 0).numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_activation_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 3, 4, 5, 6)) * 3).astype(np.float32)
    x.flat[:4] = [127.5 * 0.05, -126.5 * 0.05, 0.5 * 0.05, 300.0]  # ties and a clip
    amax = 5.123456789
    want_scale = jnp.float32(max(amax / 127.0, 1e-12))  # quant.py:quantize_tree
    scale = quant.activation_scale(amax)
    assert float(scale) == float(want_scale) and scale.dtype == torch.float32
    if dtype == "bfloat16":
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = jax_quant.quantize_activation(xj, want_scale)
    got = quant.quantize_activation(xt, scale)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _conv_case(kind, seed=0):
    """Inputs of one conv kind: x NDHWC float, weight DHWIO, bias, x_scale."""
    kernel, stride, padding, cin, cout = CONV_KINDS[kind]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 10, 9, 11, cin)).astype(np.float32)
    w = (rng.standard_normal((*kernel, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    amax = float(np.abs(x).max()) * 0.8  # some inputs clip
    return kernel, stride, padding, x, w, b, amax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(CONV_KINDS))
def test_int8_conv3d_matches_jax(kind, dtype):
    """int32 accumulators equal, then the dequantised outputs equal."""
    kernel, stride, padding, x, w, b, amax = _conv_case(kind)
    wq, ws = jax_quant.quantize_weight(w)
    xs = jnp.float32(max(amax / 127.0, 1e-12))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x, jdt)
    params = {"w_q": wq, "w_scale": ws, "x_scale": xs, "b": jnp.asarray(b)}
    want_y = jax_quant.int8_conv3d(xj, params, stride=stride, padding=padding)
    want_acc = lax.conv_general_dilated(  # the accumulator of quant.py:int8_conv3d
        jax_quant.quantize_activation(xj, xs), wq, window_strides=stride,
        padding=[(p, p) for p in padding], dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        preferred_element_type=jnp.int32)

    xt = torch.from_numpy(ndhwc_to_ncdhw(x)).to(tdt)
    w_q = torch.from_numpy(np.array(wq)).permute(4, 3, 0, 1, 2)
    x_scale = quant.activation_scale(amax)
    acc = quant.conv_acc_plain(quant.quantize_activation(xt, x_scale), w_q, stride, padding)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(ncdhw_to_ndhwc(acc.numpy()), np.asarray(want_acc))
    y = quant.int8_conv3d(xt, w_q, torch.from_numpy(np.array(ws)), x_scale,
                          torch.from_numpy(b), stride=stride, padding=padding)
    assert y.dtype == tdt
    np.testing.assert_array_equal(ncdhw_to_ndhwc(y.float().numpy()),
                                  np.asarray(want_y, np.float32))


@pytest.mark.parametrize("kind", list(CONV_KINDS))
def test_card_routes_match_the_exact_cpu_route(kind, monkeypatch):
    """conv_acc_gemm (the card's routing) through the kernels' plain versions
    equals F.conv3d in float64, in both memory formats of the input, and
    sends (kt, 1, 1) convs to tconv and all others to int8_mm."""
    kernel, stride, padding, cin, cout = CONV_KINDS[kind]
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, cin, 10, 9, 11)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (cout, cin, *kernel)).astype(np.int8))
    calls = []
    monkeypatch.setattr(quant, "int8_mm", lambda a, b: calls.append("int8_mm") or
                        int8_mm.int8_mm_plain(a, b))
    monkeypatch.setattr(quant, "tconv", lambda x, w, s: calls.append("tconv") or
                        tconv.tconv_plain(x, w, s))
    want = quant.conv_acc_plain(xq, w_q, stride, padding)
    for x in (xq, xq.contiguous(memory_format=torch.channels_last_3d)):
        got = quant.conv_acc_gemm(x, w_q, stride, padding)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    temporal = kernel[0] > 1 and kernel[1:] == (1, 1)
    assert calls == ["tconv" if temporal else "int8_mm"] * 2


def test_quant_conv_replaces_a_conv_and_matches_int8_conv3d():
    conv = torch.nn.Conv3d(5, 7, (1, 3, 3), (1, 1, 1), (0, 1, 1), bias=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 5, 3, 6, 6))
                         .astype(np.float32))
    amax = float(x.abs().max())
    q = quant.QuantConv3d.from_conv(conv, amax)
    wq, ws = quant.quantize_weight(conv.weight)
    assert torch.equal(q.w_q, wq) and torch.equal(q.w_scale, ws)
    assert float(q.x_scale) == float(quant.activation_scale(amax))
    want = quant.int8_conv3d(x, wq, ws, q.x_scale, conv.bias.detach(), stride=(1, 1, 1),
                             padding=(0, 1, 1))
    assert torch.equal(q(x), want)
    with torch.no_grad():  # int8 keeps within a few quantisation steps of f32
        assert float((q(x) - conv(x)).abs().max()) < 0.05
    q16 = q.to(torch.bfloat16)
    assert q16.w_q.dtype == torch.int8 and q16.x_scale.dtype == torch.bfloat16
