"""vinet_tpu_torch/ops/phasefold.py and the decoder tails that run on it,
against vinet_tpu at f32 on the CPU.

Inputs are standard normal and conv weights scaled by 1/sqrt(fan_in), so
outputs are O(1). Tolerances: max|err| <= 1e-5 for conv_after_up2x,
phase_up2x and the folded weights (both sides sum the same f32 products in
other orders); 2e-3 for the decoders' maps, the port's parity anchor.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, ncdhw_to_ndhwc, ndhwc_to_ncdhw, random_tree
from vinet_tpu.models import Decoder as JaxDecoder
from vinet_tpu.models import decoder_plan as jax_decoder_plan
from vinet_tpu.ops import phasefold as jax_phasefold
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.models import Decoder, decoder_plan
from vinet_tpu_torch.models import decoder as decoder_module
from vinet_tpu_torch.ops import phasefold
from vinet_tpu_torch.ops import saliency_head as head
from vinet_tpu_torch.ops.upsample import upsample2x_hw

torch.set_num_threads(TORCH_THREADS)
FOLD_TOL = 1e-5
TOL = 2e-3


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _operands(shape, wsh, seed=0):
    """x (B, T, H, W, Cin) N(0, 1); w (kt, 3, 3, Cin, Cout) / sqrt(fan_in); b."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(wsh) / np.sqrt(np.prod(wsh[:-1]))).astype(np.float32)
    b = (rng.standard_normal(wsh[-1]) * 0.1).astype(np.float32)
    return x, w, b


def _port_w(w):  # (kt, 3, 3, Cin, Cout) -> (Cout, Cin, kt, 3, 3)
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def test_fold_weights_up2x_matches_jax():
    _, w, _ = _operands((1, 1, 1, 1, 5), (2, 3, 3, 5, 4))
    want = np.asarray(jax_phasefold.fold_weights_up2x(jnp.asarray(w)))  # (kt,3,3,Cin,4Cout)
    got = phasefold.fold_weights_up2x(_port_w(w)).numpy().transpose(2, 3, 4, 1, 0)
    assert got.shape == want.shape
    assert _max_err(got, want) <= FOLD_TOL


# the JAX package's geometries (tests/test_phasefold.py) plus temporal padding;
# the third is conv5 after conv4 in the clip-32 decoder at 224 x 384
@pytest.mark.parametrize("shape,wsh,st,pt", [
    ((1, 2, 6, 8, 3), (1, 3, 3, 3, 2), 1, 0),
    ((2, 4, 7, 9, 5), (2, 3, 3, 5, 4), 2, 0),
    ((1, 4, 56, 96, 64), (2, 3, 3, 64, 32), 2, 0),
    ((1, 6, 5, 5, 2), (3, 3, 3, 2, 3), 3, 0),
    ((1, 5, 4, 7, 6), (3, 3, 3, 6, 5), 1, 1),
])
def test_conv_after_up2x_matches_jax_and_upsample_then_conv(shape, wsh, st, pt):
    x, w, b = _operands(shape, wsh)
    want = np.asarray(jax_phasefold.conv_after_up2x(jnp.asarray(x), jnp.asarray(w),
                                                     jnp.asarray(b), stride_t=st, pad_t=pt))
    xt, wt, bt = torch.from_numpy(ndhwc_to_ncdhw(x)), _port_w(w), torch.from_numpy(b)
    got = phasefold.conv_after_up2x(xt, wt, bt, stride_t=st, pad_t=pt)
    direct = torch.nn.functional.conv3d(upsample2x_hw(xt), wt, bt, stride=(st, 1, 1),
                                        padding=(pt, 1, 1))
    got = ncdhw_to_ndhwc(got.numpy())
    assert got.shape == want.shape == ncdhw_to_ndhwc(direct.numpy()).shape
    print(f"max|err| vs JAX {_max_err(got, want):.3g}")
    assert _max_err(got, want) <= FOLD_TOL
    assert _max_err(got, ncdhw_to_ndhwc(direct.numpy())) <= FOLD_TOL


def test_conv_after_up2x_bf16_rounds_like_one_bf16_conv():
    """bf16 in, bf16 out, as the JAX package rounds it: the folded weights
    round to bf16 (2^-9 each) and the output once, the border strips once
    more. So the error stays within 2^-7 of the sum of |terms|, which the
    same function on |x|, |w|, |b| in f32 bounds, border strips included."""
    x, w, b = _operands((2, 4, 6, 10, 8), (2, 3, 3, 8, 4), seed=3)
    xt, wt, bt = (t.to(torch.bfloat16) for t in (torch.from_numpy(ndhwc_to_ncdhw(x)),
                                                _port_w(w), torch.from_numpy(b)))
    got = phasefold.conv_after_up2x(xt, wt, bt, stride_t=2)
    want = phasefold.conv_after_up2x(xt.float(), wt.float(), bt.float(), stride_t=2)
    scale = phasefold.conv_after_up2x(xt.float().abs(), wt.float().abs(), bt.float().abs(),
                                      stride_t=2)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want).abs()
    assert bool((err <= 2.0 ** -7 * scale).all()), float((err / scale).max())


def test_phase_up2x_and_up_stencil_match_jax():
    z = np.random.default_rng(3).standard_normal((2, 3, 5, 7, 4)).astype(np.float32)
    want = np.asarray(jax_phasefold.phase_up2x(jnp.asarray(z)))  # (B, T, H, W, 4C)
    got = phasefold.phase_up2x(torch.from_numpy(ndhwc_to_ncdhw(z)))  # (B, 4C, T, H, W)
    assert _max_err(ncdhw_to_ndhwc(got.numpy()), want) <= FOLD_TOL
    fine = upsample2x_hw(torch.from_numpy(ndhwc_to_ncdhw(z)))
    for ph in range(2):
        for pw in range(2):
            phase = got[:, (ph * 2 + pw) * 4:(ph * 2 + pw + 1) * 4]
            assert _max_err(phase, fine[..., ph::2, pw::2]) <= FOLD_TOL
    np.testing.assert_array_equal(phasefold.up_stencil(), jax_phasefold.up_stencil())


PLANS = [(3, 32), (3, 16), (3, 8), (3, 48), (0, 32), (1, 32), (2, 32)]


def _decoder_pair(key, seed=0):
    """The JAX decoder's random params and the port's decoder with them."""
    dec = JaxDecoder(jax_decoder_plan(*key))
    params = random_tree(jax.eval_shape(dec.init, jax.random.PRNGKey(0))[0],
                         np.random.default_rng(seed))
    port = Decoder(decoder_plan(*key))
    sd = {k[len("decoder."):]: v for k, v in from_jax_trees({"decoder": params}, {}).items()}
    port.load_state_dict(sd, strict=True)
    return dec, params, port.eval()


def _pyramid(clip_size, seed=1, batch=2):
    """y0..y3 of a (batch, clip, 32, 64) clip, NDHWC, ReLU-like (>= 0)."""
    t = clip_size
    rng = np.random.default_rng(seed)
    return [rng.random(s).astype(np.float32) for s in
            [(batch, t // 8, 1, 2, 1024), (batch, t // 4, 2, 4, 832),
             (batch, t // 2, 4, 8, 480), (batch, t // 2, 8, 16, 192)]]


@pytest.mark.parametrize("key", PLANS)
def test_decoder_tails_match_jax_default_folded_tail(key, monkeypatch):
    """All 7 plans: the port's tail (conv5 folded with conv4's upsample, the
    fused head, identity conv6 where the plan has none) against the JAX
    package's default phase-folded tail."""
    monkeypatch.setenv("VINET_PHASEFOLD", "1")
    dec, params, port = _decoder_pair(key)
    pyr = _pyramid(32 if key[0] != 3 else key[1])
    want, _ = dec.apply(params, {}, [jnp.asarray(y) for y in pyr])
    with torch.no_grad():
        got = port([torch.from_numpy(ndhwc_to_ncdhw(y)) for y in pyr])
    assert tuple(got.shape) == want.shape == (2, 32, 64)
    print(f"{key}: max|err| {_max_err(got.numpy(), want):.3g}")
    assert _max_err(got.numpy(), want) < TOL


@pytest.mark.parametrize("key", [(3, 16), (3, 8)])
def test_plans_without_conv6_take_the_head_with_identity_conv6(key, monkeypatch):
    """z5 (T 1) goes to the fused head with w6 = eye(32), kt 1, no b6, and
    the decoder forms three upsamples (conv1-3's): conv5 folds the fourth,
    the head the fifth."""
    _, _, port = _decoder_pair(key)
    calls, ups = [], []
    plain_head, plain_up = head.saliency_head_up2x, decoder_module.upsample2x_hw

    def spy_head(z5, w6, b6, w7, b7):
        calls.append((tuple(z5.shape), z5.is_contiguous(), b6 is None,
                      torch.equal(w6.reshape(32, 32), torch.eye(32))))
        return plain_head(z5, w6, b6, w7, b7)

    def spy_up(x):
        ups.append(tuple(x.shape))
        return plain_up(x)

    monkeypatch.setattr(head, "saliency_head_up2x", spy_head)
    monkeypatch.setattr(decoder_module, "upsample2x_hw", spy_up)
    pyr = _pyramid(key[1], batch=1)
    with torch.no_grad():
        out = port([torch.from_numpy(ndhwc_to_ncdhw(y)) for y in pyr])
    assert calls == [((1, 32, 1, 16, 32), True, True, True)]
    assert len(ups) == 3 and tuple(out.shape) == (1, 32, 64)


def test_decoder_keeps_conv5_fold_until_its_weights_change():
    """Without autograd the decoder folds conv5 once; an in-place change of
    the weights or a cast folds anew; with autograd every call folds
    (gradients reach conv5), and so does a copy cast under inference mode,
    whose tensors count no versions."""
    import copy

    _, _, port = _decoder_pair((3, 32))
    z4 = torch.relu(torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 64, 4, 4, 8)).astype(np.float32)))
    with torch.no_grad():
        first = port.tail(z4)
        fold = port._fold5[2]
        assert torch.equal(port.tail(z4), first) and port._fold5[2] is fold
        port.convtsp4[3].weight.mul_(0.5)
        assert port._conv5_folded() is not fold
        assert not torch.equal(port.tail(z4), first)
        port.to(torch.bfloat16)
        assert port.tail(z4.bfloat16()).dtype == torch.bfloat16
        assert port._fold5[2].wf.dtype == torch.bfloat16
    port.float()
    with torch.inference_mode():
        cast = copy.deepcopy(port).double()  # inference tensors
        torch.testing.assert_close(cast.tail(z4.double()).float(), port.tail(z4))
    port.tail(z4.requires_grad_()).sum().backward()
    assert port.convtsp4[3].weight.grad is not None and z4.grad is not None
