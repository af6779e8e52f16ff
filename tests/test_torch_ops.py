"""vinet_tpu_torch ops and the saliency head's plain versions (full
resolution, and fused with the last 2x upsample) against vinet_tpu on the
same numpy inputs, on the CPU. The head's CUDA kernel is held against its
plain versions in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, ncdhw_to_ndhwc, ndhwc_to_ncdhw
from vinet_tpu.data.pipeline import device_preprocess as jax_device_preprocess
from vinet_tpu.ops import image as jax_image
from vinet_tpu.ops.norm import fold_bn_into_conv as jax_fold_bn
from vinet_tpu.ops.pallas_head import saliency_head_pallas, saliency_head_reference
from vinet_tpu.ops.upsample import upsample2x_hw as jax_upsample2x_hw
from vinet_tpu_torch.data.pipeline import device_preprocess
from vinet_tpu_torch.ops import image, saliency_head
from vinet_tpu_torch.ops.norm import fold_bn_into_conv
from vinet_tpu_torch.ops.upsample import upsample2x_hw

torch.set_num_threads(TORCH_THREADS)


def _head_inputs(b, kt, h, w, bias, seed=0):
    """JAX-layout head inputs: z (B, kt, H, W, 32), w6 (kt, 32, 32), ..."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, kt, h, w, 32)).astype(np.float32)
    w6 = (rng.standard_normal((kt, 32, 32)) * 0.1).astype(np.float32)
    b6 = (rng.standard_normal(32) * 0.1).astype(np.float32) if bias else None
    w7 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    b7 = np.asarray([0.1], np.float32)
    return z, w6, b6, w7, b7


def _to_port(z, w6, b6, w7, b7):
    """JAX-layout head inputs -> the port's (NCDHW z, conv6/conv7 weights)."""
    return (torch.from_numpy(ndhwc_to_ncdhw(z)),
            torch.from_numpy(np.ascontiguousarray(w6.transpose(2, 1, 0)))[..., None, None],
            None if b6 is None else torch.from_numpy(b6),
            torch.from_numpy(w7).reshape(1, 32, 1, 1, 1),
            torch.from_numpy(b7))


# (B, kt, H, W, b6): clip-32 tail (kt 2, no bias), clip-48 tail (kt 3 with
# bias), and W not a multiple of 8 (the Pallas kernel needs H % 8 == 0)
@pytest.mark.parametrize("b,kt,h,w,bias", [(2, 2, 16, 24, False), (1, 3, 8, 16, True),
                                           (1, 2, 8, 21, False)])
def test_head_plain_matches_jax_reference_and_pallas(b, kt, h, w, bias):
    args = _head_inputs(b, kt, h, w, bias)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    ref = np.asarray(saliency_head_reference(*jargs))
    pallas = np.asarray(saliency_head_pallas(*jargs, interpret=True))
    got = saliency_head.saliency_head(*_to_port(*args))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, w)
    print(f"max|err| vs reference {np.abs(got.numpy() - ref).max():.3g}, "
          f"vs pallas {np.abs(got.numpy() - pallas).max():.3g}")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,bias", [(13, 21, True), (7, 5, False)])
def test_head_plain_ragged_hw_matches_jax_reference(h, w, bias):
    args = _head_inputs(2, 2, h, w, bias, seed=1)
    ref = np.asarray(saliency_head_reference(
        *[None if a is None else jnp.asarray(a) for a in args]))
    got = saliency_head.saliency_head(*_to_port(*args))
    print(f"max|err| vs reference {np.abs(got.numpy() - ref).max():.3g}")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# (B, kt, h, w, b6) of the coarse z5: the clip-32 tail (kt 2, no bias), the
# clip-48 tail (kt 3 with bias), and a ragged w; the Pallas kernel needs the
# upsampled H, 2h, to be a multiple of 8
@pytest.mark.parametrize("b,kt,h,w,bias", [(2, 2, 8, 12, False), (1, 3, 4, 8, True),
                                           (1, 2, 4, 7, True)])
def test_head_up2x_matches_pallas_on_the_jax_upsample(b, kt, h, w, bias):
    """The fused head on the coarse z5 against the Pallas head (interpret
    mode) on the JAX package's upsample of z5: 1e-5."""
    z5, w6, b6, w7, b7 = _head_inputs(b, kt, h, w, bias, seed=2)
    z5 = np.maximum(z5, 0)  # relu(conv5)
    jargs = [None if a is None else jnp.asarray(a) for a in (w6, b6, w7, b7)]
    want = np.asarray(saliency_head_pallas(jax_upsample2x_hw(jnp.asarray(z5)), *jargs,
                                           interpret=True))
    got = saliency_head.saliency_head_up2x(*_to_port(z5, w6, b6, w7, b7))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 2 * h, 2 * w)
    print(f"max|err| vs pallas {np.abs(got.numpy() - want).max():.3g}")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,bias", [(7, 5, True), (1, 3, False), (3, 1, True)])
def test_head_up2x_small_ragged_matches_jax_reference(h, w, bias):
    """Grids smaller than the upsample's reach, against the JAX reference
    head on the JAX upsample: 1e-5."""
    z5, w6, b6, w7, b7 = _head_inputs(2, 2, h, w, bias, seed=3)
    jargs = [None if a is None else jnp.asarray(a) for a in (w6, b6, w7, b7)]
    want = np.asarray(saliency_head_reference(jax_upsample2x_hw(jnp.asarray(z5)), *jargs))
    got = saliency_head.saliency_head_up2x(*_to_port(z5, w6, b6, w7, b7))
    assert tuple(got.shape) == (2, 2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_upsample2x_hw_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 7, 4)).astype(np.float32)
    ref = np.asarray(jax_upsample2x_hw(jnp.asarray(x)))
    got = upsample2x_hw(torch.from_numpy(ndhwc_to_ncdhw(x))).numpy()
    np.testing.assert_allclose(ncdhw_to_ndhwc(got), ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 20, 30), (3, 4, 3), (1, 1, 6)])
def test_gaussian_blur_matches_jax(shape):
    """(3, 4, 3) and (1, 1, 6) are smaller than the 11-tap kernel's reach."""
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    ref = np.asarray(jax_image.gaussian_blur(jnp.asarray(x), ksize=11))
    got = image.gaussian_blur(torch.from_numpy(x), ksize=11).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((14, 24), (30, 50)), ((40, 60), (17, 23)),
                                     ((16, 24), (16, 48))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(2).random((2, *src)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst), method="bilinear",
                                      antialias=False))
    got = image.resize_bilinear(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_normalize_and_device_preprocess_match_jax():
    u8 = np.random.default_rng(3).integers(0, 256, (2, 3, 4, 5, 3), dtype=np.uint8)
    ref = np.asarray(jax_device_preprocess(jnp.asarray(u8)))
    got = device_preprocess(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    x = u8.astype(np.float32) / 255.0
    np.testing.assert_allclose(
        image.normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(jax_image.normalize_imagenet(jnp.asarray(x))), atol=1e-6)


def test_quantize_maps_u8_matches_jax():
    rng = np.random.default_rng(4)
    maps = rng.random((3, 9, 11)).astype(np.float32)
    maps[1] = 0.5  # a constant map normalises to 0
    maps[2, :, :4] = 0.25  # repeated values, some on rounding ties
    ref = np.asarray(jax_image.quantize_maps_u8(jnp.asarray(maps)))
    got = image.quantize_maps_u8(torch.from_numpy(maps))
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("with_bias", [False, True])
def test_fold_bn_into_conv_matches_jax(with_bias):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 3, 3, 4, 6)).astype(np.float32)  # DHWIO
    b = rng.standard_normal(6).astype(np.float32) if with_bias else None
    bn_p = {"scale": rng.standard_normal(6).astype(np.float32),
            "bias": rng.standard_normal(6).astype(np.float32)}
    bn_s = {"mean": rng.standard_normal(6).astype(np.float32),
            "var": rng.random(6).astype(np.float32) + 0.1}
    wj, bj = jax_fold_bn(jnp.asarray(w), None if b is None else jnp.asarray(b),
                         bn_p, bn_s, eps=1e-3)
    wt, bt = fold_bn_into_conv(
        torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))),
        None if b is None else torch.from_numpy(b),
        *(torch.from_numpy(a) for a in (bn_p["scale"], bn_p["bias"], bn_s["mean"],
                                        bn_s["var"])))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj).transpose(4, 3, 0, 1, 2),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6, atol=1e-6)
