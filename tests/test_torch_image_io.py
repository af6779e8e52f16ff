"""The port's small image surfaces against vinet_tpu's, on the same numpy
inputs: ``ops/image.py::minmax_normalize`` (whole tensor and per sample,
with and without eps) and ``to_uint8_map``, exported from
``vinet_tpu_torch.ops`` as ``vinet_tpu.ops`` exports them, and
``io/images.py::save_map`` with ``normalize`` True and False on float maps
and uint8 maps, as PNG and JPEG: the files byte for byte, and a uint8 map
with ``normalize=False`` refused with JAX's assertion.

f32 values equal JAX's bit for bit: both compute (x - min) / (max - min +
eps) in f32 with one correctly rounded operation each.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vinet_tpu.ops as jax_ops
from vinet_tpu.io.images import save_map as jax_save_map
from vinet_tpu.ops.image import to_uint8_map as jax_to_uint8_map
from vinet_tpu_torch.io.images import save_map
from vinet_tpu_torch.ops import minmax_normalize, to_uint8_map


def _maps(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 20, 28)) * 2.0 + 0.5).astype(np.float32)


@pytest.mark.parametrize("axes, eps", [(None, 0.0), ((1, 2), 0.0), ((1, 2), 1e-6), (None, 1e-3)])
def test_minmax_normalize_matches_jax(axes, eps):
    x = _maps(1)
    want = np.asarray(jax_ops.minmax_normalize(jnp.asarray(x), axes=axes, eps=eps))
    got = minmax_normalize(torch.from_numpy(x), axes=axes, eps=eps).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_to_uint8_map_matches_jax():
    x = np.concatenate([np.linspace(-0.1, 1.1, 1001, dtype=np.float32),
                        np.arange(256, dtype=np.float32) / 255.0,  # the rounding ties
                        (np.arange(256, dtype=np.float32) + 0.5) / 255.0])
    want = np.asarray(jax_to_uint8_map(jnp.asarray(x)))
    got = to_uint8_map(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_ops_exports_the_image_surfaces():
    import vinet_tpu_torch.ops as ops

    assert set(ops.__all__) == {"minmax_normalize", "to_uint8_map"}
    assert "minmax_normalize" in jax_ops.__all__


@pytest.mark.parametrize("kind", ["float", "float_in_unit_range", "uint8"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_save_map_writes_jax_bytes(tmp_path, kind, normalize, ext):
    m = _maps(2)[0]
    if kind == "float_in_unit_range":
        m = (m - m.min()) / (m.max() - m.min())
    elif kind == "uint8":
        m = to_uint8_map(minmax_normalize(torch.from_numpy(m))).numpy()
    ours, theirs = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
    if kind == "uint8" and not normalize:
        for fn, path in ((save_map, ours), (jax_save_map, theirs)):
            with pytest.raises(AssertionError, match="pre-quantized"):
                fn(m, str(path), normalize=False)
        return
    save_map(m, str(ours), normalize=normalize)
    jax_save_map(m, str(theirs), normalize=normalize)
    assert ours.read_bytes() == theirs.read_bytes()
