"""The port's int8 quantization of ViNet against the JAX package's, with the
committed full-width ViNet(3, 32) fixture weights on a (1, 32, 32, 32, 3)
clip, on the CPU: the same convs are quantized, the same absmax is recorded
for each, and the scales are bf16-rounded as the JAX package's final cast
rounds them.

The JAX int8 tree is made once (module fixture): BatchNorms folded, f32,
``quantize_int8`` calibrated on one clip made from a numpy seed (an eager
forward, most of this file's time). The forward of a carried tree is held
against the JAX package in ``tests/test_torch_int8_vinet.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import (TORCH_THREADS, conv_paths, fixture_trees, folded_port_model,
                                   normalized_clip, port_name)
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.models.inference import cast_floating as jax_cast_floating
from vinet_tpu.models.inference import fold_batchnorms as jax_fold_batchnorms
from vinet_tpu.models.inference import quantize_int8 as jax_quantize_int8
from vinet_tpu.ops import quant as jax_quant
from vinet_tpu_torch.models.inference import make_inference_fn
from vinet_tpu_torch.ops.quant import QuantConv3d, calibration

torch.set_num_threads(TORCH_THREADS)
CALIB_RTOL = 1e-4  # absmax of f32 activations; the f32 forwards agree to ~1e-5


@pytest.fixture(scope="module")
def trees():
    return fixture_trees()


@pytest.fixture(scope="module")
def calib_clip():
    return normalized_clip(0)


@pytest.fixture(scope="module")
def jax_int8(trees, calib_clip):
    """The JAX int8 tree and its calibration records by port name."""
    params, state = jax_fold_batchnorms(*trees)
    params = jax_cast_floating(params, jnp.float32)
    ids = {id(node["w"]): path for path, node in conv_paths(params)}
    qparams = jax_quantize_int8(JaxViNet(3, 32), params, state,
                                calib_clips=jnp.asarray(calib_clip))
    records = {port_name(ids[k]): v for k, v in jax_quant._CAL["records"].items()}
    return qparams, records


def test_port_quantizes_the_convs_jax_quantizes(trees, calib_clip, jax_int8):
    qparams, _ = jax_int8
    want = {port_name(p) for p, node in conv_paths(qparams) if "w_q" in node}
    _, model = make_inference_fn(folded_port_model(trees), dtype="int8",
                                 calib_clips=torch.tensor(calib_clip), device="cpu")
    got = {n for n, m in model.named_modules() if isinstance(m, QuantConv3d)}
    assert len(got) == 81 and got == want
    assert "backbone.base1.0.conv_s" in got
    assert not got & {"decoder.convtsp4.3", "decoder.convtsp4.6", "decoder.convtsp4.8"}
    for name in ("backbone.base1.0.conv_s", "decoder.convtsp1.0"):
        q = model.get_submodule(name)
        assert q.w_q.dtype == torch.int8
        for buf in (q.w_scale, q.x_scale):  # bf16-rounded, as the JAX cast does
            assert buf.dtype == torch.bfloat16 and float(buf.float().abs().min()) > 0
    assert model.decoder.convtsp4[6].weight.dtype == torch.bfloat16
    # the same int8 weights: both fold the BatchNorms in f32, so a weight can
    # land one f32 ulp apart and round to the other int8 level at a tie
    flips = total = 0
    for path, node in conv_paths(qparams):
        if "w_q" in node:
            q = model.get_submodule(port_name(path))
            d = q.w_q.permute(2, 3, 4, 1, 0).int() - torch.from_numpy(np.array(node["w_q"])).int()
            assert int(d.abs().max()) <= 1, path
            flips, total = flips + int(d.count_nonzero()), total + d.numel()
    print(f"{flips} of {total} int8 weights one level apart")
    assert flips <= total * 1e-4  # 989 of 31,039,424 (3.2e-5) measured


def test_calibration_records_match_jax(trees, calib_clip, jax_int8):
    _, want = jax_int8
    model = folded_port_model(trees)
    with calibration(model) as got, torch.no_grad():
        model(torch.tensor(calib_clip))
    # JAX's default phase-folded tail records no conv5; the port's unfolded
    # tail does (both skip it when quantizing)
    assert set(got) - set(want) == {"decoder.convtsp4.3"} and set(want) <= set(got)
    err = max(abs(got[k] - v) / v for k, v in want.items())
    print(f"max relative absmax difference {err:.3g} over {len(want)} convs")
    assert err <= CALIB_RTOL, err
