"""The port's int8 ViNet forward against the JAX package's
``make_inference_fn`` on an int8 tree, with the committed full-width
ViNet(3, 32) fixture weights on a (1, 32, 32, 32, 3) clip, on the CPU.

The JAX int8 tree is quantized once (module fixture) by the JAX package's
``quantize_tree`` on the folded f32 tree, with the skip list of its
``quantize_int8``; the absmax of each conv input comes from the port's
calibration on a clip made from a numpy seed, which
``tests/test_torch_int8_model.py`` holds to the JAX package's eager
calibration within 1e-4 (it saves that file's eager JAX forward here). The
tree is carried across (``io/weights.py``, ``load_int8_state_dict``), so both
packages compute from identical int8 weights and scales.

Tolerances. With f32 activations the int8 arithmetic agrees to f32 rounding:
F32_TOL = 1e-5 on maps in [0, 1] (1.0e-6 measured). With bf16 activations,
the int8 path: MAP_TOL = 2e-2 max|err| and MEAN_TOL = 2e-3 mean (1.3e-2 and
1.4e-3 measured). The two frameworks round bf16 activations at other places
(the upsample, the decoder's bf16 conv5, the head), so an activation one
bf16 ulp apart can quantize to the neighbouring int8 level (a step of
x_scale, up to 1/127 of the conv's input range), and such flips compound
through 60 convolutions; the JAX package's own two tails differ by 1.2e-2 on
these maps.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import (TORCH_THREADS, conv_paths, fixture_trees, folded_port_model,
                                   normalized_clip, port_name)
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.models.inference import cast_floating as jax_cast_floating
from vinet_tpu.models.inference import fold_batchnorms as jax_fold_batchnorms
from vinet_tpu.models.inference import make_inference_fn as jax_make_inference_fn
from vinet_tpu.models.inference import quantize_int8 as jax_quantize_int8
from vinet_tpu.ops import quant as jax_quant
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.models.inference import load_int8_state_dict, make_inference_fn
from vinet_tpu_torch.ops.quant import QuantConv3d, calibration

torch.set_num_threads(TORCH_THREADS)
F32_TOL = 1e-5
MAP_TOL, MEAN_TOL = 2e-2, 2e-3


@pytest.fixture(scope="module")
def trees():
    return fixture_trees()


@pytest.fixture(scope="module")
def jax_int8_tree(trees):
    params, _ = jax_fold_batchnorms(*trees)
    params = jax_cast_floating(params, jnp.float32)
    model = folded_port_model(trees)
    with calibration(model) as records, torch.no_grad():
        model(torch.from_numpy(normalized_clip(0)))
    by_id = {id(node["w"]): records[port_name(path)] for path, node in conv_paths(params)
             if port_name(path) in records}
    skip = inspect.signature(jax_quantize_int8).parameters["skip_prefixes"].default
    return jax_quant.quantize_tree(params, by_id, skip_prefixes=skip)


def test_from_jax_trees_carries_int8_convs(trees, jax_int8_tree):
    sd = from_jax_trees(jax_int8_tree, {})
    node = jax_int8_tree["backbone"]["base1"]["0"]["conv_s"]
    np.testing.assert_array_equal(sd["backbone.base1.0.conv_s.w_q"].numpy(),
                                  np.asarray(node["w_q"]).transpose(4, 3, 0, 1, 2))
    assert sd["backbone.base1.0.conv_s.w_q"].dtype == torch.int8
    assert float(sd["backbone.base1.0.conv_s.x_scale"]) == float(node["x_scale"])
    assert "decoder.convtsp1.0.w_q" in sd and "decoder.convtsp1.0.bias" not in sd
    assert "decoder.convtsp4.6.weight" in sd  # conv6 stays float
    model = load_int8_state_dict(folded_port_model(trees), sd)
    conv = model.backbone.base1[0].conv_s
    assert isinstance(conv, QuantConv3d) and conv.stride == (1, 2, 2)
    assert torch.equal(conv.bias, sd["backbone.base1.0.conv_s.bias"])


@pytest.mark.parametrize("dtype,phasefold", [("float32", "1"), ("bfloat16", "0"),
                                             ("bfloat16", "1")])
def test_int8_vinet_from_jax_tree_matches_jax(dtype, phasefold, trees, jax_int8_tree,
                                              monkeypatch):
    """bf16 is the int8 path of both packages. JAX runs its unfolded tail
    (VINET_PHASEFOLD=0, the port's order of operations) and its default
    phase-folded tail."""
    monkeypatch.setenv("VINET_PHASEFOLD", phasefold)
    x = normalized_clip(1)
    fn, _, _ = jax_make_inference_fn(JaxViNet(3, 32), jax_int8_tree, {},
                                     dtype=getattr(jnp, dtype), fold=False)
    want = np.asarray(fn(jnp.asarray(x)))

    model = load_int8_state_dict(folded_port_model(trees), from_jax_trees(jax_int8_tree, {}))
    assert sum(isinstance(m, QuantConv3d) for m in model.modules()) == 81
    fn_port, _ = make_inference_fn(model, dtype=dtype, device="cpu")
    got = fn_port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 32, 32) and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want)
    print(f"{dtype}: max|err| {err.max():.3g}, mean {err.mean():.3g}")
    if dtype == "float32":
        assert err.max() <= F32_TOL, err.max()
    else:
        assert err.max() <= MAP_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())
