"""The whole folded vinet_tpu_torch ViNet against vinet_tpu's inference
function, and the clip-8 decoder plan (no conv6), at f32 on the CPU.

Tolerance: max|err| < 2e-3, the full-model parity anchor of the JAX package's
torch-conversion tests (NOTES.md "Parity status").
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, fixture_trees, ndhwc_to_ncdhw, random_tree
from vinet_tpu.models import Decoder as JaxDecoder
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.models import decoder_plan as jax_decoder_plan
from vinet_tpu.models.inference import make_inference_fn
from vinet_tpu_torch.data.pipeline import device_preprocess
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.models import Decoder, ViNet, decoder_plan, fold_batchnorms
from vinet_tpu_torch.models.inference import cast_floating

torch.set_num_threads(TORCH_THREADS)
TOL = 2e-3


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_folded_vinet_matches_jax_inference_fn():
    params, state = fixture_trees()
    u8 = np.random.default_rng(1).integers(0, 256, (1, 32, 32, 32, 3), dtype=np.uint8)
    x = device_preprocess(torch.from_numpy(u8))

    fn, _, _ = make_inference_fn(JaxViNet(3, 32), params, state, dtype=jnp.float32)
    want = np.asarray(fn(jnp.asarray(x.numpy())))

    model = ViNet(3, 32)
    model.load_state_dict(from_jax_trees(params, state), strict=True)
    model = cast_floating(fold_batchnorms(model.eval()), torch.float32)
    assert not any(isinstance(m, torch.nn.BatchNorm3d) for m in model.modules())
    with torch.no_grad():
        got = model(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 32, 32)
    print(f"max|err| {_max_err(got.numpy(), want):.3g}")
    assert _max_err(got.numpy(), want) < TOL, _max_err(got.numpy(), want)


def test_decoder_8_without_conv6_matches_jax():
    dec = JaxDecoder(jax_decoder_plan(3, 8))
    rng = np.random.default_rng(7)
    params = random_tree(jax.eval_shape(dec.init, jax.random.PRNGKey(0))[0], rng)
    pyr = [rng.random(s).astype(np.float32) for s in
           [(1, 1, 1, 2, 1024), (1, 2, 2, 4, 832), (1, 4, 4, 8, 480), (1, 4, 8, 16, 192)]]
    want, _ = dec.apply(params, {}, [jnp.asarray(y) for y in pyr])
    port = Decoder(decoder_plan(3, 8))
    sd = {k[len("decoder."):]: v for k, v in from_jax_trees({"decoder": params}, {}).items()}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port([torch.from_numpy(ndhwc_to_ncdhw(y)) for y in pyr])
    assert tuple(got.shape) == want.shape == (1, 32, 64)
    print(f"max|err| {_max_err(got.numpy(), want):.3g}")
    assert _max_err(got.numpy(), want) < TOL, _max_err(got.numpy(), want)


@pytest.mark.parametrize("key", [(3, 32), (3, 16), (3, 8), (3, 48), (0, 32), (1, 32),
                                 (2, 32)])
def test_decoder_plans_load_jax_weights_strictly(key):
    """Every plan's module has the parameters, names and shapes of the JAX
    package's decoder for that plan."""
    dec = JaxDecoder(jax_decoder_plan(*key))
    shapes = jax.eval_shape(dec.init, jax.random.PRNGKey(0))[0]
    params = random_tree(shapes, np.random.default_rng(0))
    sd = {k[len("decoder."):]: v for k, v in from_jax_trees({"decoder": params}, {}).items()}
    Decoder(decoder_plan(*key)).load_state_dict(sd, strict=True)
