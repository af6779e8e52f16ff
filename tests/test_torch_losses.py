"""vinet_tpu_torch's training losses against vinet_tpu's, on the same numpy
maps in f32 on the CPU: every loss and metric, loss_func with each term and
with multi-frame GT, and their gradients, within 1e-5 (relative to the
largest value)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS
from vinet_tpu import training as jt
from vinet_tpu_torch import training as tt

torch.set_num_threads(TORCH_THREADS)
TOL = 1e-5
FNS = ["kldiv", "cc", "similarity", "nss"]
CONFIGS = {
    "kldiv": {},
    # coefficients of one sign, so that the terms do not cancel in the total
    "all_terms": dict(cc=True, sim=True, l1=True, kldiv_coeff=0.5, cc_coeff=0.7,
                      sim_coeff=1.3, l1_coeff=2.0),
    "nss": dict(kldiv=False, nss=True, nss_coeff=-1.0),
}


def _maps(shape, seed, fixations=False):
    rng = np.random.default_rng(seed)
    s = (rng.random(shape) + 0.01).astype(np.float32)
    if fixations:  # a binary fixation map with a few ones in every map
        g = (rng.random(shape) > 0.9).astype(np.float32)
        g.reshape(-1, g.shape[-1])[:, 0] = 1.0
    else:
        g = (rng.random(shape) + 0.01).astype(np.float32)
    return s, g


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", FNS)
def test_loss_and_its_gradient_match_jax(name):
    s, g = _maps((3, 12, 16), seed=FNS.index(name), fixations=name == "nss")
    jfn, tfn = getattr(jt, name), getattr(tt, name)
    want, want_grad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(g)))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    got = tfn(st, torch.from_numpy(g))
    got.backward()
    assert _rel(got.detach(), want) <= TOL
    assert _rel(st.grad, want_grad) <= TOL


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("shape", [(3, 12, 16), (2, 3, 12, 16)], ids=["single", "multi_frame"])
def test_loss_func_and_its_gradient_match_jax(config, shape):
    s, g = _maps(shape, seed=7, fixations=config == "nss")
    kw = CONFIGS[config]
    want, want_grad = jax.value_and_grad(
        lambda x: jt.loss_func(x, jnp.asarray(g), jt.LossConfig(**kw)))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    got = tt.loss_func(st, torch.from_numpy(g), tt.LossConfig(**kw))
    got.backward()
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) <= TOL, (got, want)
    assert _rel(st.grad, want_grad) <= TOL


def test_multi_frame_loss_is_the_mean_of_the_frames():
    s, g = _maps((2, 3, 12, 16), seed=9)
    cfg = tt.LossConfig(cc=True)
    folded = float(tt.loss_func(torch.from_numpy(s), torch.from_numpy(g), cfg))
    frames = [float(tt.loss_func(torch.from_numpy(s[:, i]), torch.from_numpy(g[:, i]), cfg))
              for i in range(3)]
    assert abs(folded - np.mean(frames)) <= 1e-6
