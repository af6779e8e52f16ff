"""vinet_tpu_torch's audio-visual train step in bf16 and on the fixture's
trained trees, its Bilinear under autocast, and grad_accum, on the CPU. No
JAX training program is compiled: the comparisons run the forward of JAX's
train step (its loss_fn: parameters, clip and audio cast to the compute
dtype, ``apply(train=True)``, the maps cast to f32, with the new BatchNorm
statistics), jitted once in bf16 and once in f32.

AViNet(3, 32) at 64 x 64, batch 2, dropout off. 64 x 64 and not 64 x 96:
at 64 x 96 PyTorch 2.13's CPU (oneDNN) bf16 backward of the decoder's conv6,
a (2, 1, 1) conv whose output has one time step, aborts the process (double
free) or hangs; at 64 x 64 it runs. The card has no such fault.

- bf16, seeded trees (``tests/torch_port_util.py::av_bn_trees``): the
  port's train-mode maps under autocast lie no further from JAX's
  f32 maps than JAX's own bf16 maps do, in max |err| and in relative L2
  (JAX's bf16 - f32 difference is the tolerance); the port's bf16 train step
  reports the loss of exactly those maps and keeps f32 master weights,
  Adam state and statistics.
- f32 on the fixture's trees (``av_trees``: trained visual leaves): the
  port's f32 step loss within 1e-6 of its own float64 loss, and JAX's f32
  loss within 1e-4 of it; the statistics within 1e-5 of JAX's. JAX's f32 is
  the one that moves here (2.6e-5 where the port's f32 moves 2.4e-7): its
  train-mode BatchNorm takes the batch variance in one pass, E[x^2] -
  E[x]^2, which cancels where a channel's mean is large against its spread,
  as in the trained layers; torch takes it in two. On the seeded trees the
  loss holds within 1e-5 of JAX's (``test_torch_av_training.py``).
- the Bilinear under bf16 autocast against JAX's ``Bilinear.apply`` on the
  bf16-cast parameters and inputs: within one bf16 ulp of each value (f32
  accumulation of the exact products), where the GEMM that autocast would
  run on bf16-rounded outer products lies at least twice as far on average.
- grad_accum 2 with audio: the gradients the mean of the two microbatches'
  within 1e-6 of each leaf's largest value, the loss their mean within
  1e-6, the running statistics those of the two forwards in order within
  1e-7.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import (TORCH_THREADS, av_batch, av_bn_trees, av_trees,
                                   jax_train_forward, port_avinet, port_train_step,
                                   running_stats_err)
from vinet_tpu.models import Bilinear as JaxBilinear
from vinet_tpu.models.inference import cast_floating
from vinet_tpu_torch.models import Bilinear
from vinet_tpu_torch.training import LossConfig, loss_func
from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

torch.set_num_threads(TORCH_THREADS)
HW = (64, 64)


@pytest.fixture(scope="module")
def setup():
    jm, params, state = av_bn_trees(False, input_hw=HW)
    return jm, params, state, av_batch(hw=HW), port_avinet(jm, params, state)


def _spread(a, ref) -> tuple:
    d = np.asarray(a, np.float64) - ref
    return float(np.abs(d).max()), float(np.linalg.norm(d) / np.linalg.norm(ref))


def test_bf16_train_step_within_jax_bf16_to_f32(setup):
    jm, params, state, batch, model = setup
    j32 = jax_train_forward(jm)(params, state, batch)[0].astype(np.float64)
    j16 = jax_train_forward(jm, jnp.bfloat16)(params, state, batch)[0]
    m = copy.deepcopy(model).train()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        p16 = m(torch.from_numpy(batch["clip"]), torch.from_numpy(batch["audio"])).float()
    want_loss = float(loss_func(p16, torch.from_numpy(batch["gt"]), LossConfig()))
    port, own = _spread(p16.numpy(), j32), _spread(j16, j32)
    print(f"bf16 maps from JAX's f32 maps (max |err|, rel L2): port {port[0]:.3g} "
          f"{port[1]:.3g}, JAX's own {own[0]:.3g} {own[1]:.3g}")
    assert port[0] <= own[0] and port[1] <= own[1], (port, own)

    loss, trained = port_train_step(model, batch, compute_dtype=torch.bfloat16)
    assert loss == want_loss, (loss, want_loss)
    assert all(p.dtype == torch.float32 for p in trained.parameters())
    assert all(b.dtype != torch.bfloat16 for b in trained.buffers())


def test_f32_train_step_on_the_fixture_trees(setup):
    batch = setup[3]
    jm, params, state = av_trees(False, input_hw=HW)
    model = port_avinet(jm, params, state)
    _, jloss, jstate = jax_train_forward(jm)(params, state, batch)
    loss, trained = port_train_step(model, batch)
    m64 = copy.deepcopy(model).double().train()
    t = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    with torch.no_grad():
        loss64 = float(loss_func(m64(t["clip"], t["audio"]), t["gt"], LossConfig()))
    errs = running_stats_err(trained, params, jstate)
    port, jax_ = abs(loss - loss64) / loss64, abs(float(jloss) - loss64) / loss64
    print(f"fixture trees: from the port's float64 loss {loss64:.9g}, the port's f32 "
          f"{port:.3g}, JAX's f32 {jax_:.3g}; BN statistics {errs}")
    assert port <= 1e-6 and jax_ <= 1e-4, (port, jax_)
    assert errs["visual"] <= 1e-5 and errs["audio"] <= 1e-5, errs


def test_bilinear_accumulates_in_f32_under_autocast():
    rng = np.random.default_rng(5)
    i, j, o = 42, 3, 336
    bil = Bilinear(i, j, o).requires_grad_(False)
    bil.weight.copy_(torch.from_numpy(rng.standard_normal((o, i, j)).astype(np.float32)))
    bil.bias.copy_(torch.from_numpy(rng.standard_normal(o).astype(np.float32)))
    x1 = rng.standard_normal((2, 64, i)).astype(np.float32)
    x2 = rng.standard_normal((2, 64, j)).astype(np.float32)
    p16 = cast_floating({"w": jnp.asarray(bil.weight.numpy()), "b": jnp.asarray(bil.bias.numpy())},
                        jnp.bfloat16)
    want = np.asarray(JaxBilinear(i, j, o).apply(
        p16, {}, jnp.asarray(x1, jnp.bfloat16), jnp.asarray(x2, jnp.bfloat16))[0], np.float32)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = bil(t1, t2)
        outer = (t1.to(torch.bfloat16).float()[..., :, None]
                 * t2.to(torch.bfloat16).float()[..., None, :]).flatten(2)
        plain = torch.matmul(outer, bil.weight.flatten(1).t()) + bil.bias
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    err_plain = np.abs(plain.float().numpy() - want)
    with np.errstate(divide="ignore"):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)  # bf16's spacing at want
    print(f"Bilinear bf16: max |err| / ulp {float((err / ulp).max()):.3g}, mean |err| "
          f"{err.mean():.3g}; autocast's own GEMM {err_plain.mean():.3g}")
    assert (err <= ulp).all()
    assert err_plain.mean() > 2 * err.mean()


def test_grad_accum_2_is_the_mean_of_microbatches(setup):
    *_, batch, model = setup
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = copy.deepcopy(model).train()
    want, losses = None, []
    for i in range(2):
        ref.zero_grad()
        loss = loss_func(ref(t["clip"][i:i + 1], t["audio"][i:i + 1]), t["gt"][i:i + 1],
                         LossConfig())
        loss.backward()
        g = {k: p.grad.double() for k, p in ref.named_parameters() if p.grad is not None}
        want = g if want is None else {k: (want[k] + g[k]) / 2 for k in g}
        losses.append(float(loss.detach()))
    m = copy.deepcopy(model)
    _, metrics = make_train_step(LossConfig(), grad_accum=2)(init_train_state(m, 0.0, seed=None), t)
    got = {k: p.grad.double() for k, p in m.named_parameters() if p.grad is not None}
    assert got.keys() == want.keys()  # SoundNet's classifier heads take no gradient
    errs = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in want}
    worst = max(errs, key=errs.get)
    print(f"grad_accum 2: worst leaf {worst} {errs[worst]:.3g}")
    assert errs[worst] <= 1e-6
    assert abs(float(metrics["loss"]) - np.mean(losses)) <= 1e-6
    for (k, a), b in zip(m.named_buffers(), ref.buffers()):
        assert torch.allclose(a, b, rtol=0, atol=1e-7), k
