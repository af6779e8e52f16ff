"""vinet_tpu_torch's streaming fine-tuning against vinet_tpu's, on the CPU:
ViNet(3, 8) on a 16-frame chunk of 32 x 32 frames with 4 windows, the same
numpy-made trees and chunk.

- the window samplers equal JAX's for the same generator;
- one ft step's loss (f32, within 1e-5) and gradients (the port's in
  float64, as in ``tests/test_torch_training.py``, within 1e-4 of each
  leaf's largest value) equal JAX's differentiation of
  the same streaming forward (streaming_pyramid + gather_windows + the
  decoder's training graph, BatchNorm frozen);
- the port's step leaves every BatchNorm statistic as it was, trains the
  weights, and its eval step goes through the head.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, bn_tree
from vinet_tpu.inference.streaming import gather_windows as jax_gather_windows
from vinet_tpu.inference.streaming import streaming_pyramid as jax_streaming_pyramid
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.training import streaming_ft as jft
from vinet_tpu.training.losses import LossConfig as JaxLossConfig
from vinet_tpu.training.losses import loss_func as jax_loss_func
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.models import ViNet
from vinet_tpu_torch.training import LossConfig
from vinet_tpu_torch.training import streaming_ft as tft
from vinet_tpu_torch.training.trainer import init_train_state

torch.set_num_threads(TORCH_THREADS)
T, CHUNK, HW = 8, 16, (32, 32)
CFG = dict(kldiv=True, l1=True)  # l1: conv7's bias gradient is then no cancelling sum


@pytest.mark.parametrize("n_windows, chunk_len, clip_size", [(4, 16, 8), (16, 64, 32),
                                                             (1, 40, 32), (5, 32, 32)])
def test_window_samplers_equal_jax(n_windows, chunk_len, clip_size):
    for seed in range(3):
        got = tft.sample_window_starts(np.random.default_rng(seed), n_windows, chunk_len,
                                       clip_size)
        want = jft.sample_window_starts(np.random.default_rng(seed), n_windows, chunk_len,
                                        clip_size)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tft.eval_window_starts(n_windows, chunk_len, clip_size),
                          jft.eval_window_starts(n_windows, chunk_len, clip_size))


def test_sampler_rejects_a_chunk_shorter_than_the_clip():
    with pytest.raises(ValueError):
        tft.sample_window_starts(np.random.default_rng(0), 4, 16, 32)


@pytest.fixture(scope="module")
def setup():
    jm = JaxViNet(3, T)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    params, state = bn_tree(shapes[0], rng), bn_tree(shapes[1], rng)
    chunk = rng.standard_normal((1, CHUNK, *HW, 3)).astype(np.float32)
    starts = tft.sample_window_starts(rng, 4, CHUNK, T)
    gt = (rng.random((4, *HW)) + 0.05).astype(np.float32)
    model = ViNet(3, T)
    model.load_state_dict(from_jax_trees(params, state), strict=True)
    return jm, params, state, {"chunk": chunk, "gt": gt, "starts": starts}, model


def _batch(b, dtype=torch.float32):
    return {"chunk": torch.from_numpy(b["chunk"]).to(dtype), "gt": torch.from_numpy(b["gt"]),
            "starts": torch.from_numpy(b["starts"].astype(np.int64))}


def test_ft_step_loss_and_gradients_match_jax(setup):
    jm, params, state, b, model = setup

    def loss_fn(p):
        tl = jax_streaming_pyramid(p["backbone"], state["backbone"], jnp.asarray(b["chunk"]))
        pyr = jax_gather_windows(tl, jnp.asarray(b["starts"]), T)
        out, _ = jm.decoder.apply(p["decoder"], {}, pyr, train=True)
        return jax_loss_func(out, jnp.asarray(b["gt"]), JaxLossConfig(**CFG))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = from_jax_trees(jax.tree_util.tree_map(np.asarray, jg), state)

    losses, worst = {}, {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(dtype)
        ts = init_train_state(m, 0.0)  # lr 0: the gradients stay to be read
        _, metrics = tft.make_streaming_ft_step(LossConfig(**CFG), clip_size=T)(
            ts, _batch(b, dtype))
        losses[dtype] = abs(float(metrics["loss"]) - float(jl)) / abs(float(jl))
        errs = {k: float((p.grad.double() - want[k].double()).abs().max()
                         / want[k].double().abs().max()) for k, p in m.named_parameters()}
        worst[dtype] = max(errs.items(), key=lambda kv: kv[1])
    print(f"loss rel err f32 {losses[torch.float32]:.3g}; gradients from JAX's: the port's "
          f"float64 {worst[torch.float64]}, its f32 {worst[torch.float32]}")
    assert losses[torch.float32] <= 1e-5
    assert worst[torch.float64][1] <= 1e-4, worst


def test_ft_step_freezes_bn_and_trains_weights(setup):
    *_, b, model = setup
    m = copy.deepcopy(model)
    before = copy.deepcopy(m.state_dict())
    ts = init_train_state(m)
    step = tft.make_streaming_ft_step(LossConfig(), clip_size=T)
    for _ in range(2):
        ts, metrics = step(ts, _batch(b))
        assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert ts.step == 2 and not m.backbone.training and m.decoder.training
    for k, v in m.state_dict().items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(v, before[k]), k
    assert not torch.equal(m.decoder.convtsp1[0].weight, before["decoder.convtsp1.0.weight"])
    assert not torch.equal(m.backbone.base1[0].bn_s.weight, before["backbone.base1.0.bn_s.weight"])


def test_ft_eval_step_goes_through_the_head(setup, monkeypatch):
    from vinet_tpu_torch.ops import saliency_head

    *_, b, model = setup
    calls = []
    real = saliency_head.saliency_head_up2x
    monkeypatch.setattr(saliency_head, "saliency_head_up2x",
                        lambda *a: calls.append(1) or real(*a))
    m = copy.deepcopy(model).train()
    metrics = tft.make_streaming_eval_step(LossConfig(), clip_size=T)(init_train_state(m),
                                                                     _batch(b))
    assert calls and m.training and m.backbone.training  # modes restored
    assert np.isfinite(float(metrics["loss"])) and -1 <= float(metrics["cc"]) <= 1
