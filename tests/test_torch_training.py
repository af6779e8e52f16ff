"""vinet_tpu_torch's training path against vinet_tpu's, and its mechanics.

Against JAX, on the same numpy-made trees and batch, on the CPU, with JAX in
f32. The port's gradients are taken in float64 where they are compared: its
CPU f32 convolution backward rounds more than XLA's (up to 2.8e-3 of a
leaf's largest value away from its own float64 result on these inputs,
where JAX's f32 stays within 1e-5 of it), so float64 shows the port's graph
without that rounding.

- one train-mode forward + backward of ViNet(3, 8) at (2, 8, 64, 96) against
  jax.value_and_grad over model.apply(train=True): the f32 loss within 1e-5
  relative, the new BatchNorm running statistics within 1e-5, and the whole
  gradient within 10 % (relative L2). Train-mode BatchNorm after every conv
  makes this gradient chaotic, so f32 cannot resolve it tighter: JAX's f32
  gradient lies 4.7 % (L2) from the port's float64 one, and the port's own
  f32 gradient 1.2 % (both printed by the test). So the pieces are held
  tightly as well:
- the same model with the backbone's BatchNorm frozen (eval mode) and the
  decoder's training graph, the configuration of streaming fine-tuning:
  every leaf's gradient within 5e-4 of the leaf's largest value (JAX's
  f32 gradients lie up to 1.6e-4 from the port's float64 ones here, the
  rounding of f32 itself; the f32 loss within 1e-5);
- nn.BatchNorm3d(eps=1e-3, momentum=0.001) in train mode against
  ``vinet_tpu/ops/norm.py::batchnorm_train`` on one layer: output and
  gradients within 1e-5, running statistics within 1e-6, each relative to
  its largest value.

Torch-only mirrors of ``tests/test_training.py``: the loss falls, bf16 stays
close to f32 with f32 masters and statistics, BatchNorm statistics move,
recalibration equals the mean of per-batch statistics, grad_accum equals the
mean of microbatches, a checkpoint round-trips, resume equals an unbroken
run, and the train route never reaches the head while eval does.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_util import TORCH_THREADS, bn_tree
from vinet_tpu.models import ViNet as JaxViNet
from vinet_tpu.ops.norm import batchnorm_train
from vinet_tpu.training.losses import LossConfig as JaxLossConfig
from vinet_tpu.training.losses import loss_func as jax_loss_func
from vinet_tpu_torch.io.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from vinet_tpu_torch.io.weights import from_jax_trees
from vinet_tpu_torch.models import ViNet
from vinet_tpu_torch.ops.norm import override_momentum
from vinet_tpu_torch.training import LossConfig, loss_func
from vinet_tpu_torch.training.trainer import (AverageMeter, init_train_state, make_bn_stats_fn,
                                              make_eval_step, make_train_step, recalibrate_bn,
                                              step_decay)

torch.set_num_threads(TORCH_THREADS)
SHAPE = (2, 8, 64, 96, 3)


@pytest.fixture(scope="module")
def setup():
    """JAX ViNet(3, 8) trees, a batch, and the port's model with the trees."""
    jm = JaxViNet(3, 8)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params, state = bn_tree(shapes[0], rng), bn_tree(shapes[1], rng)
    clip = rng.standard_normal(SHAPE).astype(np.float32)
    gt = np.clip(rng.random(SHAPE[:1] + SHAPE[2:4]), 0.05, 1.0).astype(np.float32)
    model = ViNet(3, 8)
    model.load_state_dict(from_jax_trees(params, state), strict=True)
    return jm, params, state, clip, gt, model


def _batch(clip, gt):
    return {"clip": torch.from_numpy(clip), "gt": torch.from_numpy(gt)}


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _grads(model) -> dict:
    return {k: p.grad.detach().double() for k, p in model.named_parameters()}


def test_train_mode_forward_backward_matches_jax(setup):
    jm, params, state, clip, gt, model = setup

    def loss_fn(p):
        pred, new_state = jm.apply(p, state, jnp.asarray(clip), train=True)
        return jax_loss_func(pred, jnp.asarray(gt), JaxLossConfig()), new_state

    (jl, jstate), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = from_jax_trees(jax.tree_util.tree_map(np.asarray, jg),
                          jax.tree_util.tree_map(np.asarray, jstate))

    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(dtype).train()
        loss = loss_func(m(torch.from_numpy(clip).to(dtype)), torch.from_numpy(gt).to(dtype),
                         LossConfig())
        loss.backward()
        grads[dtype] = _grads(m)
        if dtype == torch.float32:
            loss32, stats = float(loss), dict(m.named_buffers())
    loss_err = abs(loss32 - float(jl)) / abs(float(jl))
    stat_err = max(float((stats[k].double() - want[k].double()).abs().max())
                   for k in stats if "running" in k)

    def flat(g):
        return torch.cat([g[k].double().flatten() for k in sorted(g)])

    g32, g64 = flat(grads[torch.float32]), flat(grads[torch.float64])
    gj = flat({k: want[k] for k in grads[torch.float64]})
    l2_jax = float((gj - g64).norm() / g64.norm())
    l2_f32 = float((g32 - g64).norm() / g64.norm())
    print(f"loss rel err {loss_err:.3g}, BN stats max err {stat_err:.3g}; gradient rel L2 "
          f"from the port's float64: JAX f32 {l2_jax:.3g}, the port's f32 {l2_f32:.3g}")
    assert loss_err <= 1e-5, loss_err
    assert stat_err <= 1e-5, stat_err
    assert l2_jax <= 0.1, l2_jax


def test_frozen_bn_gradients_match_jax(setup):
    """Backbone BatchNorm in eval mode, decoder in training mode: every
    leaf's gradient within 5e-4 of its largest value (l1 in the loss, so
    that conv7's bias gradient is not a sum that cancels)."""
    jm, params, state, clip, gt, model = setup
    cfg = dict(kldiv=True, l1=True)

    def loss_fn(p):
        pyr, _ = jm.backbone.apply(p["backbone"], state["backbone"], jnp.asarray(clip))
        out, _ = jm.decoder.apply(p["decoder"], {}, pyr, train=True)
        return jax_loss_func(out, jnp.asarray(gt), JaxLossConfig(**cfg))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = from_jax_trees(jax.tree_util.tree_map(np.asarray, jg), state)
    losses, errs = {}, {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(dtype)
        m.backbone.eval()
        m.decoder.train()
        loss = loss_func(m(torch.from_numpy(clip).to(dtype)), torch.from_numpy(gt).to(dtype),
                         LossConfig(**cfg))
        loss.backward()
        losses[dtype] = abs(float(loss) - float(jl)) / abs(float(jl))
        errs[dtype] = {k: _rel_err(want[k], g) for k, g in _grads(m).items()}
    worst = max(errs[torch.float64], key=errs[torch.float64].get)
    print(f"loss rel err f32 {losses[torch.float32]:.3g}; JAX f32 gradients from the port's "
          f"float64: worst leaf {worst} {errs[torch.float64][worst]:.3g}; from the port's f32: "
          f"{max(errs[torch.float32].values()):.3g}")
    assert losses[torch.float32] <= 1e-5, losses
    assert errs[torch.float64][worst] <= 5e-4, (worst, errs[torch.float64][worst])


def test_batchnorm3d_train_mode_matches_jax_batchnorm_train():
    """nn.BatchNorm3d in train mode = batchnorm_train: biased variance to
    normalise, unbiased variance into the running statistics, momentum as
    the update fraction; also under override_momentum(1.0)."""
    rng = np.random.default_rng(3)
    c = 16
    x = (rng.standard_normal((2, 3, 5, 7, c)) * 2.0 + 0.5).astype(np.float32)  # NDHWC
    scale, bias = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32), \
        (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0, var0 = (0.1 * rng.standard_normal(c)).astype(np.float32), \
        (1 + np.abs(0.1 * rng.standard_normal(c))).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    for momentum in (0.001, 1.0):
        def f(x, p):
            y, s = batchnorm_train(p, {"mean": mean0, "var": var0}, x, eps=1e-3,
                                   momentum=momentum)
            return jnp.sum(y * dy), (y, s)

        (_, (y, s)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})

        bn = torch.nn.BatchNorm3d(c, eps=1e-3, momentum=0.001).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
            bn.running_mean.copy_(torch.from_numpy(mean0))
            bn.running_var.copy_(torch.from_numpy(var0))
        xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
        with override_momentum(bn, momentum):
            yt = bn(xt)
        assert bn.momentum == 0.001  # restored on exit
        yt.backward(torch.from_numpy(np.moveaxis(dy, -1, 1).copy()))
        assert _rel_err(np.moveaxis(yt.detach().numpy(), 1, -1), y) <= 1e-5
        assert _rel_err(np.moveaxis(xt.grad.numpy(), 1, -1), gx) <= 1e-5
        assert _rel_err(bn.weight.grad, gp["scale"]) <= 1e-5
        assert _rel_err(bn.bias.grad, gp["bias"]) <= 1e-5
        assert _rel_err(bn.running_mean, s["mean"]) <= 1e-6
        assert _rel_err(bn.running_var, s["var"]) <= 1e-6


@pytest.fixture()
def fresh(setup):
    """A copy of the port's model and the batch, as torch tensors."""
    *_, clip, gt, model = setup
    return copy.deepcopy(model), _batch(clip, gt)


def test_train_step_decreases_loss_and_moves_bn_stats(fresh):
    model, batch = fresh
    ts = init_train_state(model)
    step = make_train_step(LossConfig())
    mean0 = model.backbone.base1[0].bn_s.running_mean.clone()
    losses = []
    for _ in range(5):
        ts, m = step(ts, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    assert ts.step == 5
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert not torch.equal(model.backbone.base1[0].bn_s.running_mean, mean0)


def test_bf16_train_step_tracks_f32_with_f32_masters(setup):
    *_, clip, gt, model = setup
    batch = _batch(clip, gt)
    runs = {}
    for dtype in (None, torch.bfloat16):
        m = copy.deepcopy(model)
        ts = init_train_state(m)
        step = make_train_step(LossConfig(), compute_dtype=dtype)
        runs[dtype] = [float(step(ts, batch)[1]["loss"]) for _ in range(4)]
        assert all(p.dtype == torch.float32 for p in m.parameters())
        assert all(b.dtype != torch.bfloat16 for b in m.buffers())
        assert all(s.dtype == torch.float32 for st in ts.optimizer.state.values()
                   for s in st.values() if s.dim() > 0)
    np.testing.assert_allclose(runs[torch.bfloat16], runs[None], rtol=0.05, atol=0.02)


def test_grad_accum_equals_the_mean_of_microbatches(fresh):
    """grad_accum 2: the mean of the two microbatches' gradients, and the
    running statistics of the two forwards in order."""
    model, batch = fresh
    ref = copy.deepcopy(model).train()
    want, losses = None, []
    for i in range(2):
        ref.zero_grad()
        loss = loss_func(ref(batch["clip"][i:i + 1]), batch["gt"][i:i + 1], LossConfig())
        loss.backward()
        g = _grads(ref)
        want = g if want is None else {k: (want[k] + g[k]) / 2 for k in g}
        losses.append(float(loss))
    ts = init_train_state(model, 0.0)  # lr 0: the gradients stay to be read
    ts, m = make_train_step(LossConfig(), grad_accum=2)(ts, batch)
    got = _grads(model)
    assert max(_rel_err(got[k], want[k]) for k in want) <= 1e-6
    assert abs(float(m["loss"]) - np.mean(losses)) <= 1e-6
    for (k, a), b in zip(model.named_buffers(), ref.buffers()):
        assert torch.allclose(a, b, rtol=0, atol=1e-7), k


def test_bn_recalibration_is_the_mean_of_per_batch_stats(fresh):
    """recalibrate_bn's running statistics are the mean over batches of each
    batch's mean and unbiased variance; the model's modes, momenta and
    parameters are left as they were."""
    model, batch = fresh
    model.eval()
    clips = [batch["clip"][:1], batch["clip"][1:]]
    per_batch = []
    for c in clips:
        m = copy.deepcopy(model).train()
        with override_momentum(m, 1.0), torch.no_grad():
            m(c)
        per_batch.append({k: v.clone() for k, v in m.named_buffers() if "running" in k})
    stats_fn = make_bn_stats_fn(model)
    before = copy.deepcopy(model.state_dict())
    one = stats_fn(clips[0])
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    name = "backbone.base1.0.bn_s"
    assert torch.allclose(one[name][1], per_batch[0][f"{name}.running_var"], atol=1e-6)
    recalibrate_bn(model, [{"clip": c} for c in clips], stats_fn=stats_fn)
    assert not model.training and all(bn.momentum == 0.001 for bn in model.modules()
                                      if isinstance(bn, torch.nn.BatchNorm3d))
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.allclose(v, (per_batch[0][k] + per_batch[1][k]) / 2, atol=1e-6), k
        else:
            assert torch.equal(v, before[k]), k


def test_checkpoint_roundtrip_and_resume_equal_an_unbroken_run(fresh, tmp_path):
    model, batch = fresh
    step = make_train_step(LossConfig())
    unbroken = init_train_state(copy.deepcopy(model), seed=7)
    for _ in range(3):
        step(unbroken, batch)

    ts = init_train_state(copy.deepcopy(model), seed=7)
    step(ts, batch)
    save_checkpoint(str(tmp_path), ts)
    assert latest_step(str(tmp_path)) == 1
    resumed = init_train_state(copy.deepcopy(model), seed=0)
    restore_checkpoint(str(tmp_path), resumed)
    assert resumed.step == 1
    assert resumed.dropout_seed == ts.dropout_seed == 7
    for (k, a), b in zip(resumed.model.state_dict().items(), ts.model.state_dict().values()):
        assert torch.equal(a, b), k
    for _ in range(2):
        step(resumed, batch)
    assert resumed.step == unbroken.step == 3
    for (k, a), b in zip(resumed.model.state_dict().items(),
                         unbroken.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoints_keep_the_newest_three(fresh, tmp_path):
    model, _ = fresh
    ts = init_train_state(model)
    for s in range(5):
        ts.step = s
        save_checkpoint(str(tmp_path), ts)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2.pt", "step_3.pt", "step_4.pt"]
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "missing")) is None


def test_train_route_never_reaches_the_head_and_eval_does(fresh, monkeypatch):
    """The train step runs the decoder's plain graph; the eval step the
    folded tail and the head (the fused kernel on a card), on the weights
    as they stand after the step."""
    from vinet_tpu_torch.ops import saliency_head

    model, batch = fresh
    calls = []
    real = saliency_head.saliency_head_up2x
    monkeypatch.setattr(saliency_head, "saliency_head_up2x",
                        lambda *a: calls.append(1) or real(*a))
    ts = init_train_state(model)
    ev = make_eval_step(LossConfig())
    metrics0, pred0 = ev(ts, batch)
    assert len(calls) == 1 and model.training  # the modes are restored
    make_train_step(LossConfig())(ts, batch)
    assert len(calls) == 1
    metrics, pred = ev(ts, batch)
    assert len(calls) == 2 and pred.shape == batch["gt"].shape
    assert not torch.equal(pred, pred0)  # conv5's kept fold follows the new weights
    with torch.no_grad():
        ref = copy.deepcopy(model).eval()
        ref.decoder._fold5 = None
        assert torch.allclose(pred, ref(batch["clip"]), atol=1e-6)
    assert np.isfinite(float(metrics["loss"])) and -1 <= float(metrics["cc"]) <= 1


def test_step_decay_and_average_meter():
    lr = step_decay(1e-4, 10)
    assert [lr(s) for s in (0, 9, 10, 25)] == [1e-4, 1e-4, 1e-4 * 0.1, 1e-4 * 0.1 ** 2]
    meter = AverageMeter()
    meter.update(2.0)
    meter.update(4.0, n=3)
    assert (meter.val, meter.sum, meter.count, meter.avg) == (4.0, 14.0, 4, 3.5)
