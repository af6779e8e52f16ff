"""Train and eval steps, ``vinet_tpu/training/trainer.py`` in PyTorch.

The train state holds the model (its parameters and BatchNorm statistics),
the Adam optimizer, the step count and a ``torch.Generator`` in place of the
JAX package's dropout key: visual ViNet draws nothing from it, the state
carries it so that checkpoints of models with dropout restore their stream.

A train step is one forward of the model in training mode (BatchNorm on
batch statistics, the decoder's plain graph: ``models/decoder.py``), the
loss, the backward and one Adam update. With ``compute_dtype=torch.bfloat16``
the convolutions run in bf16 under autocast while the master weights, the
Adam state, the BatchNorm statistics and the loss stay f32. The eval step
runs the model in eval mode without autograd, so on a card its decoder ends
in the fused head kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn

from vinet_tpu_torch.ops.norm import batchnorms, override_momentum
from vinet_tpu_torch.training.losses import LossConfig, cc, loss_func, similarity


def adam(params, lr: float = 1e-4) -> torch.optim.Adam:
    """The reference's optimizer, Adam at torch's defaults: the JAX package's
    ``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def step_decay(lr: float, every: int) -> Callable[[int], float]:
    """step -> learning rate, ``lr * 0.1 ** (step // every)``: the JAX
    package's ``optax.exponential_decay(lr, every, 0.1, staircase=True)``,
    counted in optimizer steps."""
    return lambda step: lr * 0.1 ** (step // every)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: torch.Generator = dataclasses.field(default_factory=torch.Generator)
    lr_schedule: Callable[[int], float] | None = None  # step -> lr; None keeps Adam's lr


def init_train_state(model: nn.Module, lr: float = 1e-4, *, seed: int = 0,
                     lr_schedule: Callable[[int], float] | None = None) -> TrainState:
    """The train state of a model whose weights are loaded: a fresh Adam
    state, step 0, and the generator seeded from seed."""
    return TrainState(model=model, optimizer=adam(model.parameters(), lr),
                      generator=torch.Generator().manual_seed(seed), lr_schedule=lr_schedule)


@contextlib.contextmanager
def kept_modes(model: nn.Module):
    """Restore every submodule's training flag on exit."""
    modes = [(m, m.training) for m in model.modules()]
    try:
        yield model
    finally:
        for m, training in modes:
            m.training = training


def autocast(device: torch.device, compute_dtype: torch.dtype | None):
    """Autocast to compute_dtype on device's type; None runs as stored."""
    return torch.autocast(device.type, dtype=compute_dtype or torch.bfloat16,
                          enabled=compute_dtype is not None)


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all the tensors together (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float())
                                                 for t in tensors]))


def apply_update(ts: TrainState) -> torch.Tensor:
    """One Adam step on the gradients the parameters hold, at the schedule's
    rate for this step; returns the gradients' global norm."""
    grads = [p.grad for p in ts.model.parameters() if p.grad is not None]
    norm = global_norm(grads)
    if ts.lr_schedule is not None:
        for group in ts.optimizer.param_groups:
            group["lr"] = ts.lr_schedule(ts.step)
    ts.optimizer.step()
    ts.step += 1
    return norm


def make_train_step(loss_cfg: LossConfig, *, compute_dtype: torch.dtype | None = None,
                    grad_accum: int = 1) -> Callable:
    """step(ts, batch) -> (ts, {"loss", "grad_norm"}), updating ts in place.

    batch: {"clip": (B, T, H, W, 3) normalised, "gt": (B, H, W) or
    (B, Cl, H, W)}, on the model's device.

    grad_accum=N runs N microbatches of B/N clips in order and makes one
    Adam step on the mean of their gradients: each microbatch normalises by
    its own batch statistics and the running statistics thread through the
    N forwards in order, as N consecutive forwards would. The loss returned
    is the mean of the microbatches' losses."""

    def step(ts: TrainState, batch: dict):
        model = ts.model
        clip, gt = batch["clip"], batch["gt"]
        if clip.shape[0] % grad_accum:
            raise ValueError(f"batch {clip.shape[0]} is not divisible by grad_accum {grad_accum}")
        model.train()
        ts.optimizer.zero_grad(set_to_none=True)
        losses = []
        for c, g in zip(clip.chunk(grad_accum), gt.chunk(grad_accum)):
            with autocast(c.device, compute_dtype):
                pred = model(c)
            loss = loss_func(pred.float(), g.float(), loss_cfg)
            (loss / grad_accum).backward()
            losses.append(loss.detach())
        grad_norm = apply_update(ts)
        return ts, {"loss": torch.stack(losses).mean(), "grad_norm": grad_norm}

    return step


def make_bn_stats_fn(model: nn.Module) -> Callable:
    """stats(clip) -> {BatchNorm name: (batch mean, unbiased batch var)}: a
    train-mode forward without autograd under override_momentum(1.0). The
    model's running statistics, its modes and its momenta are left as they
    were."""
    bns = batchnorms(model)

    def stats(clip: torch.Tensor) -> dict:
        saved = {n: [t.clone() for t in (m.running_mean, m.running_var, m.num_batches_tracked)]
                 for n, m in bns.items()}
        with kept_modes(model), override_momentum(model, 1.0), torch.no_grad():
            model.train()
            model(clip)
            out = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in bns.items()}
            for n, m in bns.items():
                for t, v in zip((m.running_mean, m.running_var, m.num_batches_tracked), saved[n]):
                    t.copy_(v)
        return out

    return stats


def recalibrate_bn(model: nn.Module, batches, *, stats_fn: Callable | None = None) -> dict:
    """Replace every BatchNorm's running statistics with the mean of the
    per-batch statistics over batches ({"clip": ...} dicts): the fix for
    from-scratch training, where momentum 0.001 leaves the running
    statistics near their initial values for thousands of steps. Returns
    the new statistics ({} and no change for no batches)."""
    stats_fn = stats_fn or make_bn_stats_fn(model)
    acc, n = {}, 0
    for b in batches:
        s = stats_fn(b["clip"])
        n += 1
        acc = s if n == 1 else {k: tuple(a + (v - a) / n for a, v in zip(acc[k], s[k]))
                                for k in acc}
    bns = batchnorms(model)
    with torch.no_grad():
        for k, (mean, var) in acc.items():
            bns[k].running_mean.copy_(mean)
            bns[k].running_var.copy_(var)
    return acc


def predict(model: nn.Module, clip: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 maps of the model in eval mode without autograd (on a
    card through the fused head kernel); the model's modes are restored."""
    with kept_modes(model), torch.no_grad():
        model.eval()
        return model(clip).float()


def make_eval_step(loss_cfg: LossConfig) -> Callable:
    """step(ts, batch) -> ({"loss", "cc", "sim"}, pred): ``predict`` on the
    batch's clips and the metrics at the model's resolution."""

    def step(ts: TrainState, batch: dict):
        pred = predict(ts.model, batch["clip"])
        gt = batch["gt"]
        return {"loss": loss_func(pred, gt, loss_cfg), "cc": cc(pred, gt),
                "sim": similarity(pred, gt)}, pred

    return step


class AverageMeter:
    """Running mean with the reference's semantics (utils.py AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
