"""Train and eval steps, ``vinet_tpu/training/trainer.py`` in PyTorch.

The train state holds the model (its parameters and BatchNorm statistics),
the Adam optimizer, the step count and the dropout seed, the counterpart of
the JAX package's dropout key. A model whose ``forward`` takes a
``generator`` (AViNet, AViNetFusion: the dropout of their encoders) gets in
each step a fresh ``torch.Generator`` on the batch's device seeded from
(seed, step), and with grad_accum N each microbatch i one from (seed, step,
i) (``dropout_generator``), as the JAX step folds the step and then i into
its key: the masks of a step depend on the seed and the step alone, so a
resumed run draws the same ones as a run that never stopped. The bits are
not JAX's threefry bits. A state with ``dropout_seed=None`` trains without
dropout, as a JAX state without ``"rng"`` does; visual ViNet draws nothing.

A train step is one forward of the model in training mode (BatchNorm on
batch statistics, the decoder's plain graph: ``models/decoder.py``), the
loss, the backward and one Adam update. With ``compute_dtype=torch.bfloat16``
the convolutions run in bf16 under autocast while the master weights, the
Adam state, the BatchNorm statistics and the loss stay f32. A batch with
``"audio"`` hands the waveforms to the model after the clip, in the train
step, the BatchNorm statistics, ``predict`` and the eval step alike. The
eval step runs the model in eval mode without autograd, so on a card its
decoder ends in the fused head kernel.

Data and model parallelism (``parallel/``; the JAX package's GSPMD step on
a mesh): ``init_train_state(..., mesh=)`` swaps in ``SyncBatchNorm`` over
the data group, so the statistics are the global batch's, and stores the
parameters that ``param_partition_specs`` shards as model-axis shards, each
cut along its spec's dim (1 for a transposed convolution's weight, else 0):
the optimizer, and with it the Adam state, holds the shards, and each step
gathers them (``all_gather`` along that dim, backward "slice") and runs the
model on the gathered tensors (``torch.func.functional_call``). Every model
rank computes the whole model on the same rows, so a shard's gradient is its
slice of the full gradient; it is not summed over the model group. After the
update the model's own parameters are refreshed from the shards, so
evaluation, checkpoints and exports see the full tensors. ``make_train_step(...,
mesh=)`` takes the global batch on every rank: the batch is cut into
grad_accum contiguous microbatches and each data rank takes its rows of
each, as JAX cuts the global batch and then shards each microbatch; dropout
masks are drawn at the global microbatch's shape (``RowsGenerator``); the
gradients and the loss are averaged over the data group, and the gradient
norm counts each sharded leaf once. So W ranks take the step of one
process on the global batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch
from torch import nn

from vinet_tpu_torch.models.transformer import RowsGenerator
from vinet_tpu_torch.ops.norm import batchnorms, override_momentum, sync_batchnorms
from vinet_tpu_torch.parallel.collectives import all_gather, all_reduce
from vinet_tpu_torch.parallel.mesh import Mesh, batch_slice, shard_batch
from vinet_tpu_torch.parallel.partition import param_partition_specs
from vinet_tpu_torch.training.losses import LossConfig, cc, loss_func, similarity
from vinet_tpu_torch.utils import trace


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
    dropout_seed: int | None = None  # None: no dropout
    lr_schedule: Callable[[int], float] | None = None  # step -> lr; None keeps Adam's lr
    mesh: Mesh | None = None
    # parameter name -> its model-axis shard, the tensor the optimizer updates
    shards: dict = dataclasses.field(default_factory=dict)
    # parameter name -> the dim its shard is cut along (``param_partition_specs``)
    shard_dims: dict = dataclasses.field(default_factory=dict)


def init_train_state(model: nn.Module, lr: float = 1e-4, *, seed: int | None = 0,
                     lr_schedule: Callable[[int], float] | None = None,
                     mesh: Mesh | None = None) -> TrainState:
    """The train state of a model whose weights are loaded: a fresh Adam
    state, step 0, and seed as the dropout seed (None: no dropout). With a
    mesh, model's BatchNorms are synced over the data group and its
    parameters sharded over the model axis (the module docstring); a world
    of one rank leaves model as it is."""
    shards, dims = {}, {}
    if mesh is not None:
        if mesh.coords is None:
            raise ValueError("this rank is outside the mesh")
        sync_batchnorms(model, mesh.groups["data"])
        if mesh.groups["model"] is not None:
            specs = param_partition_specs(model, mesh)
            m, j = mesh.shape["model"], mesh.coords[1]
            dims = {name: specs[name] for name, _ in model.named_parameters()
                    if specs[name] is not None}
            shards = {name: nn.Parameter(p.detach().chunk(m, dims[name])[j]
                                         .clone(memory_format=torch.contiguous_format))
                      for name, p in model.named_parameters() if name in dims}
    params = [shards.get(name, p) for name, p in model.named_parameters()]
    return TrainState(model=model, optimizer=adam(params, lr), dropout_seed=seed,
                      lr_schedule=lr_schedule, mesh=mesh, shards=shards, shard_dims=dims)


def _model_group(ts: TrainState):
    return ts.mesh.groups["model"] if ts.mesh is not None else None


def _forward(ts: TrainState) -> Callable:
    """The model's forward: on the gathered model-axis shards where the
    parameters are sharded."""
    if not ts.shards:
        return ts.model
    group = _model_group(ts)

    def run(*args, **kw):
        full = {name: all_gather(shard, group, ts.shard_dims[name])
                for name, shard in ts.shards.items()}
        return torch.func.functional_call(ts.model, full, args, kw, strict=False)

    return run


def _refresh_from_shards(ts: TrainState) -> None:
    """Copy the gathered shards into the model's own parameters."""
    params = dict(ts.model.named_parameters())
    with torch.no_grad():
        for name, shard in ts.shards.items():
            params[name].copy_(all_gather(shard, _model_group(ts), ts.shard_dims[name]))


def _optimizer_params(ts: TrainState) -> list:
    return [p for group in ts.optimizer.param_groups for p in group["params"]]


def optimizer_state_dict(ts: TrainState) -> dict:
    """The optimizer's state_dict with every model-axis shard's state
    gathered to the full tensor, in the parameters' order, as the state of
    the unsharded model (a collective over the model group: every model rank
    calls it)."""
    sd = ts.optimizer.state_dict()
    if not ts.shards:
        return sd
    dims = {id(ts.shards[name]): d for name, d in ts.shard_dims.items()}
    state = dict(sd["state"])
    for i, p in enumerate(_optimizer_params(ts)):
        if id(p) in dims and i in state:
            state[i] = {k: all_gather(v, _model_group(ts), dims[id(p)]) if v.shape == p.shape
                        else v for k, v in state[i].items()}
    return {**sd, "state": state}


def load_optimizer_state_dict(ts: TrainState, sd: dict) -> None:
    """Load an optimizer state_dict of the unsharded model
    (``optimizer_state_dict``'s) into ts, each shard's state cut from it."""
    if ts.shards:
        dims = {id(ts.shards[name]): d for name, d in ts.shard_dims.items()}
        m, j = ts.mesh.shape["model"], ts.mesh.coords[1]
        state = dict(sd["state"])
        for i, p in enumerate(_optimizer_params(ts)):
            d = dims.get(id(p))
            if d is not None and i in state:
                state[i] = {k: v.chunk(m, d)[j].clone(memory_format=torch.contiguous_format)
                            if v.dim() > d and v.shape[d] == m * p.shape[d] else v
                            for k, v in state[i].items()}
        sd = {**sd, "state": state}
    ts.optimizer.load_state_dict(sd)


def load_model_state_dict(ts: TrainState, sd: dict) -> None:
    """Load a state_dict of the unsharded model into ts's model and cut
    the model-axis shards from it."""
    ts.model.load_state_dict(sd, strict=True)
    params = dict(ts.model.named_parameters())
    m = ts.mesh.shape["model"] if ts.mesh is not None else 1
    with torch.no_grad():
        for name, shard in ts.shards.items():
            shard.copy_(params[name].chunk(m, ts.shard_dims[name])[ts.mesh.coords[1]])


def dropout_generator(seed: int | None, device, *keys: int) -> torch.Generator | None:
    """A torch.Generator on device seeded from (seed, *keys) through numpy's
    SeedSequence, the counterpart of ``jax.random.fold_in``; None for seed
    None."""
    if seed is None:
        return None
    state = np.random.SeedSequence([int(seed), *map(int, keys)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def takes_generator(model: nn.Module) -> bool:
    """Whether model's forward takes a dropout generator."""
    return "generator" in inspect.signature(model.forward).parameters


def _inputs(batch: dict) -> tuple:
    """The model's positional inputs of a batch: the clip, and the audio
    where the batch has it."""
    return (batch["clip"],) if batch.get("audio") is None else (batch["clip"], batch["audio"])


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
    """The L2 norm of all the tensors together (optax.global_norm), in f32
    (float64 for float64 tensors)."""
    return torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(t.to(torch.promote_types(t.dtype, torch.float32)))
        for t in tensors]))


def apply_update(ts: TrainState) -> torch.Tensor:
    """One Adam step on the gradients the optimizer's parameters hold (first
    averaged over the data group), at the schedule's rate for this step;
    returns the gradients' global norm, each model-axis shard's part summed
    over the model group."""
    params = [p for p in _optimizer_params(ts) if p.grad is not None]
    data = ts.mesh.groups["data"] if ts.mesh is not None else None
    if data is not None and params:
        flat = all_reduce(torch.cat([p.grad.flatten() for p in params]), data, "mean")
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))
    sharded = {id(p) for p in ts.shards.values()}
    replicated = [p.grad for p in params if id(p) not in sharded]
    if ts.shards:
        sq = all_reduce(global_norm([p.grad for p in params if id(p) in sharded]) ** 2,
                        _model_group(ts))
        norm = torch.sqrt(sq + global_norm(replicated) ** 2 if replicated else sq)
    else:
        norm = global_norm(replicated)
    if ts.lr_schedule is not None:
        for group in ts.optimizer.param_groups:
            group["lr"] = ts.lr_schedule(ts.step)
    ts.optimizer.step()
    ts.step += 1
    if ts.shards:
        _refresh_from_shards(ts)
    return norm


def make_train_step(loss_cfg: LossConfig, *, compute_dtype: torch.dtype | None = None,
                    grad_accum: int = 1, mesh: Mesh | None = None) -> Callable:
    """step(ts, batch) -> (ts, {"loss", "grad_norm"}), updating ts in place.

    batch: {"clip": (B, T, H, W, 3) normalised, "gt": (B, H, W) or
    (B, Cl, H, W), optional "audio": (B, L, 1)}, on the model's device.

    grad_accum=N runs N microbatches of B/N clips in order and makes one
    Adam step on the mean of their gradients: each microbatch normalises by
    its own batch statistics and the running statistics thread through the
    N forwards in order, as N consecutive forwards would. The loss returned
    is the mean of the microbatches' losses. Dropout: see the module's
    docstring.

    mesh: the state's (``init_train_state(..., mesh=)``); batch is then the
    global batch, the same on every rank, and each data rank runs its rows
    of each microbatch (the module's docstring)."""

    def step(ts: TrainState, batch: dict):
        if ts.mesh is not mesh:
            raise ValueError("the train state was made for another mesh: "
                             "init_train_state(..., mesh=) with the step's mesh")
        model = ts.model
        n = batch["clip"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} is not divisible by grad_accum {grad_accum}")
        dev = batch["clip"].device
        draws = takes_generator(model)
        forward = _forward(ts)
        model.train()
        ts.optimizer.zero_grad(set_to_none=True)
        losses = []
        for i in range(grad_accum):
            mb = {k: v.chunk(grad_accum)[i] for k, v in batch.items() if v is not None}
            rows = batch_slice(mesh, n // grad_accum)
            keys = (ts.step,) if grad_accum == 1 else (ts.step, i)
            kw = {}
            if draws:
                gen = dropout_generator(ts.dropout_seed, dev, *keys)
                if gen is not None and mesh is not None:
                    gen = RowsGenerator(gen, n // grad_accum, rows)
                kw = {"generator": gen}
            mb = {k: v[rows] for k, v in mb.items()}
            with trace.span("train.forward", request=ts.step):
                with autocast(dev, compute_dtype):
                    pred = forward(*_inputs(mb), **kw)
                acc = torch.promote_types(pred.dtype, torch.float32)  # f32, float64 for float64
                loss = loss_func(pred.to(acc), mb["gt"].to(acc), loss_cfg)
            with trace.span("train.backward", request=ts.step):
                (loss / grad_accum).backward()
            losses.append(loss.detach())
        with trace.span("train.update", request=ts.step):
            loss = all_reduce(torch.stack(losses).mean(),
                              mesh.groups["data"] if mesh is not None else None, "mean")
            grad_norm = apply_update(ts)
        return ts, {"loss": loss, "grad_norm": grad_norm}

    return step


def make_bn_stats_fn(model: nn.Module, mesh: Mesh | None = None) -> Callable:
    """stats(clip[, audio]) -> {BatchNorm name: (batch mean, unbiased batch
    var)} of every BatchNorm (SoundNet's too): a train-mode forward without
    autograd or dropout under override_momentum(1.0). The model's running
    statistics, its modes and its momenta are left as they were. With a
    mesh, clip and audio are the global batch, each data rank runs its rows
    and the synced BatchNorms give the global batch's statistics."""
    bns = batchnorms(model)

    def stats(clip: torch.Tensor, audio: torch.Tensor | None = None) -> dict:
        saved = {n: [t.clone() for t in (m.running_mean, m.running_var, m.num_batches_tracked)]
                 for n, m in bns.items()}
        local = shard_batch({"clip": clip, "audio": audio}, mesh)
        with kept_modes(model), override_momentum(model, 1.0), torch.no_grad():
            model.train()
            model(*_inputs(local))
            out = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in bns.items()}
            for n, m in bns.items():
                for t, v in zip((m.running_mean, m.running_var, m.num_batches_tracked), saved[n]):
                    t.copy_(v)
        return out

    return stats


def recalibrate_bn(model: nn.Module, batches, *, stats_fn: Callable | None = None) -> dict:
    """Replace every BatchNorm's running statistics with the mean of the
    per-batch statistics over batches ({"clip": ...[, "audio": ...]} dicts): the fix for
    from-scratch training, where momentum 0.001 leaves the running
    statistics near their initial values for thousands of steps. Returns
    the new statistics ({} and no change for no batches)."""
    stats_fn = stats_fn or make_bn_stats_fn(model)
    acc, n = {}, 0
    for b in batches:
        s = stats_fn(*_inputs(b))
        n += 1
        acc = s if n == 1 else {k: tuple(a + (v - a) / n for a, v in zip(acc[k], s[k]))
                                for k in acc}
    bns = batchnorms(model)
    with torch.no_grad():
        for k, (mean, var) in acc.items():
            bns[k].running_mean.copy_(mean)
            bns[k].running_var.copy_(var)
    return acc


def predict(model: nn.Module, clip: torch.Tensor,
            audio: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W) f32 maps of the model in eval mode without autograd (on a
    card through the fused head kernel), with the audio for an AV model;
    the model's modes are restored."""
    with kept_modes(model), torch.no_grad():
        model.eval()
        return model(*_inputs({"clip": clip, "audio": audio})).float()


def make_eval_step(loss_cfg: LossConfig) -> Callable:
    """step(ts, batch) -> ({"loss", "cc", "sim"}, pred): ``predict`` on the
    batch's clips (and audio) and the metrics at the model's resolution."""

    def step(ts: TrainState, batch: dict):
        pred = predict(ts.model, batch["clip"], batch.get("audio"))
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
