"""Shared helpers for the tests that hold vinet_tpu_torch against vinet_tpu.

Inputs are made with numpy and handed to both packages; JAX stays on the CPU
and never calls ViNet.init (too slow at full width on the CPU): parameter
trees come from the committed fixture checkpoint or from jax.eval_shape;
AViNet's from the port's seeded model, exported and read by JAX's converter.
"""

from __future__ import annotations

import copy
import functools
import os
import shutil

import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "artifacts", "streamft_fixture.npz")
TORCH_THREADS = 2  # six xdist workers share the host's cores

# (kernel, stride, padding, Cin, Cout): every conv kind of the int8 model
CONV_KINDS = {
    "1x1x1": ((1, 1, 1), (1, 1, 1), (0, 0, 0), 16, 24),  # Inception branches
    "7x1x1_s2_p3": ((7, 1, 1), (2, 1, 1), (3, 0, 0), 8, 8),  # stem conv_t
    "3x1x1_p1": ((3, 1, 1), (1, 1, 1), (1, 0, 0), 8, 12),  # SepConv3d conv_t
    "1x7x7_s2_p3_cin3": ((1, 7, 7), (1, 2, 2), (0, 3, 3), 3, 8),  # stem conv_s
    "1x3x3_p1": ((1, 3, 3), (1, 1, 1), (0, 1, 1), 5, 7),  # conv_s, decoder conv1
    "1x3x3_p1_cin24": ((1, 3, 3), (1, 1, 1), (0, 1, 1), 24, 16),  # Mixed-4c/4d conv_s, K 216
    "5x3x3_s5_p011": ((5, 3, 3), (5, 1, 1), (0, 1, 1), 6, 4),  # decoder conv3, conv4
}


def bf16_bits_to_f32(a: np.ndarray) -> np.ndarray:
    """2-byte void (bf16 stored by np.savez) -> exact f32."""
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def fixture_trees() -> tuple[dict, dict]:
    """The fixture's full-width ViNet(3, 32) (params, state), as f32 numpy."""
    trees = {"params": {}, "state": {}}
    with np.load(FIXTURE) as data:
        for key in data.files:
            prefix, name = key.split("/", 1)
            node = trees[prefix]
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = bf16_bits_to_f32(data[key])
    return trees["params"], trees["state"]


def random_tree(shapes, rng: np.random.Generator):
    """Fill a jax.eval_shape tree with seeded values: conv weights scaled by
    1/sqrt(fan_in), everything else standard normal * 0.1."""
    if isinstance(shapes, dict):
        return {k: random_tree(v, rng) for k, v in shapes.items()}
    shape = tuple(shapes.shape)
    scale = 1.0 / np.sqrt(np.prod(shape[:-1])) if len(shape) == 5 else 0.1
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def bn_tree(shapes, rng: np.random.Generator, leaf: str = ""):
    """Fill a jax.eval_shape tree of a model with BatchNorm: conv weights
    N(0, 1/fan_in), BatchNorm scale 1 + N(0, 0.01), bias and mean
    N(0, 0.01), var 1 + |N(0, 0.01)| (positive, as a variance must be)."""
    if isinstance(shapes, dict):
        return {k: bn_tree(v, rng, k) for k, v in shapes.items()}
    shape = tuple(shapes.shape)
    if len(shape) == 5:
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    v = rng.standard_normal(shape) * 0.1
    return ({"scale": 1.0 + v, "var": 1.0 + np.abs(v)}.get(leaf, v)).astype(np.float32)


def ndhwc_to_ncdhw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (0, 4, 1, 2, 3)))


def ncdhw_to_ndhwc(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 4, 1)))


def normalized_clip(seed: int, shape=(1, 32, 32, 32, 3)) -> np.ndarray:
    """A (B, T, H, W, 3) clip of random uint8 frames, ImageNet-normalised, f32."""
    from vinet_tpu_torch.data.pipeline import device_preprocess

    u8 = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return device_preprocess(torch.from_numpy(u8)).numpy()


def conv_paths(node: dict, path: tuple = ()):
    """(path, node) of every conv of a JAX params tree, float or int8."""
    for k, v in node.items():
        if isinstance(v, dict):
            if "w" in v or "w_q" in v:
                yield path + (k,), v
            else:
                yield from conv_paths(v, path + (k,))


def port_name(path: tuple) -> str:
    """A JAX ViNet(3, 32) conv path -> the port's module name."""
    from vinet_tpu_torch.io.weights import decoder_names

    if path[0] == "decoder":
        return f"decoder.{decoder_names(True)[path[1]]}"
    return ".".join(path)


def folded_port_model(trees: tuple):
    """The port's ViNet(3, 32) with the trees' weights, BatchNorm folded, f32."""
    from vinet_tpu_torch.io.weights import from_jax_trees
    from vinet_tpu_torch.models import ViNet, fold_batchnorms

    model = ViNet(3, 32)
    model.load_state_dict(from_jax_trees(*trees), strict=True)
    return fold_batchnorms(model.eval()).float()


def build_jax_emd(workdir) -> "ctypes.CDLL":
    """The JAX package's native EMD solver, built from its source with its own
    Makefile in workdir (a copy), so a test never runs ``make`` in
    ``vinet_tpu/native/emd`` beside the JAX tests. Returns the library with
    the argtypes ``vinet_tpu.metrics.emd._load_native`` sets; hand it to
    ``vinet_tpu.metrics.emd`` by patching ``_load_native``."""
    import ctypes
    import shutil
    import subprocess

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "vinet_tpu", "native", "emd")
    for name in ("emd_hat.cpp", "Makefile"):
        shutil.copy(os.path.join(src, name), workdir)
    subprocess.run(["make", "-C", str(workdir)], check=True, capture_output=True)
    lib = ctypes.CDLL(os.path.join(str(workdir), "libemd.so"))
    lib.emd_hat_compute.restype = ctypes.c_double
    lib.emd_hat_compute.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def av_trees(use_transformer: bool = False, input_hw=(64, 96), seed: int = 0):
    """(JAX AViNet(3, 32), params, state) of the model the card runs
    (``vinet_tpu_torch/inference/accuracy.py::av_fixture_model``: the visual
    leaves from the fixture, the audio and fusion leaves from a numpy seed
    by ``seeded_av_leaves``' convention), exported in the reference's layout
    and read by the JAX package's ``torch_state_dict_to_trees``, as a user's
    checkpoint would be. JAX's init is never called."""
    import io

    from vinet_tpu.io.convert import torch_state_dict_to_trees
    from vinet_tpu.models import AViNet
    from vinet_tpu_torch.inference.accuracy import av_fixture_model
    from vinet_tpu_torch.io.export import export_torch_checkpoint

    buf = io.BytesIO()
    export_torch_checkpoint(buf, av_fixture_model(FIXTURE, seed=seed,
                                                  use_transformer=use_transformer,
                                                  input_hw=input_hw))
    buf.seek(0)
    params, state = torch_state_dict_to_trees(torch.load(buf, weights_only=True))
    return AViNet(use_transformer=use_transformer, input_hw=tuple(input_hw)), params, state


def port_avinet(model, params: dict, state: dict):
    """The port's AViNet of the JAX model's flags with the trees' weights
    (strict), f32, eval mode, BatchNorm unfolded."""
    from vinet_tpu_torch.io.weights import from_jax_trees
    from vinet_tpu_torch.models import AViNet

    port = AViNet(use_transformer=model.use_transformer,
                  transformer_in_channel=model.transformer_in_channel,
                  num_encoder_layers=model.num_encoder_layers, nhead=model.nhead,
                  clip_size=model.clip_size, input_hw=model.input_hw)
    port.load_state_dict(from_jax_trees(params, state), strict=True)
    return port.eval().float()


def jax_folded(params: dict, state: dict):
    """The JAX package's fold_batchnorms of the trees, jitted (eagerly, a
    full-width tree takes some 10 s on the CPU)."""
    import jax

    from vinet_tpu.models.inference import fold_batchnorms

    return jax.jit(fold_batchnorms)(params, state)


def trees_as_arguments(predictor, name: str, fn) -> None:
    """Put into a JAX-package predictor's jit cache, under name, fn (one of
    its own unjitted `_build_*` functions, which read predictor.params and
    .state when traced) jitted with the trees as arguments instead of
    program constants: the same program, which XLA's constant folding of the
    weights would otherwise take tens of seconds to compile on the CPU."""
    import jax

    def run(params, state, *args):
        saved = predictor.params, predictor.state
        predictor.params, predictor.state = params, state
        try:
            return fn(*args)
        finally:
            predictor.params, predictor.state = saved

    jitted = jax.jit(run)
    predictor._jitted[name] = lambda *args: jitted(predictor.params, predictor.state, *args)


def av_bn_trees(use_transformer: bool = False, input_hw=(64, 64), seed: int = 0,
                fusion: bool = False, clip_size: int = 32):
    """(JAX AViNet or AViNetFusion (num_hier 3), params, state) with every
    leaf seeded by ``bn_tree`` over ``jax.eval_shape`` of the model's init
    (never run): small BatchNorm means, so that JAX's f32 train-mode
    BatchNorm, which takes the batch variance in one pass (E[x^2] - E[x]^2),
    keeps its precision, as on ``test_torch_training.py``'s trees."""
    import jax

    from vinet_tpu.models import AViNet, AViNetFusion

    jm = (AViNetFusion(clip_size=clip_size, input_hw=tuple(input_hw)) if fusion else
          AViNet(use_transformer=use_transformer, clip_size=clip_size,
                 input_hw=tuple(input_hw)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jm, bn_tree(shapes[0], rng), bn_tree(shapes[1], rng)


def av_batch(seed: int = 0, b: int = 2, hw=(64, 64), clip_size: int = 32) -> dict:
    """A seeded numpy AV batch: normal clips (B, T, H, W, 3), GT (B, H, W)
    in [0.05, 1], audio (B, 70560, 1) normal * 0.1."""
    rng = np.random.default_rng(seed)
    return {"clip": rng.standard_normal((b, clip_size, *hw, 3)).astype(np.float32),
            "gt": np.clip(rng.random((b, *hw)), 0.05, 1.0).astype(np.float32),
            "audio": (0.1 * rng.standard_normal((b, 70560, 1))).astype(np.float32)}


def jax_train_step_fn(jm, compute_dtype=None, grad_accum: int = 1):
    """fn(params, state, batch) -> (loss, new state as numpy): one step of
    the JAX package's ``make_train_step`` (Adam at 1e-4) from a state
    without "rng" (dropout off). One jitted step serves every call, so
    trees of one structure compile once."""
    import jax
    import jax.numpy as jnp

    from vinet_tpu.training.losses import LossConfig
    from vinet_tpu.training.trainer import adam, make_train_step

    opt = adam(1e-4)
    step = make_train_step(jm, LossConfig(), opt, donate=False, compute_dtype=compute_dtype,
                           grad_accum=grad_accum)

    def fn(params, state, batch):
        ts = {"params": params, "state": state, "opt_state": opt.init(params),
              "step": jnp.zeros((), jnp.int32)}
        new_ts, metrics = step(ts, {k: jnp.asarray(v) for k, v in batch.items()})
        return float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, new_ts["state"])

    return fn


@functools.lru_cache
def jax_train_forward(jm, compute_dtype=None):
    """The forward of the JAX package's ``make_train_step`` (its loss_fn:
    parameters, clip and audio cast to compute_dtype, ``apply(train=True)``
    without a key, the maps cast to f32), jitted once per model and dtype:
    fn(params, state, batch[, sharding]) -> (f32 maps, loss, new state) as
    numpy. The loss and the new state are the train step's; no backward is
    compiled. A batch without "audio" runs a visual model; sharding places
    the batch (a data mesh's ``batch_sharding``), as the JAX CLI does."""
    import jax
    import jax.numpy as jnp

    from vinet_tpu.models.inference import cast_floating
    from vinet_tpu.training.losses import LossConfig, loss_func

    def forward(params, state, batch):
        inputs = [batch["clip"]] + ([batch["audio"]] if "audio" in batch else [])
        if compute_dtype is not None:
            params = cast_floating(params, compute_dtype)
            inputs = [x.astype(compute_dtype) for x in inputs]
        pred, new_state = jm.apply(params, state, *inputs, train=True)
        pred = pred.astype(jnp.float32)
        return pred, loss_func(pred, batch["gt"], LossConfig()), new_state

    jitted = jax.jit(forward)
    return lambda params, state, batch, sharding=None: jax.tree_util.tree_map(
        np.asarray, jitted(params, state, {k: jax.device_put(jnp.asarray(v), sharding)
                                           for k, v in batch.items()}))


def port_train_step(model, batch: dict, compute_dtype=None):
    """One step of the port's ``make_train_step`` on a copy of model from a
    state without a dropout seed (dropout off), on a numpy batch: (loss,
    the trained copy)."""
    from vinet_tpu_torch.training import LossConfig
    from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

    m = copy.deepcopy(model)
    ts = init_train_state(m, seed=None)
    _, metrics = make_train_step(LossConfig(), compute_dtype=compute_dtype)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(metrics["loss"]), m


def running_stats_err(model, params: dict, jax_state: dict) -> dict:
    """{"visual", "audio"}: the worst BatchNorm running statistic of model
    (the visual net's, SoundNet's) as max |err| relative to its largest
    value, against a JAX state over params."""
    from vinet_tpu_torch.io.weights import from_jax_trees

    want = from_jax_trees(params, jax_state)
    errs = {"visual": 0.0, "audio": 0.0}
    for k, v in model.state_dict().items():
        if "running" in k:
            w = want[k].double()
            part = "audio" if k.startswith("audionet.") else "visual"
            errs[part] = max(errs[part], float((v.double() - w).abs().max() / w.abs().max()))
    return errs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def bring_up(rank: int, world: int, port: int, launcher: str = "vinet") -> tuple:
    """Join a gloo world on localhost through ``init_distributed``, from
    the JAX package's VINET_* variables or torchrun's (launcher "torchrun");
    returns its (rank, world)."""
    from vinet_tpu_torch.utils.runtime import init_distributed

    for k in ("VINET_COORDINATOR", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        os.environ.pop(k, None)
    if launcher == "vinet":
        os.environ.update(VINET_COORDINATOR=f"localhost:{port}",
                          VINET_NUM_PROCESSES=str(world), VINET_PROCESS_ID=str(rank))
    else:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    return init_distributed("cpu")


def _rank_main(rank: int, fn, world: int, port: int, outdir: str, args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the host's cores with other test workers
    bring_up(rank, world, port)
    try:
        torch.save(fn(rank, world, *args), os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class World:
    """``world`` spawned processes joined by gloo through
    ``init_distributed``'s VINET_* bring-up, each running fn(rank, world,
    *args) (a module-level function, pickled by name; its module must not
    import JAX, which would cost each rank seconds). ``results()`` waits and
    returns the ranks' return values, in rank order. Start it first and do
    the test process's own work meanwhile."""

    def __init__(self, fn, world: int, *args, workdir: str):
        self.world, self.workdir = world, str(workdir)
        self.ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, _free_port(), self.workdir, args), nprocs=world,
            join=False, start_method="spawn")

    def results(self, timeout: float = 300.0) -> list:
        import time

        deadline = time.monotonic() + timeout
        while not self.ctx.join(timeout=1.0):  # raises with a failed rank's traceback
            if time.monotonic() > deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {self.world}-rank world did not end in {timeout} s")
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


# --- the ranks' functions of the tests/test_torch_parallel*.py worlds ---

def rank_collectives(rank: int, world: int, torchrun_port: int) -> dict:
    """The world's bring-up through the VINET_* variables, again through
    torchrun's, then each collective's forward and backward on float64
    inputs that depend on the rank: {case: (output, input gradient)}."""
    import torch.distributed as dist

    from vinet_tpu_torch.parallel import all_gather, all_reduce

    out = {"vinet": (dist.get_rank(), dist.get_world_size(), dist.get_backend())}
    dist.destroy_process_group()
    out["torchrun"] = (*bring_up(rank, world, torchrun_port, "torchrun"), dist.get_backend())
    for name, fn in collective_cases().items():
        x = collective_input(rank).requires_grad_()
        y = fn(x, dist.group.WORLD, all_reduce, all_gather)
        (y * collective_weight(rank, y.shape, name)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def collective_cases() -> dict:
    return {"all_reduce_sum": lambda x, g, ar, ag: ar(x, g, "sum"),
            "all_reduce_mean": lambda x, g, ar, ag: ar(x, g, "mean"),
            "all_gather_slice": lambda x, g, ar, ag: ag(x, g, 1, "slice"),
            "all_gather_reduce_scatter": lambda x, g, ar, ag: ag(x, g, 1, "reduce_scatter")}


def collective_input(rank: int) -> torch.Tensor:
    return torch.arange(6, dtype=torch.float64).reshape(2, 3) * (rank + 1) + 10 * rank


def collective_weight(rank: int, shape, case: str) -> torch.Tensor:
    """The weights of a rank's objective sum(w * y): the same on every rank
    for "slice" (every rank computes one function of the gathered tensor),
    the rank's own otherwise."""
    k = 0 if case == "all_gather_slice" else rank
    return torch.linspace(-1.0, 2.0, int(np.prod(shape)), dtype=torch.float64).reshape(
        shape) * (k + 2)


def port_vinet(params: dict, state: dict, clip_size: int = 8, dtype=torch.float64):
    from vinet_tpu_torch.io.weights import from_jax_trees
    from vinet_tpu_torch.models import ViNet

    model = ViNet(3, clip_size)
    model.load_state_dict(from_jax_trees(params, state), strict=True)
    return model.to(dtype)


def port_fusion(dtype=torch.float64):
    """The port's AViNetFusion(clip 8, 64 x 96), seeded init (torch seed 0)."""
    from vinet_tpu_torch.models import AViNetFusion

    torch.manual_seed(0)
    return AViNetFusion(clip_size=8, input_hw=(64, 96)).to(dtype)


# name: (batch, grad_accum, dropout seed, the rank that takes the one-process
# step too, None: the test process, on the state rank 0 writes).
# grad_accum 2 at batch 8: with one row a rank a microbatch, the float64
# rounding of the two BatchNorm formulas grows past 1e-10 through the
# chaotic train-mode net
TRAIN_CASES = {"vinet_accum1": ("vinet4", 1, None, None),
               "vinet_accum2": ("vinet8", 2, None, 1), "fusion_dropout": ("fusion", 1, 7, 0)}


def float64_step(model, batch: dict, accum: int, seed, mesh=None) -> tuple:
    """One float64 train step (Adam 1e-4) of model on the global numpy batch
    over mesh: (train state, its loss, gradient norm and new state_dict as
    numpy)."""
    from vinet_tpu_torch.training import LossConfig
    from vinet_tpu_torch.training.trainer import init_train_state, make_train_step

    ts = init_train_state(model, 1e-4, seed=seed, mesh=mesh)
    step = make_train_step(LossConfig(), grad_accum=accum, mesh=mesh)
    _, metrics = step(ts, {k: torch.from_numpy(v).double() for k, v in batch.items()})
    return ts, {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "state": {k: v.detach().double().numpy().copy()
                          for k, v in ts.model.state_dict().items()}}


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def state_digest(state: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()


def step_errors(got: dict, want: dict) -> dict:
    """A step's relative errors against another's: loss, gradient norm, the
    worst tensor of the state_dict."""
    errs = {k: rel_err(got["state"][k], want["state"][k]) for k in want["state"]}
    worst = max(errs, key=errs.get)
    return {"loss_err": rel_err(got["loss"], want["loss"]),
            "grad_norm_err": rel_err(got["grad_norm"], want["grad_norm"]),
            "same_keys": got["state"].keys() == want["state"].keys(),
            "worst": worst, "state_err": errs[worst]}


def _summary(got: dict) -> dict:
    return {"loss": got["loss"], "grad_norm": got["grad_norm"],
            "digest": state_digest(got["state"])}


def rank_train(rank: int, world: int, trees: tuple, batches: dict, bn_inputs: dict,
               ckdir: str) -> dict:
    """In a world of 2: the synced BatchNorms on each rank's half; the
    data-2 steps of TRAIN_CASES and the (data 1 x model 2) step; the data-2
    checkpoint of "vinet_accum1" (an unsharded one, as one process writes)
    loaded into the model-2 state. A float64 state of the full-width model
    is too big to hand back: the rank a case names takes one process's step
    too and returns the errors, and rank 0 writes the "vinet_accum1" and
    model-2 states as checkpoints (ckdir/data2, ckdir/model2) for the test
    process. Each rank returns its states' losses, gradient norms and
    digests (both ranks hold the same state)."""
    import torch.distributed as dist

    from vinet_tpu_torch.io.checkpoint import restore_checkpoint, restore_raw, save_checkpoint
    from vinet_tpu_torch.ops.norm import SyncBatchNorm
    from vinet_tpu_torch.parallel import create_mesh
    from vinet_tpu_torch.training.trainer import init_train_state

    out = {"bn": {}, "data2": {}}
    for name, (x, w) in bn_inputs.items():
        half = slice(rank * x.shape[0] // 2, (rank + 1) * x.shape[0] // 2)
        bn = seeded_bn(SyncBatchNorm(x.shape[1], 1e-3, 0.1, dist.group.WORLD))
        xr = torch.from_numpy(x[half]).requires_grad_()
        y = bn(xr)
        (y * torch.from_numpy(w[half])).sum().backward()
        out["bn"][name] = {"y": y.detach().numpy(), "dx": xr.grad.numpy(),
                           "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
                           "running_mean": bn.running_mean.numpy(),
                           "running_var": bn.running_var.numpy()}

    mesh = create_mesh(2, model=1)
    for name, (kind, accum, seed, ref_rank) in TRAIN_CASES.items():
        make = port_fusion if kind == "fusion" else (lambda: port_vinet(*trees))
        ts, got = float64_step(make(), batches[kind], accum, seed, mesh)
        out["data2"][name] = _summary(got)
        if rank == ref_rank:
            _, want = float64_step(make(), batches[kind], accum, seed)
            out["data2"][name].update(step_errors(got, want))
        if name == "vinet_accum1":
            save_checkpoint(os.path.join(ckdir, "data2"), ts, write=rank == 0)
            out["jax_side"] = {"loss": got["loss"], "stats": {
                k: v for k, v in got["state"].items() if "running" in k}}
        del ts, got

    mesh2 = create_mesh(2, model=2)
    ts, got = float64_step(port_vinet(*trees), batches["vinet4"], 1, None, mesh2)
    out["model2"] = _summary(got)
    out["model2"]["shard_rows"] = {k: p.shape[0] for k, p in ts.shards.items()}
    save_checkpoint(os.path.join(ckdir, "model2"), ts, write=rank == 0)
    del ts, got
    dist.barrier()

    # an unsharded checkpoint into the model-2 state: the shards and their
    # Adam state are the file's, cut
    two = init_train_state(port_vinet(*trees), 1e-4, seed=None, mesh=mesh2)
    restore_checkpoint(os.path.join(ckdir, "data2"), two)
    ck = restore_raw(os.path.join(ckdir, "data2"))
    got_opt = two.optimizer.state_dict()["state"]
    names = [k for k, _ in two.model.named_parameters()]
    out["unsharded_into_model2"] = {
        "step": two.step, "sharded": len(two.shards),
        "shards": max(float((s.detach() - ck["model"][k].chunk(2)[rank]).abs().max())
                      for k, s in two.shards.items()),
        "adam": max(float((got_opt[i][k] - (v.chunk(2)[rank] if names[i] in two.shards
                                            and v.dim() else v)).abs().max())
                    for i, st in ck["optimizer"]["state"].items() for k, v in st.items())}
    return out


def seeded_bn(bn):
    """bn in float64 and train mode, its affine parameters and running
    statistics seeded by its channel count."""
    bn = bn.double()
    g = torch.Generator().manual_seed(bn.num_features)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(bn.num_features, generator=g, dtype=torch.float64))
        bn.running_var.copy_(1.0 + torch.rand(bn.num_features, generator=g, dtype=torch.float64))
    return bn.train()


INFER_LIVE = dict(clip_size=8, batch=4, micro=16, span=136, warmup_chunk=16)


def run_live_server(server, stacked: np.ndarray) -> dict:
    """Feed (S, N, H, W, 3) frames to a multi-stream server 16 at a time and
    flush: {stream: {frame: map}}."""
    got = []
    for lo in range(0, stacked.shape[1], 16):
        got.extend(server.feed(stacked[:, lo:lo + 16]))
    got.extend(server.flush())
    return {s: {i: m for si, i, m in got if si == s} for s in range(stacked.shape[0])}


def infer_predictors(trees: tuple, fixture: tuple, mesh=None, streams_frames=None) -> dict:
    """The port's predictors on the CPU in f32 over mesh (None: one
    process): {"parity", "streaming"} of ViNet(3, 8) with the trees on
    inputs["frames"], "av_streaming" of the seeded AViNet at 32 x 32, and
    "multilive" of the same ViNet(3, 8) on two streams (stream_mesh)."""
    from vinet_tpu_torch.inference import (AVStreamingPredictor, MultiLiveServer,
                                           SlidingWindowPredictor, StreamingPredictor)
    from vinet_tpu_torch.inference.accuracy import av_fixture_model

    frames, av_frames, av_exc, streams = fixture
    common = dict(dtype=torch.float32, device="cpu", mesh=mesh)
    vinet = port_vinet(*trees, dtype=torch.float32)
    out = {"parity": dict(SlidingWindowPredictor(vinet, clip_size=8, batch=4, **common)
                          .predict_video(frames)),
           "streaming": dict(StreamingPredictor(vinet, clip_size=8, batch=4, chunk=16, **common)
                             .predict_video(frames))}
    av = av_fixture_model(FIXTURE, seed=0, input_hw=(32, 32))
    out["av_streaming"] = dict(AVStreamingPredictor(av, batch=4, chunk=64, **common)
                               .predict_video(av_frames, audio_fn=lambda s: av_exc[s]))
    server = MultiLiveServer(vinet, streams=2, stream_mesh=mesh, dtype=torch.float32,
                             device="cpu", **INFER_LIVE)
    out["multilive"] = run_live_server(server, streams)
    return out


def rank_infer(rank: int, world: int, trees: tuple, fixture: tuple, x128: np.ndarray) -> dict:
    """In a world of 2 over create_mesh(): the predictors of
    ``infer_predictors`` with the mesh, and ``streaming_pyramid_tsharded``
    of ViNet(3, 8)'s backbone (the trees, eval mode) on x128 (1, 3, 128, H,
    W), as numpy."""
    from vinet_tpu_torch.inference.streaming import streaming_pyramid_tsharded
    from vinet_tpu_torch.parallel import create_mesh

    mesh = create_mesh()
    out = infer_predictors(trees, fixture, mesh)
    backbone = port_vinet(*trees, dtype=torch.float32).eval().backbone
    with torch.no_grad():
        out["tsharded"] = [y.numpy() for y in streaming_pyramid_tsharded(
            backbone, torch.from_numpy(x128), mesh)]
    return out


def rank_clis(rank: int, world: int, train_args: list, generate_args: list, out: str) -> dict:
    """In a world of 2: ``cli.train --multihost`` (its best model and its
    checkpoints under rank-named paths, so that what each rank writes
    shows), then ``cli.generate_result --data_parallel`` into a rank-named
    directory: each CLI's stdout."""
    import contextlib
    import io

    from vinet_tpu_torch.cli.generate_result import main as generate_main
    from vinet_tpu_torch.cli.train import main as train_main

    res = {}
    for name, main, argv in (
            ("train", train_main, train_args + [
                "--multihost", "--model_val_path", os.path.join(out, f"best{rank}.pt"),
                "--checkpoint_dir", os.path.join(out, f"ck{rank}")]),
            ("generate", generate_main, generate_args + [
                "--data_parallel", "--save_path", os.path.join(out, f"maps{rank}")])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res[f"{name}_rc"] = main(argv)
        res[name] = buf.getvalue()
    return res
