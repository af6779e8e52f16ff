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
    fn(params, state, batch) -> (f32 maps, loss, new state) as numpy. The
    loss and the new state are the train step's; no backward is compiled."""
    import jax
    import jax.numpy as jnp

    from vinet_tpu.models.inference import cast_floating
    from vinet_tpu.training.losses import LossConfig, loss_func

    def forward(params, state, batch):
        clip, audio = batch["clip"], batch["audio"]
        if compute_dtype is not None:
            params = cast_floating(params, compute_dtype)
            clip, audio = clip.astype(compute_dtype), audio.astype(compute_dtype)
        pred, new_state = jm.apply(params, state, clip, audio, train=True)
        pred = pred.astype(jnp.float32)
        return pred, loss_func(pred, batch["gt"], LossConfig()), new_state

    jitted = jax.jit(forward)
    return lambda params, state, batch: jax.tree_util.tree_map(
        np.asarray, jitted(params, state, {k: jnp.asarray(v) for k, v in batch.items()}))


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
