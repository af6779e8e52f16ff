"""Shared helpers for the tests that hold vinet_tpu_torch against vinet_tpu.

Inputs are made with numpy and handed to both packages; JAX stays on the CPU
and never calls ViNet.init (too slow at full width on the CPU): parameter
trees come from the committed fixture checkpoint or from jax.eval_shape.
"""

from __future__ import annotations

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
