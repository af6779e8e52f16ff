"""Shared helpers for the tests that hold vinet_tpu_torch against vinet_tpu.

Inputs are made with numpy and handed to both packages; JAX stays on the CPU
and never calls ViNet.init (too slow at full width on the CPU): parameter
trees come from the committed fixture checkpoint or from jax.eval_shape.
"""

from __future__ import annotations

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "artifacts", "streamft_fixture.npz")
TORCH_THREADS = 2  # six xdist workers share the host's cores


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


def ndhwc_to_ncdhw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (0, 4, 1, 2, 3)))


def ncdhw_to_ndhwc(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 4, 1)))
