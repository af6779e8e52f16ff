"""Weights the benchmark hands to both sides: the committed ViNet fixture read
from its ``.npz`` into a state_dict of the published names, and the
audio-visual leaves drawn on the device from the seed.

The fixture holds the JAX package's trees (``params/...``, ``state/...``)
with bf16 values stored as raw 2-byte words. Conv weights are (kT, kH, kW,
I, O) there and (O, I, kT, kH, kW) in a state_dict; BatchNorm ``scale``,
``bias``, ``mean``, ``var`` are ``weight``, ``bias``, ``running_mean``,
``running_var``; the decoder's conv1..conv7 are ``convtspN.i``.

This module imports nothing of the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

DECODER = {"conv1": "convtsp1.0", "conv2": "convtsp2.0", "conv3": "convtsp3.0",
           "conv4": "convtsp4.0", "conv5": "convtsp4.3", "conv6": "convtsp4.6",
           "conv7": "convtsp4.8"}
LEAF = {"w": "weight", "b": "bias", "scale": "weight", "mean": "running_mean",
        "var": "running_var"}


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _f32(a: np.ndarray) -> np.ndarray:
    """A fixture leaf as float32; 2-byte void words are bf16 bits."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def fixture_state_dict(path: str, expect_sha256: str | None = None) -> dict:
    """The fixture's ViNet as a float32 state_dict (CPU tensors), with
    ``num_batches_tracked`` 0. Raises if the file's hash is not the one the
    configuration names."""
    if expect_sha256 is not None and sha256(path) != expect_sha256:
        raise ValueError(f"{path}: sha256 is not the configuration's {expect_sha256}")
    out = {}
    with np.load(path) as z:
        for key in z.files:
            tree, name = key.split("/", 1)
            mod, leaf = name.rsplit(".", 1)
            if mod.startswith("decoder."):
                mod = "decoder." + DECODER[mod.split(".", 1)[1]]
            v = _f32(z[key])
            if leaf == "w":
                v = v.transpose(4, 3, 0, 1, 2)
            out[f"{mod}.{LEAF.get(leaf, leaf)}"] = torch.from_numpy(np.ascontiguousarray(v))
            if leaf == "mean":
                out[f"{mod}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out


def seeded_leaves(shapes: dict, seed: int, device) -> dict:
    """Values for the audio-visual leaves, name -> shape, drawn on device
    from seed in one generator, in the order of the sorted names: conv and
    bilinear weights N(0, 1/fan_in), biases N(0, 0.01²), BatchNorm weight
    1 + N(0, 0.1²), bias and running mean N(0, 0.1²), running var
    1 + |N(0, 0.1²)|; ``num_batches_tracked`` 0. The scheme of the program's
    ``seeded_av_leaves``, drawn with torch on the device."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        v = torch.randn(shape, generator=g, device=device)
        holder, leaf = name.rsplit(".", 1)
        if holder.rsplit(".", 1)[-1].startswith("batchnorm"):
            v = {"weight": 1.0 + 0.1 * v, "running_var": 1.0 + (0.1 * v).abs()}.get(leaf, 0.1 * v)
        elif len(shape) > 1:
            v = v / float(np.sqrt(np.prod(shape[1:])))
        else:
            v = 0.01 * v
        out[name] = v
    return out
