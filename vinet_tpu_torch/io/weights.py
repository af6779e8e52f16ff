"""Weights: JAX-package trees and reference state_dicts -> the port's state_dict.

The port's modules carry the reference's names, so a reference ``.pt``
state_dict loads with ``load_state_dict(strict=True)`` and no converter. The
JAX package's ``(params, state)`` trees go through ``from_jax_trees``, the
inverse of ``vinet_tpu/io/convert.py`` for ViNet (the same transforms as
``vinet_tpu/io/export.py``):

  * conv weight (kT, kH, kW, I, O) -> (O, I, kT, kH, kW); 'w'/'b' -> weight/bias
  * BatchNorm params scale/bias + state mean/var -> weight/bias/
    running_mean/running_var, plus num_batches_tracked (0)
  * decoder conv1..conv7 -> convtspN.i
"""

from __future__ import annotations

import numpy as np
import torch

_DEC_WITH_CONV6 = {"conv1": "convtsp1.0", "conv2": "convtsp2.0", "conv3": "convtsp3.0",
                   "conv4": "convtsp4.0", "conv5": "convtsp4.3", "conv6": "convtsp4.6",
                   "conv7": "convtsp4.8"}
_DEC_NO_CONV6 = {"conv1": "convtsp1.0", "conv2": "convtsp2.0", "conv3": "convtsp3.0",
                 "conv4": "convtsp4.0", "conv5": "convtsp4.3", "conv7": "convtsp4.6"}


def _tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if (a.dtype.kind == "V" and a.dtype.itemsize == 2) or a.dtype.name == "bfloat16":
        # bf16, stored by np.savez as a 2-byte void (or an ml_dtypes array
        # handed over in memory): reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _conv_weight(w) -> torch.Tensor:
    t = _tensor(w)
    if t.dim() != 5:
        raise ValueError(f"expected a 3-D conv weight (kT,kH,kW,I,O), got {tuple(t.shape)}")
    return t.permute(4, 3, 0, 1, 2).contiguous()


def from_jax_trees(params: dict, state: dict) -> dict:
    """JAX-package ViNet (params, state) nested dicts of arrays -> the port's
    state_dict of tensors (reference names)."""
    out: dict = {}

    def walk(p_node: dict, s_node: dict, path: list) -> None:
        for k, v in p_node.items():
            name = ".".join(path + [k])
            sv = s_node.get(k, {}) if isinstance(s_node, dict) else {}
            if k == "decoder" and not path:
                table = _DEC_WITH_CONV6 if "conv6" in v else _DEC_NO_CONV6
                for conv, node in v.items():
                    out[f"decoder.{table[conv]}.weight"] = _conv_weight(node["w"])
                    if "b" in node:
                        out[f"decoder.{table[conv]}.bias"] = _tensor(node["b"])
            elif isinstance(v, dict) and set(v) == {"scale", "bias"}:
                out[f"{name}.weight"] = _tensor(v["scale"])
                out[f"{name}.bias"] = _tensor(v["bias"])
                out[f"{name}.running_mean"] = _tensor(sv["mean"])
                out[f"{name}.running_var"] = _tensor(sv["var"])
                out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
            elif isinstance(v, dict):
                walk(v, sv, path + [k])
            elif k == "w":
                out[".".join(path + ["weight"])] = _conv_weight(v)
            elif k == "b":
                out[".".join(path + ["bias"])] = _tensor(v)
            else:
                raise KeyError(f"unhandled params leaf: {name}")

    walk(params, state, [])
    return out


def load_npz_trees(path: str) -> tuple[dict, dict]:
    """A JAX-package .npz ('params/<dotted>' and 'state/<dotted>' keys) ->
    (params, state) nested dicts of numpy arrays (bf16 leaves as 2-byte void)."""
    trees: dict = {"params": {}, "state": {}}
    with np.load(path) as data:
        for key in data.files:
            prefix, name = key.split("/", 1)
            node = trees[prefix]
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return trees["params"], trees["state"]


def load_weights(path: str) -> dict:
    """A state_dict for the port's ViNet from a JAX-package .npz or a
    reference .pt state_dict. Load it with load_state_dict(strict=True)."""
    if path.endswith(".npz"):
        return from_jax_trees(*load_npz_trees(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # a checkpoint saved from nn.DataParallel prefixes every name
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
