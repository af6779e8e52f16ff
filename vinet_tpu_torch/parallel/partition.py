"""Parameter partitioning along the mesh's model axis,
``vinet_tpu/parallel/partition.py`` in torch's layouts.

JAX's rules, by leaf: a conv weight (DHWIO, WIO) shards its out-channel
(last) axis, the bilinear's (O, I, J) its O, a 2-D ``w``/``in_proj_w`` its
axis 0, and the vectors of ``_VEC_KEYS`` (``b``, ``scale``, ``bias``,
``mean``, ``var``, ``in_proj_b``) their one axis. Through the weight bridge
(``io/weights.py``) each of those axes is torch's dim 0: a conv's (O, I,
...), the bilinear's (O, I, J), a Linear's (out, in), and each vector. So a
tensor named weight, bias, running_mean, running_var, in_proj_weight or
in_proj_bias shards dim 0; every other tensor (the sin/cos tables, the
BatchNorms' batch counts, the query positions) has no JAX leaf that shards.
The one exception is a transposed convolution's weight (TASEDv2's): JAX's
(kT, kH, kW, I, O) shards O, its last axis, which is torch's dim 1 of (I,
O, kT, kH, kW), so the rule looks at the module that holds the tensor. A
tensor whose sharded dim the model axis does not divide is replicated:
correctness never depends on divisibility.
"""

from __future__ import annotations

import itertools

import torch
from torch.nn.modules.conv import _ConvTransposeNd

from vinet_tpu_torch.parallel.mesh import Mesh

SHARDED_LEAVES = frozenset({"weight", "bias", "running_mean", "running_var",
                            "in_proj_weight", "in_proj_bias"})


def _shard_dim(module: torch.nn.Module, leaf: str, t: torch.Tensor, m: int) -> int | None:
    if leaf not in SHARDED_LEAVES or t.dim() < 1:
        return None
    dim = 1 if leaf == "weight" and isinstance(module, _ConvTransposeNd) else 0
    return dim if t.shape[dim] % m == 0 else None


def param_partition_specs(model: torch.nn.Module, mesh: Mesh) -> dict:
    """{name: the dim it shards on over the model axis, or None} of every
    parameter and buffer of model."""
    m = mesh.shape["model"]
    modules = dict(model.named_modules())
    specs = {}
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        holder, _, leaf = name.rpartition(".")
        specs[name] = _shard_dim(modules[holder], leaf, t, m)
    return specs
