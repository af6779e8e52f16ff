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
A tensor whose dim 0 the model axis does not divide is replicated:
correctness never depends on divisibility.
"""

from __future__ import annotations

import itertools

import torch

from vinet_tpu_torch.parallel.mesh import Mesh

SHARDED_LEAVES = frozenset({"weight", "bias", "running_mean", "running_var",
                            "in_proj_weight", "in_proj_bias"})


def param_partition_specs(model: torch.nn.Module, mesh: Mesh) -> dict:
    """{name: the dim it shards on over the model axis, or None} of every
    parameter and buffer of model."""
    m = mesh.shape["model"]
    return {name: 0 if (name.rsplit(".", 1)[-1] in SHARDED_LEAVES and t.dim() >= 1
                        and t.shape[0] % m == 0) else None
            for name, t in itertools.chain(model.named_parameters(), model.named_buffers())}
