"""Data and model parallelism on torch.distributed, ``vinet_tpu/parallel``:
the mesh over ranks (``mesh.py``), the collectives GSPMD writes for the JAX
package (``collectives.py``) and the model axis's partition rules
(``partition.py``)."""

from vinet_tpu_torch.parallel.collectives import all_gather, all_reduce
from vinet_tpu_torch.parallel.mesh import (Mesh, batch_slice, create_mesh, gather_batch,
                                           shard_batch)
from vinet_tpu_torch.parallel.partition import param_partition_specs

__all__ = ["Mesh", "all_gather", "all_reduce", "batch_slice", "create_mesh",
           "gather_batch", "param_partition_specs", "shard_batch"]
