"""The ("data", "model") mesh over torch.distributed ranks,
``vinet_tpu/parallel/mesh.py`` with one process a card.

A JAX mesh spans a process's devices, and GSPMD writes the collectives. Here
each rank drives one card and the mesh spans ranks: rank i sits at data index
i // model and model index i % model, the layout of JAX's
``np.asarray(devices).reshape(n // model, model)``. Along each axis the mesh
holds this rank's process group (the ranks that share its other index), or
``None`` for an axis of size 1, where every collective of
``parallel/collectives.py`` is the identity.

The data axis splits a batch's rows: ``batch_slice`` and ``shard_batch``
give a rank the rows of its data index, the counterpart of JAX's
``batch_sharding`` and ``shard_batch``, and ``gather_batch`` puts the rows
back together on every rank. A replicated tensor (JAX's ``replicate``) is a
full copy on every rank, which needs no function.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from vinet_tpu_torch.parallel.collectives import all_gather


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: dict  # {"data": D, "model": M}
    coords: tuple | None  # (data index, model index) of this rank; None outside the mesh
    groups: dict  # axis -> this rank's process group along it, None for an axis of size 1

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


def create_mesh(world: int | None = None, *, model: int = 1) -> Mesh:
    """The 2-D ("data", "model") mesh over ranks 0 .. world - 1 (default:
    every rank of the process group; one rank without one). Every rank of
    the process group calls it, those outside the mesh too, since each axis
    group is made by all of them; a rank outside gets coords None.

    model=1 is pure data parallelism; the model axis shards parameters
    (``parallel/partition.py``)."""
    total = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = total if world is None else int(world)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if not 0 < n <= total:
        raise ValueError(f"a mesh of {n} ranks in a world of {total}")
    data = n // model
    coords = divmod(rank, model) if rank < n else None
    groups = {"data": None, "model": None}
    # new_group is collective over the whole world: every rank makes every
    # group, in the same order, and keeps its own
    if data > 1:
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if coords is not None and coords[1] == j:
                groups["data"] = g
    if model > 1:
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if coords is not None and coords[0] == i:
                groups["model"] = g
    return Mesh({"data": data, "model": model}, coords, groups)


def batch_slice(mesh: Mesh | None, n: int) -> slice:
    """The rows of an n-row global batch that this rank's data index takes
    (all of them without a mesh)."""
    if mesh is None:
        return slice(0, n)
    if mesh.coords is None:
        raise ValueError("this rank is outside the mesh")
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"batch {n} is not divisible by the {d}-way data axis")
    k = n // d
    return slice(mesh.coords[0] * k, (mesh.coords[0] + 1) * k)


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's rows of every array of a global batch (None stays None)."""
    return {k: None if v is None else v[batch_slice(mesh, v.shape[0])]
            for k, v in batch.items()}


def gather_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The data ranks' rows concatenated in rank order, on every rank: the
    global batch of rows each rank took with ``batch_slice``."""
    return x if mesh is None else all_gather(x, mesh.groups["data"], dim=0)
