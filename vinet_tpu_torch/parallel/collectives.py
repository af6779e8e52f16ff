"""The collectives that GSPMD inserts for the JAX package, written out for
torch.distributed: an all-reduce and an all-gather over a process group,
each a ``torch.autograd.Function`` with its backward, and each the identity
for the group ``None`` (an axis of size 1, ``parallel/mesh.py``).

- ``all_reduce(x, group, "sum")``: every rank gets the sum of the ranks'
  x. Each rank's objective depends on the sum, so the gradient of a rank's
  x is the sum of the ranks' gradients of the sum: an all-reduce. "mean"
  divides both by the group's size.
- ``all_gather(x, group, dim)``: the ranks' x concatenated along dim in
  rank order. Backward ``"slice"``: every rank computes the same function
  of the gathered tensor (a model-axis weight that every model rank uses
  on the same rows), so each rank's gradient is the whole one and its x
  takes its own slice of it. ``"reduce_scatter"``: the ranks compute
  different functions of it (each on its own rows), so x takes its slice
  of the sum of the ranks' gradients.

Works on NCCL and gloo alike (``torch.distributed.nn.functional`` is
deprecated).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

REDUCE_OPS = ("sum", "mean")
GATHER_GRADS = ("slice", "reduce_scatter")


def _all_reduce_(t: torch.Tensor, group, op: str) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    if op == "mean":
        t.div_(dist.get_world_size(group))
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return _all_reduce_(x.contiguous().clone(), group, op)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.contiguous().clone(), ctx.group, ctx.op), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        x = x.contiguous()
        ctx.group, ctx.dim, ctx.grad, ctx.size = group, dim, grad, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        if ctx.grad == "reduce_scatter":
            grad = _all_reduce_(grad.clone(), ctx.group, "sum")
        lo = dist.get_rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, lo, ctx.size).contiguous(), None, None, None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or mean) of x over the group's ranks, on every rank."""
    if op not in REDUCE_OPS:
        raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")
    return x if group is None else _AllReduce.apply(x, group, op)


def all_gather(x: torch.Tensor, group, dim: int = 0, grad: str = "slice") -> torch.Tensor:
    """The group's x concatenated along dim in rank order, on every rank; every
    rank's x has the same shape. grad: the backward (module docstring)."""
    if grad not in GATHER_GRADS:
        raise ValueError(f"grad must be one of {GATHER_GRADS}, got {grad!r}")
    return x if group is None else _AllGather.apply(x, group, dim, grad)
