"""A differentiable all-reduce (the port's stand-in for the psum that XLA
inserts in the JAX package's data-parallel step)."""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward; the gradient's sum over the group
    in the backward (each rank's output feeds its own share of the loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group`, differentiable."""
    return _AllReduceSum.apply(x, group)
