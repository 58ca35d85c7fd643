"""Differentiable collectives: the all-reduce that stands in for the psum
XLA inserts in the JAX package's data-parallel step, and the three of
Megatron's tensor parallelism that stand in for what GSPMD inserts around
the JAX package's split matmuls (genconvit_tpu/parallel/mesh.py:52-81).

Over the mesh's 'model' group (a `ModelAxis`):

  * `copy_to_model` goes before a column split (each rank computes its
    block of the output features from the whole input): the identity
    forward, the gradient's sum over the group backward, since each rank's
    block sends back only its share of the input's gradient;
  * `reduce_from_model` goes after a row split (each rank multiplies its
    block of the input features): the sum over the group forward, the
    identity backward, since every rank holds the whole, equal gradient of
    the sum. (`all_reduce_sum` sums the gradient as well: after a row split
    it would scale every gradient upstream by the group's size);
  * `gather_from_model` joins the column blocks, in rank order: the forward
    is an all-reduce of a zero-filled buffer in which each rank wrote its
    block (gloo takes only broadcast and all-reduce on CUDA tensors, and
    NCCL takes the same call), the backward takes this rank's block of the
    gradient, without a sum.

`column_linear` and `row_linear` are the two halves of a split pair. The
row half multiplies in float32, sums the partial products over the group
in float32 and adds the bias once, after the sum, then rounds to the
activations' dtype, so that a split layer rounds once, as the unsplit
F.linear does. The models look both up on this module when called.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


class ModelAxis(NamedTuple):
    """A module's place on the mesh's 'model' axis: the group, its size and
    this rank's index in it (the block of every split tensor it holds)."""
    group: Any
    size: int
    index: int


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


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    size, index = dist.get_world_size(group), dist.get_rank(group)
    dim = dim % x.dim()
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = k * size
    out = x.new_zeros(shape)
    out.narrow(dim, index * k, k).copy_(x)
    dist.all_reduce(out, group=group)
    return out


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.k = dim % x.dim(), x.shape[dim]
        ctx.index = dist.get_rank(group)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.k, ctx.k).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x before a column split: the identity, whose backward sums the
    gradient over `group` (nothing to do without a gradient)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` after a row split; the identity backward."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's block of x along `dim`, joined in rank order; the
    backward takes this rank's block of the gradient."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _gather(x, group, dim)
    return _GatherFromModel.apply(x, group, dim)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  tp: Optional[ModelAxis]) -> torch.Tensor:
    """F.linear with this rank's block of the output features (weight and
    bias split on their first axis) of the whole input x; plain F.linear
    without a model axis."""
    if tp is not None:
        x = copy_to_model(x, tp.group)
    return F.linear(x, weight, bias)


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               tp: Optional[ModelAxis]) -> torch.Tensor:
    """F.linear of this rank's block of the input features x (weight split
    on its second axis; the bias whole): the float32 partial products
    summed over the group, the bias added once after the sum, the result
    in x's dtype; plain F.linear without a model axis."""
    if tp is None:
        return F.linear(x, weight, bias)
    if x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled():
        # bf16 operands, float32 result (models/convnext.f32_product's rule)
        z = torch.mm(x.reshape(-1, x.shape[-1]), weight.t(), out_dtype=torch.float32)
        z = z.reshape(x.shape[:-1] + (weight.shape[0],))
    else:
        z = x.float() @ weight.float().t()
    z = reduce_from_model(z, tp.group)
    if bias is not None:
        z = z + bias.float()
    return z.to(x.dtype)
