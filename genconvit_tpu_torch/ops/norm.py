"""Normalization (port of genconvit_tpu/ops/norm.py:16-66).

LayerNorm over the trailing axis with float32 two-pass statistics, and
BatchNorm over NCHW channels (eps 1e-5): eval mode with the running
statistics, train mode with the batch's.
"""

from __future__ import annotations

from typing import Tuple

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; statistics and affine in float32,
    result in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_2d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over C of an NCHW tensor (timm LayerNorm2d). Under
    channels_last the NHWC view is contiguous, so nothing is copied."""
    y = layer_norm(x.permute(0, 2, 3, 1), scale, bias, eps)
    return y.permute(0, 3, 1, 2)


def batch_norm(x: torch.Tensor, bn: torch.nn.BatchNorm2d,
               eps: float = 1e-5) -> torch.Tensor:
    """Eval BatchNorm2d with the module's running statistics, in float32."""
    shape = (1, -1, 1, 1)
    y = (x.float() - bn.running_mean.float().view(shape)) * torch.rsqrt(
        bn.running_var.float().view(shape) + eps)
    y = y * bn.weight.float().view(shape) + bn.bias.float().view(shape)
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: torch.nn.BatchNorm2d, momentum: float = 0.1,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Train BatchNorm2d (genconvit_tpu/ops/norm.py:33-62): normalize with the
    batch's float32 statistics (biased variance); return the output and the
    new running statistics, (1 - m) * old + m * batch with the unbiased
    variance, without touching the module's buffers (a rematerialized
    forward runs twice and would apply the momentum twice). The old
    statistic is taken in its own dtype, as the JAX package's
    `(1 - momentum) * params["mean"]` (a weakly typed scalar keeps a
    bfloat16 array bfloat16); the sum with the float32 batch term is
    float32."""
    shape = (1, -1, 1, 1)
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = (x32 - mean.view(shape)).square().mean(dim=(0, 2, 3))
    with torch.no_grad():
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var * (n / max(n - 1, 1))
        keep = torch.tensor(1 - momentum, dtype=bn.running_mean.dtype)
        new = (bn.running_mean * keep + momentum * mean,
               bn.running_var * keep + momentum * unbiased)
    y = (x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
    y = y * bn.weight.float().view(shape) + bn.bias.float().view(shape)
    return y.to(x.dtype), new
