"""Normalization (port of genconvit_tpu/ops/norm.py:16-66).

LayerNorm over the trailing axis with float32 two-pass statistics, and
eval-mode BatchNorm (running statistics, eps 1e-5) over NCHW channels.
"""

from __future__ import annotations

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
