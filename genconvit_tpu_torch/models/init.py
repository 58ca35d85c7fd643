"""Random initialization with an explicit torch.Generator, on the device the
module lives on (port of the JAX package's init_* functions).

  * ConvNeXt: timm's init, trunc_normal(std 0.02, cut at +-2 std) for every
    conv and linear weight, zero biases, unit LayerNorms, layer scale 1e-6;
  * ED/VAE convs, transposed convs and linears: torch's default,
    U(+-1/sqrt(fan_in)) for weight and bias (fan_in of a transposed conv is
    Cout*kH*kW, as torch computes it), the updated VAE's decoder_input and
    the SwiGLU heads' fc included (the JAX package's linear_init and
    conv_transpose_init, genconvit_tpu/ops/init.py);
  * the VAE latent heads: the same torch Linear bound, flat ** -0.5;
  * BatchNorm (the VAE encoder's, the updated decoder's): unit scale, zero
    shift, running mean 0 and variance 1;
  * Swin (init_swin, genconvit_tpu/models/swin.py:97-126): torch's default
    bound for the patch conv and every linear (weight and bias), trunc_normal
    (std 0.02) for the relative position bias tables and the bias-free
    patch-merging reductions, unit LayerNorms; the HybridEmbed proj (a 1x1
    conv) at torch's default bound.

Random weights carry no parity contract with the JAX package (the two
generators differ); tests inject weights through core/convert.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from genconvit_tpu_torch.models.convnext import Block, ConvNeXt
from genconvit_tpu_torch.models.hybrid_embed import HybridEmbed
from genconvit_tpu_torch.models.swin import PatchMerging, SwinTransformer, WindowAttention

LS_INIT = 1e-6  # timm ls_init_value


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std^2) truncated at +-2 std, by the inverse CDF."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.empty(t.shape, device=t.device, dtype=torch.float32)
    u.uniform_(lo, hi, generator=generator)
    t.copy_(torch.erfinv(u.mul_(2).sub_(1)).mul_(std * math.sqrt(2)))


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_convnext_(m: ConvNeXt, generator: torch.Generator) -> None:
    for mod in m.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            trunc_normal_(mod.weight, 0.02, generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, Block):
            mod.gamma.fill_(LS_INIT)


@torch.no_grad()
def _torch_default_(mod: nn.Module, generator: torch.Generator) -> None:
    """U(+-1/sqrt(fan_in)) for weight and bias: torch's Linear and Conv2d."""
    bound = mod.weight[0].numel() ** -0.5
    uniform_(mod.weight, bound, generator)
    uniform_(mod.bias, bound, generator)


@torch.no_grad()
def init_swin_(m: SwinTransformer, generator: torch.Generator) -> None:
    for mod in m.modules():
        if isinstance(mod, PatchMerging):
            trunc_normal_(mod.reduction.weight, 0.02, generator)
        elif isinstance(mod, WindowAttention):
            trunc_normal_(mod.relative_position_bias_table, 0.02, generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)) and mod.bias is not None:
            _torch_default_(mod, generator)


@torch.no_grad()
def init_hybrid_embed_(m: HybridEmbed, generator: torch.Generator) -> None:
    init_swin_(m.backbone, generator)
    _torch_default_(m.proj, generator)


@torch.no_grad()
def init_genconvit_(model: nn.Module, generator: torch.Generator) -> None:
    """Initialize every parameter and buffer of a GenConViT (or branch): its
    ConvNeXt or Swin backbones by their own rules."""
    backbones = [m for m in model.modules() if isinstance(m, (ConvNeXt, SwinTransformer))]
    inside = {id(p) for bb in backbones for p in bb.parameters()}
    for bb in backbones:
        (init_swin_ if isinstance(bb, SwinTransformer) else init_convnext_)(bb, generator)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if id(mod.weight) in inside:
                continue
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            bound = fan_in ** -0.5
            uniform_(w, bound, generator)
            uniform_(mod.bias, bound, generator)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
