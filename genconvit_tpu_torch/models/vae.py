"""GenConViT VAE branch, original variant (port of
genconvit_tpu/models/vae.py:181-239, 359-389).

Encoder 4x [conv3x3 s2 p1 -> BN -> LeakyReLU] (3->16->32->64->128), CHW
flatten, mu head (25088 -> 12544 at 224 px). Quirk B4 of the reference is
kept: z = mu + eps * exp(0.5 * mu), sampling in eval too unless
sample=False. The var head only feeds the training KL term, so scoring
never computes it; it is kept for the checkpoint. Decoder: unflatten to
(256, s, s), 4x [convT2x2 s2 -> LeakyReLU] to 3 channels at half size. The
backbone runs on x and on the reconstruction in two calls (their sizes
differ), then ReLU -> fc -> ReLU -> fc2. Keys: encoder.features.{0,3,6,9}
(conv) / {1,4,7,10} (BN), encoder.mu/var, decoder.features.{0,2,4,6},
convnext_backbone.*, fc, fc2 (ref model/genconvit_vae.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.models.convnext import DEFAULT_PLAN, ConvNeXt
from genconvit_tpu_torch.ops.act import leaky_relu, relu
from genconvit_tpu_torch.ops.conv import conv2d, conv_transpose2d
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.ops.norm import batch_norm
from genconvit_tpu_torch.ops.resize import resize_bilinear_torch

_ENC_CH = (3, 16, 32, 64, 128)
_DEC_CH = (256, 64, 32, 16, 3)


class Encoder(nn.Module):
    def __init__(self, flat: int, latent: int):
        super().__init__()
        layers = []
        for i in range(4):
            layers += [nn.Conv2d(_ENC_CH[i], _ENC_CH[i + 1], 3, 2, 1),
                       nn.BatchNorm2d(_ENC_CH[i + 1]), nn.LeakyReLU()]
        self.features = nn.Sequential(*layers)
        self.mu = nn.Linear(flat, latent)
        self.var = nn.Linear(flat, latent)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N,3,H,W] -> mu [N, latent]."""
        for i in range(4):
            conv, bn = self.features[3 * i], self.features[3 * i + 1]
            x = leaky_relu(batch_norm(conv2d(x, conv.weight, conv.bias,
                                             stride=2, padding=1), bn))
        # torch flattens in CHW order; flatten(1) of the channels_last
        # tensor gathers exactly that order
        return F.linear(x.flatten(1), self.mu.weight, self.mu.bias)


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        for i in range(4):
            layers += [nn.ConvTranspose2d(_DEC_CH[i], _DEC_CH[i + 1], 2, 2),
                       nn.LeakyReLU()]
        self.features = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [N, 256*s*s] -> [N,3,16s,16s]."""
        n, latent = z.shape
        s = int(round((latent / 256) ** 0.5))
        x = z.reshape(n, 256, s, s)
        for i in range(4):
            convt = self.features[2 * i]
            x = leaky_relu(conv_transpose2d(x, convt.weight, convt.bias, stride=2))
        return x


class GenConViTVAE(nn.Module):
    def __init__(self, backbone: str = "convnext_tiny", img_size: int = 224,
                 latent_dims: Optional[int] = None, num_classes: int = 2,
                 backbone_classes: int = 1000):
        super().__init__()
        flat = 128 * (img_size // 16) ** 2
        if latent_dims is None:
            latent_dims = 256 * (img_size // 32) ** 2
        self.encoder = Encoder(flat, latent_dims)
        self.decoder = Decoder()
        self.convnext_backbone = ConvNeXt.from_name(backbone, backbone_classes)
        num_features = 2 * backbone_classes
        self.fc = nn.Linear(num_features, num_features // 4)
        self.fc2 = nn.Linear(num_features // 4, num_classes)

    def encode(self, x: torch.Tensor, *, sample: bool = True,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z with quirk B4. eps is drawn from `generator` unless given."""
        mu = self.encoder(x)
        if not sample:
            return mu
        if eps is None:
            if generator is None:
                raise ValueError("encode(sample=True) needs a generator or eps")
            eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                              dtype=torch.float32).to(mu.dtype)
        return eps.to(mu.device, mu.dtype) * torch.exp(0.5 * mu) + mu

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN, *,
                sample: bool = True, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None, return_recon: bool = False):
        """x: [N,3,H,W] normalized -> logits [N, num_classes], and with
        return_recon the reconstruction resized to H x W (torchvision
        bilinear, antialias), which scoring never reads."""
        z = self.encode(x, sample=sample, generator=generator, eps=eps)
        x_hat = self.decoder(z).contiguous(memory_format=torch.channels_last)
        x1 = self.convnext_backbone(x, plan)
        x2 = self.convnext_backbone(x_hat, plan)
        h = relu(torch.cat([x1, x2], dim=1))
        h = relu(F.linear(h, self.fc.weight, self.fc.bias))
        logits = F.linear(h, self.fc2.weight, self.fc2.bias)
        if return_recon:
            return logits, resize_bilinear_torch(x_hat, (x.shape[2], x.shape[3]))
        return logits
