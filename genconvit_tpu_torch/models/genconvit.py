"""GenConViT ensemble (port of genconvit_tpu/models/genconvit.py:74-101).

net='ed' -> ED logits; 'vae' -> VAE logits; 'genconvit' -> both,
concatenated on the batch axis with the ED rows first (ref
model/genconvit.py:71-74), so the per-frame sigmoid mean downstream is
also the ensemble average.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from genconvit_tpu_torch.config import Config
from genconvit_tpu_torch.models.convnext import DEFAULT_PLAN, ConvNeXt
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.vae import GenConViTVAE
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

VALID_NETS = ("ed", "vae", "genconvit")


class GenConViT(nn.Module):
    def __init__(self, config: Optional[Config] = None, net: str = "genconvit",
                 backbone_classes: int = 1000):
        super().__init__()
        if net not in VALID_NETS:
            raise ValueError(f"net must be one of {VALID_NETS}, got {net!r}")
        config = config or Config()
        self.net = net
        bb = config.model.backbone
        if net in ("ed", "genconvit"):
            self.ed = GenConViTED(bb, config.num_classes, backbone_classes)
        if net in ("vae", "genconvit"):
            self.vae = GenConViTVAE(bb, config.img_size,
                                    config.vae_latent_dims(),
                                    config.num_classes, backbone_classes)

    def branches(self) -> List[nn.Module]:
        return [getattr(self, b) for b in ("ed", "vae") if hasattr(self, b)]

    def backbones(self) -> List[ConvNeXt]:
        return [m for m in self.modules() if isinstance(m, ConvNeXt)]

    def prepare_kernels(self) -> None:
        for bb in self.backbones():
            bb.prepare_kernels()

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN, *,
                sample: bool = True, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [N,3,H,W] normalized -> [N,2] ('ed'/'vae') or [2N,2]."""
        out = []
        if hasattr(self, "ed"):
            out.append(self.ed(x, plan))
        if hasattr(self, "vae"):
            out.append(self.vae(x, plan, sample=sample, generator=generator,
                                eps=eps))
        return torch.cat(out, dim=0) if len(out) > 1 else out[0]
