"""GenConViT ensemble (port of genconvit_tpu/models/genconvit.py:74-101).

net='ed' -> ED logits; 'vae' -> VAE logits; 'genconvit' -> both,
concatenated on the batch axis with the ED rows first (ref
model/genconvit.py:71-74), so the per-frame sigmoid mean downstream is
also the ensemble average. With train=True the forward returns (logits,
aux) as genconvit_apply(train=True) does: aux holds the VAE branch's
reconstruction, KL term, mu, logvar and BatchNorm statistics under 'vae_*'.

The VAE branch is the variant config.model.vae_variant names (models/vae.py,
genconvit_tpu/models/genconvit.py:43-70); `head_act` picks each branch's
classifier head ('default' or 'swiglu'; a dict gives one per branch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

from genconvit_tpu_torch.config import Config
from genconvit_tpu_torch.core.convert import branch_spec
from genconvit_tpu_torch.models.convnext import DEFAULT_PLAN, ConvNeXt
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.vae import GenConViTVAE
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

VALID_NETS = ("ed", "vae", "genconvit")


def model_spec(config: Config, state_dicts: Mapping[str, Mapping[str, Any]]
               ) -> Tuple[Config, Dict[str, str]]:
    """What GenConViT the branches' state dicts need, as the JAX package
    dispatches on its trees (`branch_spec`): the config with the VAE
    variant they hold (the config's own without VAE weights; the config is
    not modified) and each branch's head."""
    variant, heads = config.model.vae_variant, {}
    for name, sd in state_dicts.items():
        spec = branch_spec(sd, name)
        heads[name] = spec["head_act"]
        variant = spec.get("variant", variant)
    if variant != config.model.vae_variant:
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model, vae_variant=variant))
    return config, heads


class GenConViT(nn.Module):
    def __init__(self, config: Optional[Config] = None, net: str = "genconvit",
                 backbone_classes: int = 1000,
                 head_act: Union[str, Mapping[str, str]] = "default"):
        super().__init__()
        if net not in VALID_NETS:
            raise ValueError(f"net must be one of {VALID_NETS}, got {net!r}")
        config = config or Config()
        self.net = net
        bb = config.model.backbone
        heads = dict.fromkeys(("ed", "vae"), head_act) if isinstance(head_act, str) else head_act
        if net in ("ed", "genconvit"):
            self.ed = GenConViTED(bb, config.num_classes, backbone_classes,
                                  heads.get("ed", "default"))
        if net in ("vae", "genconvit"):
            self.vae = GenConViTVAE(bb, config.img_size,
                                    config.vae_latent_dims(),
                                    config.num_classes, backbone_classes,
                                    heads.get("vae", "default"), config.model.vae_variant)

    def branches(self) -> List[nn.Module]:
        return [getattr(self, b) for b in ("ed", "vae") if hasattr(self, b)]

    def backbones(self) -> List[ConvNeXt]:
        return [m for m in self.modules() if isinstance(m, ConvNeXt)]

    def prepare_kernels(self, plan: KernelPlan = DEFAULT_PLAN) -> None:
        for bb in self.backbones():
            bb.prepare_kernels(plan)

    def quantize_heads_int8_(self) -> None:
        """int8 latent heads for the VAE branch (a no-op without one)."""
        if hasattr(self, "vae"):
            self.vae.encoder.quantize_heads_int8_()

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN, *,
                sample: bool = True, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None, train: bool = False,
                return_aux: bool = False):
        """x: [N,3,H,W] normalized -> [N,2] ('ed'/'vae') or [2N,2]; with
        train or return_aux, (logits, aux). train: batch statistics in the
        VAE's BatchNorms and the backbones' differentiable kernel paths;
        return_aux alone (an eval step during training): running statistics,
        kernels folded per call, aux with 'vae_recon'."""
        out = []
        aux: Dict[str, Any] = {}
        fresh = train or return_aux
        if hasattr(self, "ed"):
            out.append(self.ed(x, plan, fresh))
        if hasattr(self, "vae"):
            if fresh:
                logits, vaux = self.vae(x, plan, sample=sample, generator=generator, eps=eps,
                                        return_recon=True, train=train, per_call_folds=True)
                aux.update({f"vae_{k}": v for k, v in vaux.items()} if train
                           else {"vae_recon": vaux})
            else:
                logits = self.vae(x, plan, sample=sample, generator=generator, eps=eps)
            out.append(logits)
        logits = torch.cat(out, dim=0) if len(out) > 1 else out[0]
        return (logits, aux) if fresh else logits
