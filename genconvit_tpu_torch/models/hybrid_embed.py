"""HybridEmbed (port of genconvit_tpu/models/hybrid_embed.py).

The reference's `HybridEmbed(swin, ...)` parameter group: a Swin backbone
and a 1x1 conv `proj` from feature_dim channels to embed_dim. The reference
never runs it (its ConvNeXt forward never calls patch_embed); the JAX
package's working research path, `hybrid_embed_tokens`, projects the Swin
token features [N, L, C] through proj as a dense map over channels, which
needs feature_dim == C. The backbone's head has feature_dim classes, as in
the checkpoint layout (1000 in the shipped checkpoints).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.models.swin import DEFAULT_PLAN, SwinTransformer
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan


class HybridEmbed(nn.Module):
    def __init__(self, embedder: Union[str, Dict[str, Any]] = "swin_tiny_patch4_window7_224",
                 embed_dim: int = 768, feature_dim: int = 1000):
        super().__init__()
        self.backbone = SwinTransformer(embedder, num_classes=feature_dim)
        self.proj = nn.Conv2d(feature_dim, embed_dim, 1)

    def tokens(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN) -> torch.Tensor:
        """[N, 3, H, W] -> [N, L, embed_dim] (hybrid_embed.py:42-56)."""
        w = self.proj.weight[:, :, 0, 0]
        if w.shape[1] != self.backbone.width:
            raise ValueError(
                f"hybrid-embed proj expects {w.shape[1]} channels, got "
                f"{self.backbone.width}; build a research-path proj with feature_dim == "
                f"swin token width")
        return F.linear(self.backbone.features(x, plan), w, self.proj.bias)
