"""GenConViT ED branch (port of genconvit_tpu/models/ed.py:62-104).

Encoder 5x [conv3x3 s1 p1 -> ReLU -> maxpool2] (3->16->32->64->128->256),
decoder 5x [convT2x2 s2 -> ReLU] back to 3 channels; the backbone runs on
cat([reconstruction, original]) as one 2N batch, then GELU -> fc -> GELU ->
fc2. Keys: encoder.features.{0,3,6,9,12}, decoder.features.{0,2,4,6,8},
backbone.*, fc, fc2 (ref model/genconvit_ed.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.models.convnext import DEFAULT_PLAN, ConvNeXt
from genconvit_tpu_torch.ops.act import gelu, relu
from genconvit_tpu_torch.ops.conv import conv2d, conv_transpose2d
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

_ENC_CH = (3, 16, 32, 64, 128, 256)
_DEC_CH = (256, 128, 64, 32, 16, 3)


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        for i in range(5):
            layers += [nn.Conv2d(_ENC_CH[i], _ENC_CH[i + 1], 3, 1, 1),
                       nn.ReLU(), nn.MaxPool2d(2, 2)]
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            conv = self.features[3 * i]
            x = F.max_pool2d(relu(conv2d(x, conv.weight, conv.bias, padding=1)), 2, 2)
        return x


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        for i in range(5):
            layers += [nn.ConvTranspose2d(_DEC_CH[i], _DEC_CH[i + 1], 2, 2), nn.ReLU()]
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            convt = self.features[2 * i]
            x = relu(conv_transpose2d(x, convt.weight, convt.bias, stride=2))
        return x


class GenConViTED(nn.Module):
    def __init__(self, backbone: str = "convnext_tiny", num_classes: int = 2,
                 backbone_classes: int = 1000):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.backbone = ConvNeXt.from_name(backbone, backbone_classes)
        num_features = 2 * backbone_classes
        self.fc = nn.Linear(num_features, num_features // 4)
        self.fc2 = nn.Linear(num_features // 4, num_classes)

    def forward(self, images: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN,
                per_call_folds: bool = False) -> torch.Tensor:
        """images: [N,3,H,W] normalized -> logits [N, num_classes].
        per_call_folds: the backbone's kernel paths fold per call and are
        differentiable (training)."""
        dec = self.decoder(self.encoder(images))
        both = torch.cat([dec, images], dim=0).contiguous(
            memory_format=torch.channels_last)
        feats = self.backbone(both, plan, per_call_folds)
        n = images.shape[0]
        x = gelu(torch.cat([feats[:n], feats[n:]], dim=1), plan.gelu)
        x = gelu(F.linear(x, self.fc.weight, self.fc.bias), plan.gelu)
        return F.linear(x, self.fc2.weight, self.fc2.bias)
