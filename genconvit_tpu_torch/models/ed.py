"""GenConViT ED branch (port of genconvit_tpu/models/ed.py:62-104).

Encoder 5x [conv3x3 s1 p1 -> ReLU -> maxpool2] (3->16->32->64->128->256),
decoder 5x [convT2x2 s2 -> ReLU] back to 3 channels; the backbone runs on
cat([reconstruction, original]) as one 2N batch, then GELU -> fc -> GELU ->
fc2. Keys: encoder.features.{0,3,6,9,12}, decoder.features.{0,2,4,6,8},
backbone.*, fc, fc2 (ref model/genconvit_ed.py).

head_act='swiglu' is the JAX package's research head (models/ed.py:28-58,
95-100; the reference documents it but never wires it): fc emits 2F -> F/2
gate pairs and `swiglu` takes them back to fc2's input width F/4 in place
of the second GELU. The JAX package picks it by fc's width, as
core/convert.branch_spec does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.models.convnext import DEFAULT_PLAN, ConvNeXt
from genconvit_tpu_torch.ops.act import gelu, relu, swiglu
from genconvit_tpu_torch.ops.conv import conv2d, conv_transpose2d
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

_ENC_CH = (3, 16, 32, 64, 128, 256)
_DEC_CH = (256, 128, 64, 32, 16, 3)
HEAD_ACTS = ("default", "swiglu")


def head_linears(head_act: str, num_features: int, num_classes: int):
    """(fc, fc2) of a branch's classifier: fc 2F -> F/4, or 2F -> F/2 for
    the SwiGLU head, whose gate halves it back for fc2."""
    if head_act not in HEAD_ACTS:
        raise ValueError(f"head_act must be one of {HEAD_ACTS}, got {head_act!r}")
    hidden = num_features // 4
    return (nn.Linear(num_features, 2 * hidden if head_act == "swiglu" else hidden),
            nn.Linear(hidden, num_classes))



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
                 backbone_classes: int = 1000, head_act: str = "default"):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.backbone = ConvNeXt.from_name(backbone, backbone_classes)
        self.head_act = head_act
        self.fc, self.fc2 = head_linears(head_act, 2 * backbone_classes, num_classes)

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
        x = F.linear(x, self.fc.weight, self.fc.bias)
        x = swiglu(x) if self.head_act == "swiglu" else gelu(x, plan.gelu)
        return F.linear(x, self.fc2.weight, self.fc2.bias)
