"""Convolutions on NCHW (channels_last) tensors with torch-layout weights
(port of genconvit_tpu/ops/conv.py:26-130).

Conv2d weights are OIHW, ConvTranspose2d weights (Cin, Cout, kH, kW); the
depthwise 7x7 is `conv2d(groups=C)`, left to cuDNN as the JAX package leaves
it to XLA. The weight and bias are cast to the input's dtype.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: Union[int, tuple] = 0,
           groups: int = 1) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding, groups=groups)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     stride: int = 1) -> torch.Tensor:
    return F.conv_transpose2d(x, w.to(x.dtype),
                              None if b is None else b.to(x.dtype),
                              stride=stride)
