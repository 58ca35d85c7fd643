"""The device the port's entry points run on: the card, unless the caller
passes device="cpu"."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The GPU; without one this raises (pass device="cpu" to run there)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the Predictor runs on the GPU unless "
                           "device='cpu' is passed")
    return torch.device("cuda")
