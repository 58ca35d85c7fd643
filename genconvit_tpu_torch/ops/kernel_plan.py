"""Kernel plan: which compute-path variants the port runs (the subset of
genconvit_tpu/ops/kernel_plan.py:36-130 the scoring path reads).

  gelu    'default' (deg-3/2 rational) | 'hp' (deg-5/4) | 'exact' (erf)
  pallas  ''  the hand-written CUDA kernels on a CUDA bfloat16 backbone
          '0' the plain PyTorch graph everywhere

The name `pallas` and the environment variables are the JAX package's, so
one setting selects the same path in both. `from_env()` is the one place
the environment is read; the Predictor calls it once at construction.
"""

from __future__ import annotations

import dataclasses
import os

from genconvit_tpu_torch.ops.act import GELU_TIERS

_PALLAS_MODES = ("", "0")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    pallas: str = ""
    gelu: str = "default"

    def __post_init__(self):
        if self.gelu not in GELU_TIERS:
            raise ValueError(f"gelu must be one of {GELU_TIERS}, got {self.gelu!r}")
        if self.pallas not in _PALLAS_MODES:
            raise ValueError(
                f"pallas must be one of {_PALLAS_MODES} in the port, got "
                f"{self.pallas!r}")

    @staticmethod
    def from_env() -> "KernelPlan":
        """GENCONVIT_EXACT_GELU=1 -> gelu 'exact'; GENCONVIT_GELU=hp -> 'hp';
        GENCONVIT_PALLAS -> pallas."""
        gelu = "default"
        if os.environ.get("GENCONVIT_EXACT_GELU", "0") == "1":
            gelu = "exact"
        elif os.environ.get("GENCONVIT_GELU", "") == "hp":
            gelu = "hp"
        return KernelPlan(pallas=os.environ.get("GENCONVIT_PALLAS", ""),
                          gelu=gelu)
