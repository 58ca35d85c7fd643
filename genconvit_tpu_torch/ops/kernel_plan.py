"""Kernel plan: which compute-path variants the port runs (the subset of
genconvit_tpu/ops/kernel_plan.py:36-130 the scoring path reads).

  gelu        'default' (deg-3/2 rational) | 'hp' (deg-5/4) | 'exact' (erf)
  pallas      ''      the kernel backbone on a CUDA bfloat16 backbone: K2
                      for the stem LN, K1 (or K4) for every block tail
              '0'     the plain PyTorch graph everywhere
              '1'     the fused-block backbone: K5 (a whole block in one
                      kernel) on every block with H >= 28 and H % 14 == 0,
                      the plain bf16 block elsewhere, plain LayerNorms
              'stage' the fused-stage backbone: K6 (a stage's chain of
                      blocks in one kernel) on every stage with H >= 7 and
                      C % 128 == 0, the plain bf16 block elsewhere, plain
                      LayerNorms
              '1' and 'stage' run their kernels with the hp GELU whatever
              `gelu` says, as the JAX package's A/B paths do.
              Swin (models/swin.py): K7 (`window_attention`) runs the
              attention of every block of a CUDA bfloat16 Swin unless
              pallas is '0', for '', '1' and 'stage' alike, as the JAX
              package enables its Pallas kernel on the TPU for every value
              but '0' (genconvit_tpu/ops/pallas/__init__.py:17-29);
              float32, and every CPU tensor, run the JAX package's XLA
              attention graph (swin.py:170-179), as the ConvNeXt kernels
              leave float32 and the CPU to the plain graph.
  int8_mlp    ''     the block tails in bf16 (K1)
              'fc1'  int8 fc1 with a fixed activation scale, bf16 fc2 (K4)
              'full' W8A8: both MLP matmuls int8, per-row activation
                     scales (K4)
              Only the kernel backbone reads it; the plain graph ignores it.
  int8_heads  weight-only int8 VAE latent heads (K3), in every dtype

The names and the environment variables are the JAX package's, so one
setting selects the same path in both. `from_env()` is the one place the
environment is read; the Predictor calls it once at construction.
"""

from __future__ import annotations

import dataclasses
import os

from genconvit_tpu_torch.ops.act import GELU_TIERS

_PALLAS_MODES = ("", "0", "1", "stage")
INT8_MLP_MODES = ("", "fc1", "full")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    pallas: str = ""
    gelu: str = "default"
    int8_mlp: str = ""
    int8_heads: bool = False

    def __post_init__(self):
        if self.gelu not in GELU_TIERS:
            raise ValueError(f"gelu must be one of {GELU_TIERS}, got {self.gelu!r}")
        if self.pallas not in _PALLAS_MODES:
            raise ValueError(
                f"pallas must be one of {_PALLAS_MODES} in the port, got "
                f"{self.pallas!r}")
        if self.int8_mlp not in INT8_MLP_MODES:
            raise ValueError(
                f"int8_mlp must be one of {INT8_MLP_MODES}, got {self.int8_mlp!r}")
        if not isinstance(self.int8_heads, bool):
            raise ValueError(f"int8_heads must be a bool, got {self.int8_heads!r}")

    @staticmethod
    def from_env() -> "KernelPlan":
        """GENCONVIT_EXACT_GELU=1 -> gelu 'exact'; GENCONVIT_GELU=hp -> 'hp';
        GENCONVIT_PALLAS -> pallas; GENCONVIT_INT8_MLP -> int8_mlp ('0' and
        '' mean off, '1' means 'full'); GENCONVIT_INT8_HEADS=1 -> int8_heads."""
        gelu = "default"
        if os.environ.get("GENCONVIT_EXACT_GELU", "0") == "1":
            gelu = "exact"
        elif os.environ.get("GENCONVIT_GELU", "") == "hp":
            gelu = "hp"
        raw = os.environ.get("GENCONVIT_INT8_MLP", "")
        return KernelPlan(pallas=os.environ.get("GENCONVIT_PALLAS", ""),
                          gelu=gelu,
                          int8_mlp={"0": "", "": "", "1": "full"}.get(raw, raw),
                          int8_heads=os.environ.get("GENCONVIT_INT8_HEADS") == "1")
