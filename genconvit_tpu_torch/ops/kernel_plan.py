"""Kernel plan: which compute-path variants the port runs (the subset of
genconvit_tpu/ops/kernel_plan.py:36-130 the scoring path reads).

  gelu        'default' (deg-3/2 rational) | 'hp' (deg-5/4) | 'exact' (erf)
  pallas      ''      the kernel backbone on a CUDA bfloat16 backbone: K2
                      for the stem LN, K1 (or K4) for every block tail
              'mlpfull' the same as '' (the JAX package forces its
                      whole-backbone kernel with it, which on one device
                      is its default)
              'mlp'   per stage: the depthwise conv, then K1 (or K4) for
              'mlp:<i,j,...>' every block tail of the stages chosen (0-3,
                      all of them for bare 'mlp'), with no LayerNorm fused
                      into K1; plain stem and downsample LNs (no K2), the
                      plain bf16 block in the other stages
              '0'     the plain PyTorch graph everywhere
              '1'     the fused-block backbone: K5 (a whole block in one
                      kernel) on every block with H >= 28 and H % 14 == 0,
                      the plain bf16 block elsewhere, plain LayerNorms
              'stage' the fused-stage backbone: K6 (a stage's chain of
                      blocks in one kernel) on every stage with H >= 7 and
                      C % 128 == 0, the plain bf16 block elsewhere, plain
                      LayerNorms
              '1' and 'stage' run their kernels with the hp GELU whatever
              `gelu` says, as the JAX package's A/B paths do; '', 'mlpfull'
              and 'mlp...' run the plain graph with gelu 'exact'.
              Swin (models/swin.py): K7 (`window_attention`) runs the
              attention of every block of a CUDA bfloat16 Swin unless
              pallas is '0', for every other value alike, as the JAX
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
  dw_rank     0       the exact 7x7 depthwise conv (default)
              R > 0   the Predictor replaces each block's depthwise 7x7 by
                      R SVD-separable 1x7 + 7x1 passes (ops/dwsep.py): an
                      approximation, for inference only
              'auto:<energy>[:<max_rank>]' per block, the smallest rank
                      whose worst channel keeps <energy> of its SVD energy;
                      blocks needing more than <max_rank> (3) stay exact
              The Predictor refuses it with pallas '1' and 'stage', whose
              kernels convolve the exact weights.

The names and the environment variables are the JAX package's, so one
setting selects the same path in both. `from_env()` is the one place the
environment is read; the Predictor calls it once at construction. It
layers them as the JAX package does (genconvit_tpu/ops/kernel_plan.py:97-140):
defaults, then a plan file named by GENCONVIT_KERNEL_PLAN, then each
variable that is set.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, FrozenSet, Optional, Union

from genconvit_tpu_torch.ops.act import GELU_TIERS
from genconvit_tpu_torch.ops.dwsep import parse_rank_spec

_PALLAS_MODES = ("", "0", "1", "stage", "mlpfull")
_MLP_STAGES = re.compile(r"mlp(:[0-3](,[0-3])*)?$")   # 'mlp' or 'mlp:<i,j,...>
INT8_MLP_MODES = ("", "fc1", "full")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    pallas: str = ""
    gelu: str = "default"
    int8_mlp: str = ""
    int8_heads: bool = False
    dw_rank: Union[int, str] = 0

    def __post_init__(self):
        if self.gelu not in GELU_TIERS:
            raise ValueError(f"gelu must be one of {GELU_TIERS}, got {self.gelu!r}")
        if self.pallas not in _PALLAS_MODES and not _MLP_STAGES.match(self.pallas):
            raise ValueError(
                f"pallas must be one of {_PALLAS_MODES}, 'mlp' or 'mlp:<i,j,...>' (stages "
                f"0-3) in the port, got {self.pallas!r}")
        if self.int8_mlp not in INT8_MLP_MODES:
            raise ValueError(
                f"int8_mlp must be one of {INT8_MLP_MODES}, got {self.int8_mlp!r}")
        if not isinstance(self.int8_heads, bool):
            raise ValueError(f"int8_heads must be a bool, got {self.int8_heads!r}")
        if isinstance(self.dw_rank, bool) or parse_rank_spec(self.dw_rank)[2] < 0:
            raise ValueError(f"dw_rank must be a rank >= 0 or 'auto:<energy>[:<max_rank>]', "
                             f"got {self.dw_rank!r}")

    @property
    def dw_sep(self) -> bool:
        """Whether dw_rank asks for the separable approximation (a rank
        above 0, or an auto spec)."""
        return parse_rank_spec(self.dw_rank) != ("fixed", 0.0, 0)

    def mlp_stages(self) -> Optional[FrozenSet[int]]:
        """The stages the per-stage kernel path runs for pallas 'mlp' or
        'mlp:<i,j,...>' (all four for bare 'mlp'), None for any other
        value: the JAX package's selection (convnext.py:445-450)."""
        if not self.pallas.startswith("mlp") or self.pallas == "mlpfull":
            return None
        sel = self.pallas.partition(":")[2]
        return frozenset(range(4)) if not sel else frozenset(int(i) for i in sel.split(","))

    @staticmethod
    def from_env() -> "KernelPlan":
        """The plan the environment selects, layered as the JAX package's
        KernelPlan.from_env (most specific wins):

          1. defaults;
          2. the plan file named by GENCONVIT_KERNEL_PLAN (`read_plan_file`);
          3. each variable that is set, and only those, so that an unset
             variable never masks a field of the file:
             GENCONVIT_EXACT_GELU=1 -> gelu 'exact', GENCONVIT_GELU=hp ->
             'hp'; GENCONVIT_PALLAS -> pallas; GENCONVIT_INT8_MLP ->
             int8_mlp ('0' and '' mean off, '1' means 'full');
             GENCONVIT_DW_RANK -> dw_rank ('' means 0; 'auto...' kept as
             a string, anything else an int), validated at construction.

        GENCONVIT_INT8_HEADS=1 -> int8_heads, as before: it is not a field
        of the JAX plan. The JAX package's per-chip asset layer
        (default_plan_asset, GENCONVIT_KERNEL_PLAN_ASSET) is left out: the
        one asset that ships, kernel_plan.TPU_v5_lite.json, is for that TPU
        alone, and no plan asset exists for this card."""
        env = os.environ
        fields: Dict[str, Any] = {}
        if env.get("GENCONVIT_KERNEL_PLAN", ""):
            fields = read_plan_file(env["GENCONVIT_KERNEL_PLAN"])
        if env.get("GENCONVIT_EXACT_GELU", "0") == "1":
            fields["gelu"] = "exact"
        elif env.get("GENCONVIT_GELU", "") == "hp":
            fields["gelu"] = "hp"
        if "GENCONVIT_PALLAS" in env:
            fields["pallas"] = env["GENCONVIT_PALLAS"]
        if "GENCONVIT_INT8_MLP" in env:
            raw = env["GENCONVIT_INT8_MLP"]
            fields["int8_mlp"] = {"0": "", "": "", "1": "full"}.get(raw, raw)
        if "GENCONVIT_DW_RANK" in env:
            raw = env["GENCONVIT_DW_RANK"] or "0"
            fields["dw_rank"] = raw if raw.startswith("auto") else int(raw)
        return KernelPlan(int8_heads=env.get("GENCONVIT_INT8_HEADS") == "1", **fields)


def read_plan_file(path: str) -> Dict[str, Any]:
    """The fields of a plan file, read as the JAX package's KernelPlan.load
    reads it (kernel_plan.py:132-140): pallas, gelu, int8_mlp and dw_rank;
    mlp_panel_mb and mlp_split (TPU layout that computes the same
    function), `_meta` and unknown keys are ignored."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"plan file {path}: expected a JSON object")
    return {k: data[k] for k in ("pallas", "gelu", "int8_mlp", "dw_rank") if k in data}
