"""Device kernels grouped by the layer that launches them (a copy of
chip_smoke.py's `convnext_group` and `train_group`)."""

from __future__ import annotations


def convnext_group(key: str) -> str:
    """The scoring path's kernel groups."""
    k = key.lower()
    if "fused_wgmma" in k:   # one kernel template, K5's GELU form or K6's
        return "K5 fused_block" if "geluhp<0>" in k else "K6 fused_stage"
    if "ln_mlp_residual_int8" in k:
        return "K4 ln_mlp_residual_int8"
    if "wint8" in k:
        return "K3 matmul_wint8"
    if "ln_mlp_residual" in k:
        return "K1 ln_mlp_residual"
    if "layer_norm_rows" in k:
        return "K2 layer_norm_rows"
    if ("gemm" in k or "nvjet" in k) and "conv" not in k:
        return "GEMM (latent head, heads)"
    if "conv2d_c1_k1" in k:
        return "depthwise 7x7 (cuDNN)"
    if any(s in k for s in ("conv", "xmma", "implicit", "cudnn", "fprop", "cutlass")):
        return "other convolutions (cuDNN)"
    if "memcpy" in k or "memset" in k:
        return "copies and memsets"
    return "elementwise and other"


def train_group(key: str) -> str:
    """A training step's groups: the scoring path's, with Adam's kernels and
    the GEMMs of the plain graph's backward named."""
    k = key.lower()
    if "multi_tensor_apply" in k or "foreach" in k:
        return "Adam (foreach kernels)"
    name = convnext_group(key)
    if name.startswith("GEMM"):
        return "GEMMs (the plain graph's fc1/fc2 forward and backward, heads)"
    return name


def is_k1(name: str) -> bool:
    k = name.lower()
    return "ln_mlp_residual" in k and "int8" not in k
