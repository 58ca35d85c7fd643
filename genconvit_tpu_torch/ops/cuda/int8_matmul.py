"""K3: the weight-only int8 matmul of the VAE latent head as a hand-written
CUDA kernel (csrc/int8_matmul.cu), with its plain PyTorch version.

  matmul_wint8  replaces matmul_wint8 (_kernel) of
                genconvit_tpu/ops/pallas/int8_matmul.py

out = (bf16(x) . bf16(wq)^T, summed in float32) * scale + bias, in x's
dtype. wq is int8 in the torch Linear layout [N, K] with per-output scales
(ops/quant.quantize_wint8 over dim 1). On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises. It
counts its launches in `matmul_wint8.launches`.
"""

from __future__ import annotations

import torch

from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import _require, _stream


def matmul_wint8_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """K3's math in plain PyTorch: x rounded to bf16 whatever its dtype,
    float32 products of bf16 and int8 values (exact), a float32 sum."""
    xb = x.to(torch.bfloat16).float()
    z = xb @ wq.float().t()
    return (z * scale.float() + bias.float()).to(x.dtype)


def matmul_wint8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """K3: x [M, K] (bf16 or f32), wq [N, K] int8, scale and bias [N] f32
    -> [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return matmul_wint8_plain(x, wq, scale, bias)
    what = "matmul_wint8"
    _require(x.is_cuda, what, f"unsupported device {x.device}")
    _require(x.dim() == 2 and wq.dim() == 2, what, "x and wq must be 2-D")
    _require(x.dtype in (torch.bfloat16, torch.float32), what,
             f"x must be bfloat16 or float32, got {x.dtype}")
    m, k = x.shape
    n = wq.shape[0]
    _require(wq.shape[1] == k, what, f"wq {tuple(wq.shape)} does not take K={k}")
    _require(wq.dtype == torch.int8, what, f"wq must be int8, got {wq.dtype}")
    for name, t, shape in (("wq", wq, (n, k)), ("scale", scale, (n,)), ("bias", bias, (n,))):
        _require(t.device == x.device, what, f"{name} on another device than x")
        _require(tuple(t.shape) == shape, what, f"{name} shape {tuple(t.shape)} != {shape}")
        _require(t.is_contiguous(), what, f"{name} must be contiguous")
    _require(scale.dtype == torch.float32 and bias.dtype == torch.float32, what,
             "scale and bias must be float32")
    _require(x.is_contiguous(), what, "x must be contiguous")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        splits = lib.gcv_wint8_splits(m, k, n)
        # x in the kernel's k order, bf16, zero-padded to its row tile and 64-k blocks
        xp = torch.empty((lib.gcv_wint8_x_rows(m), -(-k // 64) * 64), dtype=torch.bfloat16,
                         device=x.device)
        work = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        f32 = int(x.dtype == torch.float32)
        err = lib.gcv_matmul_wint8(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                                   bias.data_ptr(), xp.data_ptr(), work.data_ptr(),
                                   out.data_ptr(), m, k, n, f32, f32, _stream(x.device))
    _build.check(err, what)
    matmul_wint8.launches += 1
    return out


matmul_wint8.launches = 0
