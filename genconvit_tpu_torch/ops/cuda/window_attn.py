"""K7: Swin's windowed multi-head attention as a hand-written CUDA kernel
(csrc/window_attn.cu), with its plain PyTorch version.

  window_attention  replaces window_attention_pallas (_attn_kernel,
                    _attn_kernel_nomask) of genconvit_tpu/ops/pallas/window_attn.py

It takes the qkv linear's output, qkv [B, L, 3C] laid out [B, L, 3, heads,
hd], and returns [B, L, C] laid out [B, L, heads, hd], the proj linear's
input: the JAX package's kernel with the reshapes around it
(genconvit_tpu/models/swin.py:146-148, 160-167). Window-head g = b * heads +
h (head fastest) computes, at the Pallas kernel's rounding points
(window_attn.py:31-45),

  s = (q * hd^-1/2) . k^T + bias[h] (+ mask[b % windows_per_mask])   float32
  p = bf16(exp(s - max s) / sum exp(s - max s))     (in qkv's dtype)
  out = dtype(p . v, summed in float32)

with bias [heads, L, L] and mask [nW, L, L] in float32. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises. It counts its launches in `window_attention.launches`, those with a
mask also in `window_attention.masked_launches`. `planted_outputs` makes what
a kernel with one fault would return, for the checks that must refuse it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import _check_vec, _require, _stream

MAX_L = 64               # tokens per window the kernel pads to
HEAD_DIMS = (16, 32, 64)
# Kernel vs plain, elementwise, in bf16 ulps of the largest |out| of the same
# window-head (`ulp_error`). Both round at the same points; they differ by
# float32 noise (the kernel scales the scores after q . k, sums in another
# order, takes its own expf), which can flip the bf16 rounding of a p or of an
# output. A flip of p[r, k] moves out[r, :] by at most an ulp of p times |v[k]|,
# and |v| can be far above |out[r, d]| where p . v cancels, so an element's own
# ulp is no floor: the window-head's max |out| is. One flip of p and one of the
# output: 2 ulps.
ULP_TOL = 2.0


def _heads_view(qkv: torch.Tensor, heads: int):
    """q, k, v [B, heads, L, hd] as views of qkv [B, L, 3C]."""
    b, l, c3 = qkv.shape
    return qkv.view(b, l, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4).unbind(0)


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], heads: int,
                           windows_per_mask: int = 1) -> torch.Tensor:
    """K7's math in plain PyTorch, the Pallas kernel's rounding points."""
    q, k, v = _heads_view(qkv, heads)
    b, _, l, hd = q.shape
    s = (q.float() * hd ** -0.5) @ k.float().transpose(-1, -2)
    s = s + bias.float()
    if mask is not None:
        win = torch.arange(b, device=qkv.device) % windows_per_mask
        s = s + mask.float()[win][:, None]
    s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(-1, keepdim=True)
    o = p.to(qkv.dtype).float() @ v.float()
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, l, heads * hd)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], heads: int,
                     windows_per_mask: int = 1) -> torch.Tensor:
    """K7: qkv [B, L, 3C] bf16, bias [heads, L, L] f32, mask [nW, L, L] f32
    or None (windows_per_mask <= nW of them, window b % windows_per_mask)
    -> [B, L, C] bf16."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, mask, heads, windows_per_mask)
    what = "window_attention"
    _require(qkv.is_cuda, what, f"unsupported device {qkv.device}")
    _require(qkv.dim() == 3, what, f"qkv must be [B, L, 3C], got {tuple(qkv.shape)}")
    b, l, c3 = qkv.shape
    _require(qkv.dtype == torch.bfloat16, what, f"qkv must be bfloat16, got {qkv.dtype}")
    _require(qkv.is_contiguous(), what, "qkv must be contiguous")
    _require(qkv.data_ptr() % 16 == 0, what, "qkv must be 16-byte aligned")
    _require(1 <= l <= MAX_L, what, f"L={l} must be in 1..{MAX_L}")
    _require(heads >= 1 and c3 % (3 * heads) == 0, what,
             f"3C={c3} does not split into 3 x {heads} heads")
    hd = c3 // (3 * heads)
    _require(hd in HEAD_DIMS, what, f"head dim {hd} not in {HEAD_DIMS}")
    _check_vec(what, bias, (heads, l, l), torch.float32, qkv.device)
    nw = 1
    if mask is not None:
        _require(mask.dim() == 3 and 1 <= windows_per_mask <= mask.shape[0], what,
                 f"mask {tuple(mask.shape)} holds fewer than {windows_per_mask} windows")
        _check_vec(what, mask, (mask.shape[0], l, l), torch.float32, qkv.device)
        nw = windows_per_mask
    out = torch.empty((b, l, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        err = lib.gcv_window_attention(qkv.data_ptr(), bias.data_ptr(),
                                       None if mask is None else mask.data_ptr(),
                                       out.data_ptr(), b, l, heads, hd, nw,
                                       ctypes.c_float(hd ** -0.5), _stream(qkv.device))
    _build.check(err, what)
    window_attention.launches += 1
    window_attention.masked_launches += int(mask is not None)
    return out


window_attention.launches = 0
window_attention.masked_launches = 0


def ulp_error(out: torch.Tensor, ref: torch.Tensor, heads: int) -> float:
    """max over elements of |out - ref| in bf16 ulps of the largest |ref| of
    the same window-head (ULP_TOL's note); out and ref [B, L, heads * hd]."""
    b, l, c = ref.shape
    r = ref.float().view(b, l, heads, c // heads)
    _, exp = torch.frexp(r.abs().amax(dim=(1, 3), keepdim=True))
    ulp = torch.ldexp(torch.ones_like(r[:, :1, :, :1]), exp - 8)   # 8 significant bits
    return ((out.float().view_as(r) - r).abs() / ulp).max().item()


def planted_outputs(fn: Callable[..., torch.Tensor], qkv: torch.Tensor, bias: torch.Tensor,
                    mask: Optional[torch.Tensor], heads: int,
                    windows: int) -> Dict[str, torch.Tensor]:
    """What a kernel with one fault returns, computed through fn (the kernel
    or its plain version) on inputs that make a right kernel compute it;
    `windows` is the number of windows per image. The faults: the relative
    bias dropped; the bias taken window-fastest (window-head g reads
    bias[(g // windows) % heads], assembled from launches on head-rolled
    biases; only where windows > 1 and heads > 1, since otherwise the two
    orders agree); the hd^-1/2 scale omitted (q multiplied by hd^1/2, up to
    one bf16 rounding of q); with a mask, the mask dropped and the mask
    index off by one window."""
    b, l, c3 = qkv.shape
    hd = c3 // (3 * heads)
    nw = 1 if mask is None else mask.shape[0]
    faults = {"relative bias dropped": fn(qkv, torch.zeros_like(bias), mask, heads, nw)}
    if windows > 1 and heads > 1:
        g = torch.arange(b * heads, device=qkv.device).view(b, heads)
        roll = ((g // windows) % heads - g % heads) % heads
        res = None
        for r in roll.unique().tolist():
            o = fn(qkv, bias.roll(-r, 0).contiguous(), mask, heads, nw).view(b, l, heads, hd)
            pick = (roll == r)[:, None, :, None]
            res = torch.where(pick, o, o if res is None else res)
        faults["bias window-fastest"] = res.reshape(b, l, heads * hd)
    unscaled = qkv.clone()
    unscaled[..., :c3 // 3] *= hd ** 0.5
    faults["scale omitted"] = fn(unscaled, bias, mask, heads, nw)
    if mask is not None:
        faults["mask dropped"] = fn(qkv, bias, None, heads, 1)
        faults["mask off by one window"] = fn(qkv, bias, mask.roll(1, 0).contiguous(),
                                              heads, nw)
    return faults
