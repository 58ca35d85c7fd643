"""Activations with torch-default semantics (port of genconvit_tpu/ops/act.py).

GELU is the erf form. float32 keeps the exact erf. bfloat16 uses a fitted
rational erf(z) ~ z * P(z^2) / Q(z^2), clamped and pinned to +-1 outside
the fit range, in one of two tiers named by the kernel plan:

  * 'default' (deg 3/2): erf max abs error 6.9e-5;
  * 'hp'      (deg 5/4): erf max abs error 8.7e-7.

'exact' forces the erf form on bfloat16 too. The coefficients are the JAX
package's, copied as they are; the CUDA kernel (csrc/convnext_mlp.cu)
carries the same numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# hp tier: |z| <= 3.625, max abs error 8.7e-7.
_ERF_P = (1.1283791233432234, 0.2571863689937213, 0.057255831726436376,
          0.0057354856364086396, 0.00015586043306483894,
          -1.0666330908322879e-06)
_ERF_Q = (1.0, 0.5612572789010719, 0.13783698081066592,
          0.018689943146010534, 0.0013449923247288303)
_ERF_ZMAX = 3.625
# default tier: |z| <= 3.0, max abs error 6.9e-5.
_ERF_P_LO = (1.1279169492647987, 0.2362246069042269, 0.023272086736849436,
             -0.00044320715362244646)
_ERF_Q_LO = (1.0, 0.5398383027204903, 0.10605450434127411)
_ERF_ZMAX_LO = 3.0

GELU_TIERS = ("default", "hp", "exact")
_SQRT_HALF = 0.7071067811865476


def _coeffs(tier: str):
    if tier == "hp":
        return _ERF_P, _ERF_Q, _ERF_ZMAX
    if tier == "default":
        return _ERF_P_LO, _ERF_Q_LO, _ERF_ZMAX_LO
    raise ValueError(f"no rational erf for GELU tier {tier!r}")


def _horner(coeffs, t: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def erf_rational(z: torch.Tensor, tier: str = "default") -> torch.Tensor:
    """float32 rational erf, pinned to +-1 beyond the fit range (the pins
    are load-bearing: the clamped P/Q residual would otherwise scale with
    |x| inside GELU's 0.5*x*(1+e))."""
    pc, qc, zmax = _coeffs(tier)
    zc = z.clamp(-zmax, zmax)
    t = zc * zc
    e = zc * (_horner(pc, t) / _horner(qc, t))
    e = torch.where(z <= -zmax, -1.0, e)
    return torch.where(z >= zmax, 1.0, e)


def gelu_rational_f32(h: torch.Tensor, tier: str = "default") -> torch.Tensor:
    """GELU on float32 as the fused MLP kernel computes it (the JAX
    ops/pallas/common.gelu_f32 with an exact divide): e = zc * P * (1/Q),
    pinned to sign(z) where |z| >= zmax."""
    pc, qc, zmax = _coeffs(tier)
    z = h * _SQRT_HALF
    zc = z.clamp(-zmax, zmax)
    t = zc * zc
    e = zc * _horner(pc, t) * (1.0 / _horner(qc, t))
    e = torch.where(z.abs() >= zmax, torch.sign(z), e)
    return 0.5 * h * (1.0 + e)


def gelu(x: torch.Tensor, tier: str = "default") -> torch.Tensor:
    """Exact-erf GELU in float32; the plan's rational tier in bfloat16
    unless the tier is 'exact'. Returns x's dtype."""
    if x.dtype == torch.bfloat16 and tier != "exact":
        x32 = x.float()
        e = erf_rational(x32 * _SQRT_HALF, tier)
        return (0.5 * x32 * (1.0 + e)).to(x.dtype)
    return F.gelu(x, approximate="none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def swiglu(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU gate (genconvit_tpu/ops/act.py:115-122): the last axis split
    in half, silu(a) * b."""
    a, b = x.chunk(2, dim=-1)
    return F.silu(a) * b
