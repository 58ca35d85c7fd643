"""The benchmark's seeded weights: both branches' state dicts, made on the
device from one generator in one draw of uniforms that every leaf then
transforms (`spec.py` gives each leaf's rule), in the dtype asked for.

The port and the reference get the same tensors: the port as its
`Predictor(params=...)` or its module's `load_state_dict` takes them, the
reference upcast to float32.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch

from perfbench.reference.spec import Leaf, branch_leaves

_CUT = 2.0   # normal leaves are cut at 2 std, by the inverse CDF of a clipped uniform
_TAIL = 2.326         # 'heavy': the normal's values beyond this (2% of them) are
#                       scaled by the leaf's outlier gain, the whole rescaled to its std
_U_EDGE = 1e-7        # uniforms kept this far from 0 and 1 (finite erfinv)


def _transform(u: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """u: U(0, 1) float32 of the leaf's size -> the leaf's values."""
    if leaf.rule == "uniform":
        return u.mul(2.0).sub(1.0).mul(leaf.arg)
    if leaf.rule == "range":
        lo, hi = leaf.arg
        return u.mul(hi - lo).add(lo)
    if leaf.rule == "normal":
        lo = 0.5 * (1 + math.erf(-_CUT / math.sqrt(2)))
        p = u.mul(1 - 2 * lo).add(lo)
        return torch.erfinv(p.mul(2).sub(1)).mul(leaf.arg * math.sqrt(2))
    if leaf.rule in ("heavy", "gain"):
        z = torch.erfinv(u.clamp(_U_EDGE, 1 - _U_EDGE).mul(2).sub(1)).mul_(math.sqrt(2))
        if leaf.rule == "gain":
            return z.mul_(leaf.arg).exp_()
        std, gain = leaf.arg
        z = torch.where(z.abs() > _TAIL, z * gain, z)
        return z.mul_(std / heavy_std(gain))
    raise ValueError(f"no draw for rule {leaf.rule!r}")


def heavy_std(gain: float) -> float:
    """The std of a unit normal whose values beyond _TAIL are scaled by gain:
    E[z^2] = 1 + (gain^2 - 1) * 2 (a phi(a) + Q(a))."""
    a = _TAIL
    tail = a * math.exp(-a * a / 2) / math.sqrt(2 * math.pi) + 0.5 * math.erfc(a / math.sqrt(2))
    return math.sqrt(1 + (gain * gain - 1) * 2 * tail)


def _drawn(leaves: Iterable[Leaf]) -> List[Leaf]:
    return [lf for lf in leaves if lf.rule in ("uniform", "range", "normal", "heavy", "gain")]


@torch.no_grad()
def make_state_dicts(cfg: dict, seed: int, device, dtype=torch.float32,
                     branches=("ed", "vae")) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'ed': sd, 'vae': sd} of the configuration, from `seed`. Every leaf
    takes its slice of one torch.rand draw on `device`, in the order of
    `spec.branch_leaves` (both branches, whichever are asked for, so that a
    branch's weights do not depend on which others are made)."""
    specs = branch_leaves(cfg)
    total = sum(math.prod(lf.shape) for b in ("ed", "vae") for lf in _drawn(specs[b]))
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    off = 0
    for b in ("ed", "vae"):
        sd: Dict[str, torch.Tensor] = {}
        for lf in specs[b]:
            n = math.prod(lf.shape)
            if lf.rule == "count":
                sd[lf.key] = torch.zeros(lf.shape, dtype=torch.int64, device=device)
                continue
            if lf.rule == "const":
                sd[lf.key] = torch.full(lf.shape, float(lf.arg), dtype=dtype, device=device)
                continue
            if b in branches:
                sd[lf.key] = _transform(flat[off:off + n], lf).to(dtype).reshape(lf.shape)
            off += n
        if b in branches:
            out[b] = sd
    del flat
    return out


def as_float32(sds: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's copy: float leaves upcast to float32."""
    return {b: {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
            for b, sd in sds.items()}
