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

`k7_plan` mirrors the kernel's work-item plan (heads per item, strips,
teams of warps, ring stages, shared memory, threads, blocks); `k7_schedule`
the window-heads each block's warps take; `to_fragments` the order in which
the kernel stages the bias and reads the mask (the wrapper hands the kernel
the mask in that order, `staged_mask`: one gather per masked launch);
`library_k7_plan` asks the built library.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda.convnext_mlp import _check_vec, _require, _stream

MAX_L = 64               # tokens per window the kernel takes
HEAD_DIMS = (16, 32, 64)
MAX_WARPS = 16           # warps of a block (csrc/window_attn.cu kMaxWarps)
MAX_TEAMS = 8            # teams of a block (one named barrier each)
MAX_STAGES = 3           # ring stages of a team
SMEM_LIMIT = 232448      # shared memory a block may use on an H100
# Kernel vs plain, elementwise, in bf16 ulps of the largest |out| of the same
# window-head (`ulp_error`). Both round at the same points; they differ by
# float32 noise (the kernel scales q . k by hd^-1/2 log2(e) and adds the
# bias times log2(e) in one fused multiply-add, takes ex2 of the difference
# with the row max, sums in another order and multiplies by one reciprocal of
# the row sum), which can flip the bf16 rounding of a p or of an output. A flip of p[r, k] moves out[r, :] by at most an ulp of p times |v[k]|,
# and |v| can be far above |out[r, d]| where p . v cancels, so an element's own
# ulp is no floor: the window-head's max |out| is. One flip of p and one of the
# output: 2 ulps.
ULP_TOL = 2.0


class K7Plan(NamedTuple):
    """K7's plan for one launch (csrc/window_attn.cu gcv_k7_plan)."""
    group: int     # G heads per work item (one window x G heads)
    strips: int    # S = ceil(L / 16) query strips: warps per head
    teams: int     # teams of G * S warps, taking items in turn
    stages: int    # ring stages of each team
    smem: int      # dynamic shared memory, bytes
    threads: int   # 32 * teams * G * S
    blocks: int    # (heads / G) head groups x blocks per group


def _align(n: int, a: int) -> int:
    return (n + a - 1) // a * a


def k7_bias_bytes(group: int, strips: int, l: int) -> int:
    """The head group's bias in fragment order [G][S][ceil(L / 8)][32][4]
    f32, the area rounded to 1024 bytes."""
    return _align(group * strips * -(-l // 8) * 512, 1024)


def k7_stage_bytes(group: int, strips: int, hd: int, l: int, masked: bool) -> int:
    """One ring stage, rounded to 1024 bytes: the q, k, v tiles [3][G][16 S
    rows][hd] bf16, then under a mask the window's mask in fragment order
    [S][ceil(L / 8)][32][4] f32 (`staged_mask`)."""
    tiles = 3 * group * 16 * strips * hd * 2
    return _align(tiles + (strips * -(-l // 8) * 512 if masked else 0), 1024)


def _blocks(groups: int, windows: int, sms: int) -> int:
    """Blocks of a launch: sms // groups per head group (at least 1, at
    most the windows), one per SM."""
    return groups * min(max(1, sms // groups), windows)


def k7_plan(l: int, heads: int, hd: int, masked: bool, windows: int,
            sms: int = 132) -> Optional[K7Plan]:
    """K7's plan as the CUDA source computes it; None where K7 does not take
    the shape. G: of the divisors of heads that fit (G * S <= MAX_WARPS
    warps, two stages of G heads' items in shared memory) with G * hd >= 64
    (each token's q, k and v slices at least 128 contiguous bytes), the one
    whose blocks fill the most SMs (the smallest of equals); where there is
    none, the largest that fits. Teams fill MAX_WARPS (at most MAX_TEAMS),
    fewer where shared memory cannot give each two stages; each team's ring
    holds up to MAX_STAGES. One block per SM."""
    if not (1 <= l <= MAX_L and heads >= 1 and windows >= 1 and sms >= 1 and hd in HEAD_DIMS):
        return None
    s = -(-l // 16)

    def ring_bytes(d):   # the limit less the alignment slack, the bias, the barriers
        return SMEM_LIMIT - 1024 - k7_bias_bytes(d, s, l) - 256

    divs = [d for d in range(1, heads + 1) if heads % d == 0 and d * s <= MAX_WARPS
            and ring_bytes(d) >= 2 * k7_stage_bytes(d, s, hd, l, masked)]
    if not divs:
        return None
    wide = [d for d in divs if d * hd >= 64]
    g = max(wide, key=lambda d: (_blocks(heads // d, windows, sms), -d)) if wide else divs[-1]
    stage = k7_stage_bytes(g, s, hd, l, masked)
    avail = ring_bytes(g)
    teams = min(MAX_WARPS // (g * s), MAX_TEAMS)
    while teams > 1 and avail // (teams * stage) < 2:
        teams -= 1
    stages = min(avail // (teams * stage), MAX_STAGES)
    if stages < 1:
        return None
    return K7Plan(g, s, teams, stages, 1024 + k7_bias_bytes(g, s, l) + teams * stages * stage + 256,
                  32 * teams * g * s, _blocks(heads // g, windows, sms))


def library_k7_plan(l: int, heads: int, hd: int, masked: bool, windows: int,
                    sms: int) -> Optional[K7Plan]:
    """K7's plan as the built library computes it (loads the library); the
    card tests hold `k7_plan` against it."""
    out = (ctypes.c_int * 7)()
    ok = _build.load().gcv_k7_plan(l, heads, hd, int(masked), windows, sms, out)
    return K7Plan(*out) if ok else None


def k7_schedule(plan: K7Plan, heads: int, windows: int
                ) -> Iterator[Tuple[int, int, int, int, int, int, int]]:
    """(block, item, ring slot, warp, window, head, strip) for every strip
    the launch computes, in the kernel's order: block b keeps head group
    b % (heads / G) and takes windows b // groups + i * per (per = blocks //
    groups) as its items i; team i % teams takes item i, into its ring's slot
    (i // teams) % stages (the ring slot is team * stages + that), and its
    warp h * S + s computes strip s of head hg * G + h."""
    groups = heads // plan.group
    per = plan.blocks // groups
    tw = plan.group * plan.strips
    for b in range(plan.blocks):
        hg, w0 = b % groups, b // groups
        for i, win in enumerate(range(w0, windows, per)):
            team = i % plan.teams
            slot = team * plan.stages + (i // plan.teams) % plan.stages
            for h in range(plan.group):
                for s in range(plan.strips):
                    yield (b, i, slot, team * tw + h * plan.strips + s, win,
                           hg * plan.group + h, s)


def _fragment_coords(l: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, key) of each [S, ceil(L / 8), 32, 4] fragment slot (to_fragments)."""
    s, nt = -(-l // 16), -(-l // 8)
    strip = torch.arange(s, device=device)[:, None, None, None]
    tile = torch.arange(nt, device=device)[None, :, None, None]
    lane = torch.arange(32, device=device)[None, None, :, None]
    e = torch.arange(4, device=device)[None, None, None, :]
    r = 16 * strip + lane // 4 + 8 * (e // 2)
    col = 8 * tile + 2 * (lane % 4) + e % 2
    return r.expand(s, nt, 32, 4), col.expand(s, nt, 32, 4)


def to_fragments(m: torch.Tensor) -> torch.Tensor:
    """[..., L, L] -> [..., S, ceil(L / 8), 32, 4]: element (r, col) at strip
    r // 16, key tile col // 8, lane 4 * (r % 8) + (col % 8) // 2, element
    2 * (r % 16 // 8) + col % 2 (the m16n8 accumulator fragment of mma.sync),
    zero past L. The order in which the kernel stages the head group's bias
    and reads the window's mask: a lane reads the 4 values of its scores of
    8 keys with one 16-byte load."""
    l = m.shape[-1]
    r, col = _fragment_coords(l, m.device)
    ok = (r < l) & (col < l)
    out = m[..., r.clamp(max=l - 1), col.clamp(max=l - 1)]
    return torch.where(ok, out, torch.zeros((), dtype=m.dtype, device=m.device))


@functools.lru_cache(maxsize=16)
def _fragment_index(l: int, device: torch.device) -> torch.Tensor:
    """Flat [L * L] positions in `to_fragments` order, 0 where (r, col) is
    past L."""
    pos = torch.arange(l * l, dtype=torch.float32).view(l, l) + 1
    return (to_fragments(pos).reshape(-1).long() - 1).clamp(min=0).to(device)


def staged_mask(mask: torch.Tensor) -> torch.Tensor:
    """K7's mask operand [nW, S * ceil(L / 8) * 128] f32: each window's mask
    in `to_fragments` order, one gather. Entries past L hold mask[.., 0, 0]
    in place of 0 (any finite value will do: the kernel's bias is -inf on
    keys past L, and rows past L are never stored)."""
    n, l = mask.shape[0], mask.shape[-1]
    return mask.reshape(n, l * l).index_select(1, _fragment_index(l, mask.device))


def from_fragments(f: torch.Tensor, l: int) -> torch.Tensor:
    """The inverse of `to_fragments`: [..., S, NT, 32, 4] -> [..., L, L]."""
    r, col = _fragment_coords(l, f.device)
    ok = (r < l) & (col < l)
    out = f.new_zeros(f.shape[:-4] + (l, l))
    out[..., r[ok], col[ok]] = f[..., ok]
    return out


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
    frag = None if mask is None else staged_mask(mask)
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        err = lib.gcv_window_attention(qkv.data_ptr(), bias.data_ptr(),
                                       None if frag is None else frag.data_ptr(),
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
    orders agree); the bias of the neighbouring head group (head h reads
    bias[(h + G) % heads], G of `k7_plan`; only where there are two groups
    or more); the hd^-1/2 scale omitted (q multiplied by hd^1/2, up to one
    bf16 rounding of q); the ring off by one stage (each window's output
    from the q, k and v of the window before); the last query strip's valid
    rows dropped (rows 16 (S - 1) .. L - 1 zero); with a mask, the mask
    dropped and, where the mask holds two windows or more, the mask of the
    window before."""
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
    plan = k7_plan(l, heads, hd, mask is not None, b)
    if plan is not None and plan.group < heads:
        faults["bias of the neighbouring head group"] = fn(
            qkv, bias.roll(-plan.group, 0).contiguous(), mask, heads, nw)
    unscaled = qkv.clone()
    unscaled[..., :c3 // 3] *= hd ** 0.5
    faults["scale omitted"] = fn(unscaled, bias, mask, heads, nw)
    if b > 1:
        faults["ring off by one stage"] = fn(qkv.roll(1, 0).contiguous(), bias, mask, heads, nw)
    dropped = fn(qkv, bias, mask, heads, nw).clone()
    dropped[:, 16 * ((l - 1) // 16):] = 0
    faults["last strip's valid rows dropped"] = dropped
    if mask is not None:
        faults["mask dropped"] = fn(qkv, bias, None, heads, 1)
        if nw > 1:
            faults["mask of the window before"] = fn(qkv, bias, mask.roll(1, 0).contiguous(),
                                                     heads, nw)
    return faults
