"""On-card numerical parity of every fast path against the unfused reference
graph (port of the JAX package's tools/onchip_parity.py, check for check).

The kernels' own card checks (chip_smoke.py phase 3) hold each kernel
against its plain version, which folds and rounds at the kernel's points,
so a folding fault in both passes there. This sweep holds each fast path
against the graph it replaces, unfused:

  * per ConvNeXt stage shape [4, H, H, C] (a convnext_tiny block from a
    seed, layer scale 0.3, weights in bf16), against `block_reference`
    (dw 7x7, LayerNorm, fc1, exact-erf GELU, fc2, layer scale, residual):
    the LN-folded block (`block_folded`), K1 (`ln_mlp_residual` on the
    depthwise output), K1 through `stage_mlp` (the 'mlp' plan's stage
    path), K5 where `block_kernel_applies`, K6 where `stage_kernel_applies`
    (3e-2), K4 in both int8 modes (4e-2);
  * K7 on 64 windows x 49 tokens x 96 of a swin_tiny stage-0 attention from
    a seed (its bias table O(1)), plain and with the shifted-window mask,
    against the float32 `attention_xla` (3e-2);
  * the bf16 rational GELU against exact erf on 1e5 values of scale 3 (1e-2);
  * K2 against F.layer_norm in float32 (3e-2), K3 against the float32
    product with the dequantized weight at M = 120 (4e-2).

Each check prints one `PASS|FAIL <name>: max rel diff ...` line (max|diff| /
max|ref|); the exit code is 1 on any FAIL. On the card every fast path is
its CUDA kernel (a missing CUDA or kernel build raises); with --device cpu
each is its plain version, which shows the sweep's plumbing and tolerances.
K3's head is the VAE's 25088 x 12544 on the card and an eighth of each
width on the host, where the float32 product at full width takes minutes.
--plant FAULT feeds one kernel a planted fault (PLANTS): the sweep must
then fail.

    python -m genconvit_tpu_torch.tools.onchip_parity [--device cuda|cpu] [--plant FAULT]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from genconvit_tpu_torch.models.convnext import (ConvNeXt, _nchw, _nhwc, block_folded,
                                                 block_kernel_applies, block_reference,
                                                 depthwise, ln_fold, stage_kernel_applies,
                                                 stage_mlp)
from genconvit_tpu_torch.models.init import init_convnext_, init_swin_
from genconvit_tpu_torch.models.swin import SwinTransformer, attention_xla, shifted_window_mask
from genconvit_tpu_torch.ops.act import gelu
from genconvit_tpu_torch.ops.cuda import convnext_block as k5
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4
from genconvit_tpu_torch.ops.cuda import convnext_stage as k6
from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
from genconvit_tpu_torch.ops.cuda import window_attn as k7
from genconvit_tpu_torch.ops.quant import quantize_wint8
from genconvit_tpu_torch.tools._timing import resolve_device

STAGES = ((0, 56, 96), (1, 28, 192), (2, 14, 384), (3, 7, 768))   # (stage, H, C)
BATCH = 4
GAMMA = 0.3          # layer scale: at the init's 1e-6 every check passes trivially
TOL_BF16, TOL_INT8, TOL_GELU = 3e-2, 4e-2, 1e-2
WINDOWS, TOKENS, HEADS, WINDOW = 64, 49, 3, 7
K3_SHAPE = {"cuda": (120, 25088, 12544), "cpu": (120, 3136, 1568)}   # (M, K, N)

# --plant: one kernel's planted fault, from the kernels' own (chip_smoke.py
# phase 3's folds, convnext_block.planted_faults, convnext_stage.chain_faults,
# window_attn.planted_outputs). With the init's weights (zero biases, 0.02
# scales) the MLP branch is 1-20% of max|ref|, so at these tolerances only a
# fault that moves the branch about twofold fails a ConvNeXt check: those are
# the block kernels' plants here (the bias faults leave a zero bias zero; a
# transposed 7x7 moves stage 0-1's branch by less than 3e-2 of max|ref|).
PLANTS = {
    "k1-layer-scale": "K1's folds with the layer scale dropped (gamma 1)",
    "k4-layer-scale": "K4's folds with the layer scale dropped (both modes)",
    "k5-layer-scale": "K5's pack with layer scale 1",
    "k6-dw-transposed": "K6's chain with the depthwise kernel transposed",
    "k6-layer-scale": "K6's chain with layer scale 1",
    "k7-scale-omitted": "K7 without the hd^-1/2 scale",
    "k7-bias-dropped": "K7 without the relative position bias",
    "k2-bias-dropped": "K2 without its bias",
    "k3-bias-dropped": "K3 without its bias",
}


class Check(NamedTuple):
    name: str
    kernel: str      # the kernel the fast path runs ('' for the LN-folded block, GELU)
    rel: float       # max|diff| / max|ref|
    tol: float

    @property
    def ok(self) -> bool:
        return self.rel <= self.tol


class Sweep:
    """Collects the checks and prints a line for each."""

    def __init__(self, out=None):
        self.checks: List[Check] = []
        self.out = out

    def check(self, name: str, kernel: str, ref: torch.Tensor, got: torch.Tensor,
              tol: float) -> None:
        ref, got = ref.float(), got.float()
        scale = max(ref.abs().max().item(), 1e-6)
        rel = (got - ref).abs().max().item() / scale
        if not np.isfinite(rel):
            rel = float("inf")
        c = Check(name, kernel, rel, tol)
        self.checks.append(c)
        print(f"{'PASS' if c.ok else 'FAIL'} {name}: max rel diff {rel:.2e} (tol {tol:.0e})",
              file=self.out or sys.stdout, flush=True)

    @property
    def failures(self) -> List[str]:
        return [c.name for c in self.checks if not c.ok]


@contextlib.contextmanager
def _ieee_float32():
    """TF32 off for the float32 references."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)


def _fold_args(blk, kernel: str, plant: str) -> tuple:
    """The block's fold arguments (LN, fc1, fc2, layer scale), the layer
    scale 1 where `kernel`'s plant asks for it."""
    args = tuple(blk.tensors())[2:]
    if plant == f"{kernel}-layer-scale":
        args = args[:-1] + (torch.ones_like(args[-1]),)
    return args


def _pack(blk, kernel: str, plant: str):
    pack = blk.pack_fused()
    name = {f"{kernel}-dw-transposed": "dw kernel transposed",
            f"{kernel}-layer-scale": "layer scale 1"}.get(plant)
    if kernel == "k6":
        return k6.chain_faults([pack])[name] if name else k5.stack_blocks([pack])
    return k5.planted_faults(pack)[name] if name else pack


def stage_blocks(dev, seed: int = 0):
    """Block 0 of each convnext_tiny stage, from a seed, layer scale GAMMA,
    in bf16 and channels_last."""
    g = torch.Generator().manual_seed(seed)
    model = ConvNeXt.from_name("convnext_tiny")
    init_convnext_(model, g)
    blocks = []
    for si, _, _ in STAGES:
        blk = model.stages[si].blocks[0]
        with torch.no_grad():
            blk.gamma.fill_(GAMMA)
        blocks.append(blk.to(dev, torch.bfloat16).to(memory_format=torch.channels_last))
    return blocks


class Weights(NamedTuple):
    """The sweep's seeded modules, made once for several sweeps."""
    blocks: list     # stage_blocks
    attention: torch.nn.Module   # _attention, float32


def make_weights(dev) -> Weights:
    return Weights(stage_blocks(dev), _attention(dev))


@torch.no_grad()
def block_checks(sweep: Sweep, dev, rng: np.random.Generator, plant: str,
                 blocks: list) -> None:
    for (si, h, c), blk in zip(STAGES, blocks):
        tag = f"s{si} [{h}x{h}x{c}]"
        x = _nchw(_bf16(rng.standard_normal((BATCH, h, h, c)), dev)).contiguous(
            memory_format=torch.channels_last)
        t = blk.tensors()
        ref = block_reference(x, t, "exact")
        sweep.check(f"folded_block {tag}", "", ref, block_folded(x, t, "default", ln_fold(t)),
                    TOL_BF16)
        folds = km.fold_block_mlp(*_fold_args(blk, "k1", plant), torch.bfloat16)
        dw, xr = _nhwc(depthwise(x, t)), _nhwc(x)
        sweep.check(f"pallas_mlp {tag}", "K1", ref,
                    _nchw(km.ln_mlp_residual(dw, xr, folds)), TOL_BF16)
        for mode in ("full", "fc1"):
            f8 = k4.fold_block_mlp_int8(*_fold_args(blk, "k4", plant), mode, torch.bfloat16)
            sweep.check(f"pallas_mlp_int8{mode} {tag}", f"K4 '{mode}'", ref,
                        _nchw(k4.ln_mlp_residual_int8(dw, xr, f8)), TOL_INT8)
        sweep.check(f"pallas_mlp_padded_stage {tag}", "K1", ref,
                    stage_mlp(x, [t], [folds], "default", km.ln_mlp_residual), TOL_BF16)
        if block_kernel_applies(h):
            sweep.check(f"pallas_block {tag}", "K5", ref,
                        _nchw(k5.fused_convnext_block(xr, _pack(blk, "k5", plant))), TOL_BF16)
        if stage_kernel_applies(h, c):
            sweep.check(f"pallas_stage {tag}", "K6", ref,
                        _nchw(k6.fused_convnext_stage(xr, _pack(blk, "k6", plant))), TOL_BF16)


def _attention(dev, seed: int = 1):
    """swin_tiny's stage-0 block-0 attention from a seed, its relative bias
    table O(1) (the init's 0.02 would make the bias path vacuous)."""
    g = torch.Generator().manual_seed(seed)
    model = SwinTransformer("swin_tiny_patch4_window7_224")
    init_swin_(model, g)
    attn = model.layers[0].blocks[0].attn
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(0.0, 1.0, generator=g)
    return attn.to(dev)


@torch.no_grad()
def attention_checks(sweep: Sweep, dev, rng: np.random.Generator, plant: str,
                     attn32: torch.nn.Module) -> None:
    attnb = copy.deepcopy(attn32).to(torch.bfloat16)
    wins = _bf16(rng.standard_normal((WINDOWS, TOKENS, 96)), dev)
    shifted = torch.from_numpy(shifted_window_mask(56, 56, WINDOW, 3)).float().to(dev)
    for label, mask in (("plain", None), ("shifted", shifted)):
        with _ieee_float32():
            qkv = F.linear(wins.float(), attn32.qkv.weight, attn32.qkv.bias)
            ref = F.linear(attention_xla(qkv, attn32.position_bias(WINDOW), mask, HEADS),
                           attn32.proj.weight, attn32.proj.bias)
        qkv = F.linear(wins, attnb.qkv.weight, attnb.qkv.bias)
        bias = attnb.position_bias(WINDOW).float().contiguous()
        nw = 1 if mask is None else mask.shape[0]
        if plant in ("k7-scale-omitted", "k7-bias-dropped"):
            fault = {"k7-scale-omitted": "scale omitted",
                     "k7-bias-dropped": "relative bias dropped"}[plant]
            out = k7.planted_outputs(k7.window_attention, qkv, bias, mask, HEADS, nw)[fault]
        else:
            out = k7.window_attention(qkv, bias, mask, HEADS, nw)
        sweep.check(f"window_attention {label}", "K7", ref,
                    F.linear(out, attnb.proj.weight, attnb.proj.bias), TOL_BF16)


@torch.no_grad()
def gelu_check(sweep: Sweep, dev, rng: np.random.Generator) -> None:
    x = _bf16(rng.standard_normal(100000) * 3, dev)
    exact = F.gelu(x.float(), approximate="none").to(torch.bfloat16)
    sweep.check("rational_gelu bf16", "", exact, gelu(x, "default"), TOL_GELU)


@torch.no_grad()
def row_checks(sweep: Sweep, dev, rng: np.random.Generator, plant: str) -> None:
    """K2 on the stem LN's rows at stage 0's shape; K3 on a latent head."""
    c = STAGES[0][2]
    x = _bf16(rng.standard_normal((BATCH * STAGES[0][1] ** 2, c)), dev)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0.0, 0.5, c).astype(np.float32)).to(dev)
    ref = F.layer_norm(x.float(), (c,), scale, bias, km.LN_EPS)
    kb = torch.zeros_like(bias) if plant == "k2-bias-dropped" else bias
    sweep.check("layer_norm_rows", "K2", ref, km.layer_norm_rows(x, scale, kb), TOL_BF16)

    m, k, n = K3_SHAPE[dev.type]
    g = torch.Generator(device=dev).manual_seed(2)
    w = (torch.rand(n, k, device=dev, generator=g) * 2 - 1) * k ** -0.5
    wq, ws = quantize_wint8(w, dim=1)
    hb = 0.5 * torch.randn(n, device=dev, generator=g)
    xm = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    with _ieee_float32():
        ref = xm.float() @ (wq.float() * ws[:, None]).t() + hb
    if plant == "k3-bias-dropped":
        hb = torch.zeros_like(hb)
    sweep.check(f"matmul_wint8 [M={m}, K={k}, N={n}]", "K3", ref,
                k3.matmul_wint8(xm, wq, ws, hb), TOL_INT8)


def run(dev: torch.device, plant: Optional[str] = None, out=None, seed: int = 0,
        weights: Optional[Weights] = None) -> Sweep:
    """The whole sweep on `dev` (with `weights` from make_weights, or made
    here); the checks are in the returned Sweep."""
    if plant is not None and plant not in PLANTS:
        raise ValueError(f"unknown plant {plant!r}; choose from {sorted(PLANTS)}")
    if dev.type == "cuda":
        from genconvit_tpu_torch.ops.cuda import _build

        _build.load()   # raises where the kernels do not build
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    weights = weights or make_weights(dev)
    rng = np.random.default_rng(seed)
    sweep = Sweep(out)
    block_checks(sweep, dev, rng, plant or "", weights.blocks)
    attention_checks(sweep, dev, rng, plant or "", weights.attention)
    gelu_check(sweep, dev, rng)
    row_checks(sweep, dev, rng, plant or "")
    return sweep


def kernel_ratios(sweep: Sweep) -> dict:
    """Each kernel's largest max rel diff over its checks."""
    out: dict = {}
    for c in sweep.checks:
        if c.kernel:
            out[c.kernel] = max(out.get(c.kernel, 0.0), c.rel)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain "
                    "versions)")
    ap.add_argument("--plant", choices=sorted(PLANTS), help="feed one kernel a planted fault")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU, plain versions"
    print(f"device: {dev} ({where})" + (f"; planted: {PLANTS[args.plant]}" if args.plant else ""),
          file=sys.stderr)
    sweep = run(dev, args.plant)
    if sweep.failures:
        print(f"\n{len(sweep.failures)} FAILURES: {sweep.failures}")
        return 1
    print("\nall on-chip parity checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
