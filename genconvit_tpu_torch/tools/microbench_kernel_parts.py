"""Where the time of the fused ConvNeXt block goes: M2
(ops/cuda/block_parts.py), the port of the JAX package's
tools/microbench_kernel_parts.py, runs K5's tile cut after each of its
phases (dma, dw, dw_bf16acc, ln, fc1, gelu, full) and prints CUDA-event ms
per launch of each with the delta from the phase before (dw_bf16acc beside
dw, no delta), and each phase's agreement with its plain version. The
deltas attribute K5's time to its steps. The weights are made as the JAX
tool makes them, packed as K5 reads them; the port pads no channels.

    python3 -m genconvit_tpu_torch.tools.microbench_kernel_parts [--n 240 --h 56 --c 96]
"""

from __future__ import annotations

import argparse
import sys

import torch

from genconvit_tpu_torch.ops.cuda import block_parts as m2
from genconvit_tpu_torch.ops.cuda.convnext_block import FusedBlockWeights
from genconvit_tpu_torch.tools._timing import clock_label, resolve_device, time_ms


def make_pack(c: int, dev, g) -> FusedBlockWeights:
    """The JAX tool's weights (:119-128) as K5's pack: vectors N(0, 0.05^2)
    but the LN scale N(0, 1) and the layer scale N(0, 0.5^2), matrices
    N(0, 0.05^2) in bf16 (and transposed, as the kernel reads them), and
    the depthwise weights in bf16 too."""
    def mk(*shape, s=0.05):
        return s * torch.randn(*shape, device=dev, generator=g)
    e = 4 * c
    w1, w2 = mk(c, e).to(torch.bfloat16), mk(e, c).to(torch.bfloat16)
    return FusedBlockWeights(w_dw=mk(49, c).to(torch.bfloat16), b_dw=mk(c), ln_scale=mk(c, s=1.0),
                             ln_bias=mk(c), w1=w1, b1=mk(e), w2=w2, b2=mk(c), gamma=mk(c, s=0.5),
                             w1t=w1.t().contiguous(), w2t=w2.t().contiguous())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=240)
    ap.add_argument("--h", type=int, default=56)
    ap.add_argument("--c", type=int, default=96)
    ap.add_argument("--iters", type=int, default=6, help="timed launches of each phase")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    p = make_pack(args.c, dev, g)
    x = torch.randn(args.n, args.h, args.h, args.c, device=dev, generator=g).to(torch.bfloat16)
    print(f"N={args.n} H=W={args.h} C={args.c} [{clock_label(dev)}]", flush=True)
    prev, ok = 0.0, True
    for phase in m2.PHASES:
        ulps = m2.ulp_error(m2.block_parts(x, p, phase), m2.block_parts_plain(x, p, phase), x,
                            phase)
        ok = ok and ulps <= m2.ULP_TOL
        ms = time_ms(lambda: m2.block_parts(x, p, phase), dev, args.iters)
        delta = "" if phase == "dw_bf16acc" else f"  (+{ms - prev:.4f})"
        print(f"{phase:12s} {ms:9.4f} ms{delta}; vs plain {ulps:g} bf16 ulps", flush=True)
        if phase != "dw_bf16acc":
            prev = ms
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
