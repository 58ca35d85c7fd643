"""The depthwise 7x7 with its per-pixel moments, the first half of the
LN-folded ConvNeXt block: M3 (ops/cuda/dw_moments.py), the port of the JAX
package's tools/microbench_dwshift.py, against the yardstick that the
port's Block.forward_folded runs today:

  library  cuDNN's depthwise conv, then the f32 mean and E[x^2] - mean^2 of
           the rounded output (the tool's xla_fn)
  kernel   M3: the taps, bf16(acc), and the moments of the f32 acc

Prints CUDA-event ms per launch of each, the kernel's agreement with its
plain version, how far the two definitions of the moments sit apart, and
the bound at the H100's published peaks. The port pads no channels: the
default C is the real 96 (the JAX tool's 128 was 96 padded to the lanes).

    python3 -m genconvit_tpu_torch.tools.microbench_dwshift [--n 240 --h 56 --c 96]
"""

from __future__ import annotations

import argparse
import sys

import torch

from genconvit_tpu_torch.ops.cuda import dw_moments as m3
from genconvit_tpu_torch.tools._timing import FP32, bound_ms, clock_label, resolve_device, time_ms


def make_inputs(n: int, h: int, c: int, dev, g) -> tuple:
    """The JAX tool's operands (:57-58, :142): x ~ N(0, 1) in bf16, k and b
    ~ N(0, 0.05^2) in f32, here bf16-representable (see dw_moments)."""
    x = torch.randn(n, h, h, c, device=dev, generator=g).to(torch.bfloat16)
    k = (0.05 * torch.randn(7, 7, c, device=dev, generator=g)).to(torch.bfloat16).float()
    b = 0.05 * torch.randn(c, device=dev, generator=g)
    return x, k, b


def in_image_taps(length: int) -> int:
    """The taps of a 7-tap line whose input lies inside an axis of `length`,
    summed over its positions: min(p, 3) + min(length - 1 - p, 3) + 1 at
    position p."""
    return sum(min(p, 3) + min(length - 1 - p, 3) + 1 for p in range(length))


def dw_bound(n: int, h: int, w: int, c: int) -> tuple:
    """M3's bound: x in and dw out once (bf16), mean and var out (f32), the
    weights once; 2 f32 operations for each tap whose input lies inside the
    image (a tap in the zero halo adds nothing and need not run), per
    channel: 2 * n * c * in_image_taps(h) * in_image_taps(w)."""
    px = n * h * w
    return bound_ms(px * c * 4 + px * 8 + 4 * 50 * c,
                    {FP32: 2 * n * c * in_image_taps(h) * in_image_taps(w)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=240)
    ap.add_argument("--h", type=int, default=56)
    ap.add_argument("--c", type=int, default=96)
    ap.add_argument("--iters", type=int, default=8, help="timed launches of each")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    x, k, b = make_inputs(args.n, args.h, args.c, dev, g)
    got = m3.dw_moments(x, k, b)
    err = m3.ulp_error(got, m3.dw_moments_plain(x, k, b))
    gap = m3.moments_rounding_gap(*got)
    print(f"N={args.n} H=W={args.h} C={args.c} [{clock_label(dev)}]", flush=True)
    print(f"parity vs plain: dw {err['dw_ulps']:g} bf16 ulps (limit {m3.ULP_TOL:g}), mean "
          f"{err['mean_rel']:.2e}, var {err['var_rel']:.2e} (limit {m3.MOMENT_TOL:g}); moments "
          f"of the rounded dw vs the f32 sums: mean {gap[0]:.2e}, var {gap[1]:.2e}", flush=True)
    for name, fn in (("library", m3.dw_moments_library), ("kernel", m3.dw_moments)):
        ms = time_ms(lambda: fn(x, k, b), dev, args.iters)
        print(f"{name}: {ms:.4f} ms/launch", flush=True)
    bd, by = dw_bound(args.n, args.h, args.h, args.c)
    print(f"H100 bound {bd:.4f} ms ({by})", flush=True)
    return 0 if m3.agrees(err) else 1


if __name__ == "__main__":
    sys.exit(main())
