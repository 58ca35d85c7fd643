"""Is an int8 x int8 -> int32 product on the tensor cores faster than the
bf16 one at a ConvNeXt block tail's shapes, apart from the W8A8 tail's
quantization passes? Times M1 (ops/cuda/int8_dot.py), the port of the JAX
package's tools/microbench_int8_dot.py:

  dots_bf16  z = y . w1; o = h . w2 (bf16 in, f32 sums); out = bf16(o + z[:, :c])
  dots_int8  the same products on int8 operands (int32 sums), scaled per
             column in f32 after the sums

with rows = n*h*h, hid = 3c by default (the JAX tool's) or --hid (4c for
K4's shapes). Prints CUDA-event ms per launch of each, its agreement with
its plain version and the bound at the H100's published peaks.

    python3 -m genconvit_tpu_torch.tools.microbench_int8_dot [--shape 240,56,128] [--hid N]
"""

from __future__ import annotations

import argparse
import sys

import torch

from genconvit_tpu_torch.ops.cuda import int8_dot as m1
from genconvit_tpu_torch.tools._timing import (BF16, INT8, bound_ms, clock_label,
                                               resolve_device, time_ms)


def make_inputs(kind: str, rows: int, c: int, hid: int, dev, g) -> tuple:
    """The JAX tool's operands (build(), :68-88), made on the device from a
    seed, with the weights in the Linear layout: bf16 y, h ~ N(0, 1) and
    weights ~ N(0, 0.05^2); int8 uniform in [-127, 127) with unit scales."""
    if kind == "bf16":
        def r(*shape, s=1.0):
            return (s * torch.randn(*shape, device=dev, generator=g)).to(torch.bfloat16)
        return r(rows, c), r(rows, hid), r(hid, c, s=.05), r(c, hid, s=.05)

    def q(*shape):
        return torch.randint(-127, 127, shape, device=dev, generator=g, dtype=torch.int8)
    ones = torch.ones
    return (q(rows, c), q(rows, hid), q(hid, c), ones(hid, device=dev), q(c, hid),
            ones(c, device=dev))


def dots_bound(kind: str, rows: int, c: int, hid: int) -> tuple:
    """M1's bound: y and h in, out out, the weights and scales once; 4 *
    rows * c * hid operations of the two products on the tensor cores."""
    e = 2 if kind == "bf16" else 1
    nbytes = rows * (c + hid) * e + rows * c * 2 + 2 * c * hid * e + (0 if e == 2 else 4 * (c + hid))
    return bound_ms(nbytes, {BF16 if kind == "bf16" else INT8: 4 * rows * c * hid})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="240,56,128", help="n,h,c: rows = n*h*h")
    ap.add_argument("--hid", type=int, default=None, help="hidden width (default 3c)")
    ap.add_argument("--trials", type=int, default=6, help="timed launches of each")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    n, h, c = (int(v) for v in args.shape.split(","))
    rows, hid = n * h * h, args.hid or 3 * c
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"rows={rows} c={c} hid={hid}: {4 * rows * c * hid / 1e9:.1f} GOP "
          f"[{clock_label(dev)}]", flush=True)
    for kind, fn, plain, tol in (("bf16", m1.dots_bf16, m1.dots_bf16_plain, m1.ULP_TOL),
                                 ("int8", m1.dots_int8, m1.dots_int8_plain, m1.ULP_TOL_INT8)):
        ops = make_inputs(kind, rows, c, hid, dev, g)
        ulps = m1.ulp_error(fn(*ops), plain(*ops))
        ms = time_ms(lambda: fn(*ops), dev, args.trials)
        bd, by = dots_bound(kind, rows, c, hid)
        print(f"  dots_{kind}: {ms:.4f} ms/launch; H100 bound {bd:.4f} ms ({by}); vs plain "
              f"{ulps:g} bf16 ulps (limit {tol:g})", flush=True)
        if not ulps <= tol:
            return 1
        del ops
    return 0


if __name__ == "__main__":
    sys.exit(main())
