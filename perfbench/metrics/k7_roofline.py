"""k7_roofline.*: the least time of the traced slice's K7 launches (the
window attention, `_flops_swin.k7_bound_s` of each launch's windows,
heads and mask) over their device time, in %. A Swin forward makes one a
block (24 in swin_large, 11 of them under the shifted-window mask:
`_flops_swin.k7_launches`); where the slice holds other counts, or the
kernels' names do not say which are masked, nothing is read."""

import re

from perfbench.metrics import _flops_swin

# the MASKED template argument, demangled (window_attn_kernel<32, true, 7>)
# or mangled (window_attn_kernelILi32ELb1ELi7E)
_MASKED = re.compile(r"window_attn_kernel(?:<\s*\d+\s*,\s*(true|false)|ILi\d+ELb([01])E)")


def read(r):
    if r.trace is None or not r.slice_units.get("forwards"):
        return None
    cfg = r.cell["config"]
    frames = int(r.slice_units["frames_per_forward"])
    forwards = int(r.slice_units["forwards"])
    hits = [k for k in r.trace.kernels if "window_attn_kernel" in k.name]
    flags = [_MASKED.search(k.name) for k in hits]
    if not hits or any(f is None for f in flags):
        return None
    masked = sum(f.group(1) == "true" or f.group(2) == "1" for f in flags)
    want = _flops_swin.k7_launches(cfg, frames)
    if len(hits) != forwards * len(want) or masked != forwards * sum(w[-1] for w in want):
        return None
    return 100.0 * forwards * _flops_swin.k7_forward_bound_s(cfg, frames) / sum(
        k.dur for k in hits)
