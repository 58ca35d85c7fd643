"""k1_roofline_swin.*: the least time of the traced slice's K1 launches
(`_flops.k1_bound_s` of each Swin MLP half's rows and width: bytes or
operations, whichever is larger) over their device time, in %. A forward
of the default plan makes 24 of them, one a block (`_flops_swin.k1_launches`);
where the slice holds another count, nothing is read."""

from perfbench.core.groups import is_k1
from perfbench.core.trace import count
from perfbench.metrics import _flops_swin


def read(r):
    if r.trace is None or not r.slice_units.get("forwards"):
        return None
    cfg = r.cell["config"]
    frames = int(r.slice_units["frames_per_forward"])
    forwards = int(r.slice_units["forwards"])
    launches, seconds = count(r.trace.kernels, is_k1)
    if launches == 0 or launches != forwards * len(_flops_swin.k1_launches(cfg, frames)):
        return None
    return 100.0 * forwards * _flops_swin.k1_forward_bound_s(cfg, frames) / seconds
