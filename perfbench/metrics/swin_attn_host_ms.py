"""swin_attn_host_ms.*: the host's ms a forward in the Swin blocks'
attention halves: the self time of span gcv.swin.attention (LN1, the
rolls, the window partition and reverse, the qkv and proj products, the
attention's launch, the residual: `models/swin.py`) over the traced
slice's forwards. Nothing where the program has no such span."""

from perfbench.metrics import _spans


def read(r):
    row = _spans.table().get("gcv.swin.attention")
    forwards = r.slice_units.get("forwards")
    if not row or not row["count"] or not forwards:
        return None
    return 1e3 * row["self_s"] / forwards
