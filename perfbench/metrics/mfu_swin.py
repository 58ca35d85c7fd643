"""mfu_swin.*: the model's operations of the videos scored in the
untraced window (`_flops_swin.video`: GenConViT's ED branch on the
configuration's Swin) over the window's seconds and the H100's dense bf16
peak, in %."""

from perfbench.metrics import _flops, _flops_swin


def read(r):
    seconds, videos = r.window.get("seconds"), r.window.get("videos")
    if not seconds or not videos:
        return None
    return 100.0 * videos * _flops_swin.video(r.cell["config"]) / seconds / _flops.BF16_FLOPS
