"""mfu.*: the model's operations of the work done in the untraced window over
the window's seconds and the H100's dense bf16 peak, in %. Scoring cells
count the videos scored (`_flops.video` of the configuration's shapes);
training cells the images of every step completed (`_flops.train_image`:
three times the forward's, recompute not counted)."""

from perfbench.metrics import _flops


def read(r):
    seconds, cfg = r.window.get("seconds"), r.cell["config"]
    if r.window.get("videos"):
        work = r.window["videos"] * _flops.video(cfg)
    elif r.window.get("images"):
        work = r.window["images"] * _flops.train_image(cfg)
    else:
        return None
    return 100.0 * work / seconds / _flops.BF16_FLOPS if seconds else None
