"""Operations of GenConViT's ED branch on a Swin backbone, from a
configuration's shapes (`configs/genconvit_ed_swin_large.json`), and K7's
least time.

Operations are 2 per multiply-add of the convolutions, transposed
convolutions and matrix products, the attention's two products (q . k^T
and p . v) included: the work the model needs, whatever kernel runs it.
Elementwise ops, normalizations, the softmax and pooling are not counted.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.metrics._flops import BF16_FLOPS, HBM_BYTES, _head, conv, k1_bound_s, linear
from perfbench.reference.spec import ED_DEC, ED_ENC

FP32_FLOPS = 67e12   # f32 FLOP/s beside the tensor cores


def stages(cfg: dict, img: int) -> List[Tuple[int, int, int, int, int]]:
    """(grid side, C, depth, heads, window) of each stage at img x img, the
    window clamped to the grid (timm 0.6.5)."""
    out, h, c = [], img // 4, cfg["embed_dim"]
    for depth, heads in zip(cfg["depths"], cfg["num_heads"]):
        out.append((h, c, depth, heads, min(cfg["window_size"], h)))
        h, c = h // 2, 2 * c
    return out


def swin(cfg: dict, n: int, img: int) -> float:
    """One Swin forward of n images of img x img to the head's logits."""
    total = conv(n, 3, cfg["embed_dim"], 4, img // 4, img // 4)
    st = stages(cfg, img)
    for s, (h, c, depth, _, w) in enumerate(st):
        rows = n * h * h
        per_block = (linear(rows, c, 3 * c) + 2.0 * 2 * rows * w * w * c
                     + linear(rows, c, c) + 2 * linear(rows, c, 4 * c))
        total += depth * per_block
        if s < len(st) - 1:
            total += linear(n * (h // 2) ** 2, 4 * c, 2 * c)
    return total + linear(n, st[-1][1], cfg["backbone_classes"])


def ed(cfg: dict, n: int) -> float:
    """The ED branch over n frames: encoder, decoder, the Swin on the 2n
    images [x_hat, x], the head."""
    img = cfg["img_size"]
    total, h = 0.0, img
    for i in range(5):
        total += conv(n, ED_ENC[i], ED_ENC[i + 1], 3, h, h)
        h //= 2
    for i in range(5):   # transposed 2x2 stride 2: each input pixel feeds 4 outputs
        total += 2.0 * n * h * h * ED_DEC[i] * ED_DEC[i + 1] * 4
        h *= 2
    return total + swin(cfg, 2 * n, img) + _head(cfg, n)


def video(cfg: dict) -> float:
    """One scored video: the ED branch over its frames."""
    return ed(cfg, cfg["num_frames"])


def k1_launches(cfg: dict, frames: int) -> List[Tuple[int, int, bool]]:
    """(rows, C, post-LN) of every K1 launch of one forward over `frames`
    frames (the ED call: 2 x frames images), in launch order: each block's
    MLP half, no post-LN."""
    n = 2 * frames
    return [(n * h * h, c, False) for h, c, depth, _, _ in stages(cfg, cfg["img_size"])
            for _ in range(depth)]


def k1_forward_bound_s(cfg: dict, frames: int) -> float:
    return sum(k1_bound_s(*launch)[0] for launch in k1_launches(cfg, frames))


def k7_bound_s(b: int, l: int, heads: int, hd: int, nw: int, masked: bool) -> float:
    """The least time of one K7 launch (chip_smoke.py `k7_bound`): qkv in
    and the output out once (bf16), the bias (and the mask) once (f32);
    4 L^2 hd bf16 operations of the two products a window-head on the
    tensor cores and, beside them, ~8 f32 operations a score of the softmax."""
    g = b * heads
    nbytes = 2 * b * l * 4 * heads * hd + 4 * l * l * (heads + (nw if masked else 0))
    t_ops = max(4.0 * l * l * hd * g / BF16_FLOPS, 8.0 * l * l * g / FP32_FLOPS)
    return max(nbytes / HBM_BYTES, t_ops)


def k7_launches(cfg: dict, frames: int) -> List[Tuple[int, int, int, int, int, bool]]:
    """(windows B, L, heads, hd, nW, masked) of every K7 launch of one
    forward over `frames` frames, in launch order: every other block
    shifted, and so masked, where the grid is larger than the window."""
    n, out = 2 * frames, []
    for h, c, depth, heads, w in stages(cfg, cfg["img_size"]):
        nw = (h // w) ** 2
        for b in range(depth):
            masked = b % 2 == 1 and h > cfg["window_size"]
            out.append((n * nw, w * w, heads, c // heads, nw, masked))
    return out


def k7_forward_bound_s(cfg: dict, frames: int) -> float:
    return sum(k7_bound_s(*launch) for launch in k7_launches(cfg, frames))
