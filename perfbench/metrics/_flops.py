"""Operations and bytes of GenConViT from a configuration's shapes, and the
H100's published peaks (NVIDIA's data sheet, SXM part, dense, 700 W).

Operations are 2 per multiply-add of the convolutions, transposed
convolutions and matrix products: the work the model needs, whatever
kernel runs it. Elementwise ops, normalizations and pooling are not
counted. Bytes (K1 only) count each input and output once.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.reference.spec import ED_DEC, ED_ENC, VAE_DEC, VAE_ENC, vae_flat

BF16_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s
INT8_OPS = 1979e12    # dense int8 tensor-core OP/s
HBM_BYTES = 3.35e12   # bytes/s


def conv(n: int, cin: int, cout: int, k: int, hout: int, wout: int, groups: int = 1) -> float:
    return 2.0 * n * hout * wout * cout * (cin // groups) * k * k


def linear(rows: int, fin: int, fout: int) -> float:
    return 2.0 * rows * fin * fout


def convnext(cfg: dict, n: int, img: int) -> float:
    """One convnext_* forward of n images of img x img to the head."""
    dims, depths = cfg["dims"], cfg["depths"]
    h = img // 4
    total = conv(n, 3, dims[0], 4, h, h)
    for s, (c, d) in enumerate(zip(dims, depths)):
        if s:
            h //= 2
            total += conv(n, dims[s - 1], c, 2, h, h)
        rows = n * h * h
        total += d * (conv(n, c, c, 7, h, h, groups=c) + 2 * linear(rows, c, 4 * c))
    return total + linear(n, dims[-1], cfg["backbone_classes"])


def _head(cfg: dict, n: int) -> float:
    f2 = 2 * cfg["backbone_classes"]
    hid = cfg["backbone_classes"] // 2
    return linear(n, f2, hid) + linear(n, hid, cfg["num_classes"])


def ed(cfg: dict, n: int) -> float:
    img = cfg["img_size"]
    total, h = 0.0, img
    for i in range(5):
        total += conv(n, ED_ENC[i], ED_ENC[i + 1], 3, h, h)
        h //= 2
    for i in range(5):   # transposed 2x2 stride 2: each input pixel feeds 4 outputs
        total += 2.0 * n * h * h * ED_DEC[i] * ED_DEC[i + 1] * 4
        h *= 2
    return total + convnext(cfg, 2 * n, img) + _head(cfg, n)


def vae(cfg: dict, n: int, train: bool = False) -> float:
    """The original VAE's forward: encoder, the mu head (and the var head
    in training), decoder, the backbone at img and at img / 2, the head."""
    img = cfg["img_size"]
    total, h = 0.0, img
    for i in range(4):
        h //= 2
        total += conv(n, VAE_ENC[i], VAE_ENC[i + 1], 3, h, h)
    total += (2 if train else 1) * linear(n, vae_flat(cfg), cfg["latent_dims"])
    h = int(round((cfg["latent_dims"] / 256) ** 0.5))
    for i in range(4):
        total += 2.0 * n * h * h * VAE_DEC[i] * VAE_DEC[i + 1] * 4
        h *= 2
    return total + convnext(cfg, n, img) + convnext(cfg, n, h) + _head(cfg, n)


def video(cfg: dict) -> float:
    """One scored video: both branches over its frames."""
    f = cfg["num_frames"]
    return ed(cfg, f) + vae(cfg, f)


def train_image(cfg: dict) -> float:
    """One image of a VAE training step: three times the forward's
    operations (forward, and the backward's two products a layer); the
    recomputed forward is not counted."""
    return 3.0 * vae(cfg, 1, train=True)


def k1_bound_s(rows: int, c: int, post: bool) -> Tuple[float, str]:
    """The least time of one K1 launch (chip_smoke.py `mlp_bound`, bf16):
    d, x and out once in bf16, the folded weights once, the f32 vectors;
    16 R C^2 operations on the bf16 tensor cores. (seconds, what bounds it)."""
    hid = 4 * c
    nbytes = 3 * rows * c * 2 + 2 * c * hid * 2 + 4 * (2 * hid + 2 * c + (2 * c if post else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES, 16.0 * rows * c * c / BF16_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_launches(cfg: dict, frames: int) -> List[Tuple[int, int, bool]]:
    """(rows, C, post-LN) of every K1 launch of one ensemble forward over
    `frames` frames under the default plan, in launch order: the ED call
    (2 x frames at img), the VAE's x (frames at img) and x_hat (frames at
    img / 2). The last block of stages 0-2 carries the next LayerNorm."""
    img = cfg["img_size"]
    out = []
    for n, size in ((2 * frames, img), (frames, img), (frames, img // 2)):
        h = size // 4
        for s, (c, d) in enumerate(zip(cfg["dims"], cfg["depths"])):
            if s:
                h //= 2
            for b in range(d):
                out.append((n * h * h, c, b == d - 1 and s < 3))
    return out


def k1_forward_bound_s(cfg: dict, frames: int) -> float:
    return sum(k1_bound_s(*launch)[0] for launch in k1_launches(cfg, frames))
