"""GenConViT's scoring forward in plain float32 PyTorch, over state dicts
with the reference checkpoints' keys (erprogs/GenConViT: model/genconvit.py,
genconvit_ed.py, genconvit_vae.py, pred_func.py; timm 0.6.5's convnext).

Departures from the published code, each one of form only: the modules
are functions over the state dict; exact-erf GELU as torch.nn.GELU; the
VAE keeps the reference's quirk z = mu + eps * exp(0.5 * mu) (its eval
forward samples too) and takes eps from the caller; the decoder's 112 px
output feeds the backbone as the reference feeds it.

`Operands("fp8")` takes every product's operands in float8: the reference
in the nearest precision below bfloat16, the comparison's control.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6
BN_EPS = 1e-5


class Operands:
    """How the products take their operands: as they are (float32), or
    rounded to float8 e4m3 with one scale a tensor (`Operands("fp8")`: the
    nearest precision below bfloat16, for the comparison's control), the
    products accumulating in float32 either way."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"operands {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return t
        scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def conv2d(self, x, w, b, **kw):
        return F.conv2d(self(x), self(w), b, **kw)

    def conv_transpose2d(self, x, w, b, **kw):
        return F.conv_transpose2d(self(x), self(w), b, **kw)

    def linear(self, x, w, b):
        return F.linear(self(x), self(w), b)


EXACT = Operands()
FP8_MAX = 448.0   # the largest finite float8 e4m3


def exact_float32() -> None:
    """Matrix products and convolutions in IEEE float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [N,H,W,3] -> ImageNet-normalized float32 [N,3,H,W]."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames_u8.device)
    std = torch.tensor(IMAGENET_STD, device=frames_u8.device)
    x = (frames_u8.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def _ln_channels(x: torch.Tensor, sd: Tensors, key: str) -> torch.Tensor:
    """timm's LayerNorm2d: over C of NCHW."""
    h = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), sd[key + ".weight"],
                     sd[key + ".bias"], LN_EPS)
    return h.permute(0, 3, 1, 2)


def convnext(sd: Tensors, p: str, x: torch.Tensor, depths,
             op: Operands = EXACT) -> torch.Tensor:
    """timm convnext_* forward to the head's logits [N, classes]."""
    x = op.conv2d(x, sd[p + "stem.0.weight"], sd[p + "stem.0.bias"], stride=4)
    x = _ln_channels(x, sd, p + "stem.1")
    for s, depth in enumerate(depths):
        if s:
            x = _ln_channels(x, sd, f"{p}stages.{s}.downsample.0")
            x = op.conv2d(x, sd[f"{p}stages.{s}.downsample.1.weight"],
                          sd[f"{p}stages.{s}.downsample.1.bias"], stride=2)
        for b in range(depth):
            q = f"{p}stages.{s}.blocks.{b}."
            c = x.shape[1]
            h = op.conv2d(x, sd[q + "conv_dw.weight"], sd[q + "conv_dw.bias"], padding=3,
                          groups=c)
            h = h.permute(0, 2, 3, 1)
            h = F.layer_norm(h, (c,), sd[q + "norm.weight"], sd[q + "norm.bias"], LN_EPS)
            h = F.gelu(op.linear(h, sd[q + "mlp.fc1.weight"], sd[q + "mlp.fc1.bias"]))
            h = op.linear(h, sd[q + "mlp.fc2.weight"], sd[q + "mlp.fc2.bias"])
            x = x + (h * sd[q + "gamma"]).permute(0, 3, 1, 2)
    x = x.mean(dim=(2, 3))
    x = F.layer_norm(x, (x.shape[1],), sd[p + "head.norm.weight"], sd[p + "head.norm.bias"],
                     LN_EPS)
    return op.linear(x, sd[p + "head.fc.weight"], sd[p + "head.fc.bias"])


def _head(sd: Tensors, h: torch.Tensor, act, op: Operands = EXACT) -> torch.Tensor:
    h = act(op.linear(h, sd["fc.weight"], sd["fc.bias"]))
    return op.linear(h, sd["fc2.weight"], sd["fc2.bias"])


def ed_logits(sd: Tensors, x: torch.Tensor, cfg: dict, op: Operands = EXACT) -> torch.Tensor:
    """The ED branch (model/genconvit_ed.py): encoder, decoder, the
    backbone on [x_hat, x], GELU -> fc -> GELU -> fc2."""
    h = x
    for i in range(5):
        k = f"encoder.features.{3 * i}"
        h = F.max_pool2d(F.relu(op.conv2d(h, sd[k + ".weight"], sd[k + ".bias"], padding=1)),
                         2, 2)
    for i in range(5):
        k = f"decoder.features.{2 * i}"
        h = F.relu(op.conv_transpose2d(h, sd[k + ".weight"], sd[k + ".bias"], stride=2))
    n = x.shape[0]
    feats = convnext(sd, "backbone.", torch.cat([h, x]), cfg["depths"], op)
    return _head(sd, F.gelu(torch.cat([feats[:n], feats[n:]], dim=1)), F.gelu, op)


def vae_encoder(sd: Tensors, x: torch.Tensor, train: bool = False, op: Operands = EXACT):
    """The VAE encoder to its flat features; in training BatchNorm takes the
    batch's statistics and the new running ones are returned too."""
    stats = []
    h = x
    for i in range(4):
        k, bn = f"encoder.features.{3 * i}", f"encoder.features.{3 * i + 1}"
        h = op.conv2d(h, sd[k + ".weight"], sd[k + ".bias"], stride=2, padding=1)
        if train:
            mean = h.mean(dim=(0, 2, 3))
            var = h.var(dim=(0, 2, 3), unbiased=False)
            n = h.shape[0] * h.shape[2] * h.shape[3]
            with torch.no_grad():
                stats.append((0.9 * sd[bn + ".running_mean"] + 0.1 * mean,
                              0.9 * sd[bn + ".running_var"] + 0.1 * var * (n / (n - 1))))
        else:
            mean, var = sd[bn + ".running_mean"], sd[bn + ".running_var"]
        h = (h - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + BN_EPS)
        h = F.leaky_relu(h * sd[bn + ".weight"][:, None, None] + sd[bn + ".bias"][:, None, None],
                         0.01)
    return h.flatten(1), stats


def vae_decoder(sd: Tensors, z: torch.Tensor, op: Operands = EXACT) -> torch.Tensor:
    s = int(round((z.shape[1] / 256) ** 0.5))
    h = z.reshape(z.shape[0], 256, s, s)
    for i in range(4):
        k = f"decoder.features.{2 * i}"
        h = F.leaky_relu(op.conv_transpose2d(h, sd[k + ".weight"], sd[k + ".bias"], stride=2),
                         0.01)
    return h


def vae_tail(sd: Tensors, x: torch.Tensor, z: torch.Tensor, cfg: dict, op: Operands = EXACT
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder, the backbone on x and on x_hat, ReLU -> fc -> ReLU -> fc2:
    (logits, x_hat)."""
    x_hat = vae_decoder(sd, z, op)
    f1 = convnext(sd, "convnext_backbone.", x, cfg["depths"], op)
    f2 = convnext(sd, "convnext_backbone.", x_hat, cfg["depths"], op)
    return _head(sd, F.relu(torch.cat([f1, f2], dim=1)), F.relu, op), x_hat


def sample_z(mu: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
    """The original VAE's z (quirk: std = exp(0.5 * mu)); mu without eps."""
    return mu if eps is None else mu + eps * torch.exp(0.5 * mu)


def vae_logits(sd: Tensors, x: torch.Tensor, cfg: dict, eps: Optional[torch.Tensor],
               op: Operands = EXACT) -> torch.Tensor:
    flat, _ = vae_encoder(sd, x, op=op)
    mu = op.linear(flat, sd["encoder.mu.weight"], sd["encoder.mu.bias"])
    return vae_tail(sd, x, sample_z(mu, eps), cfg, op)[0]


@torch.no_grad()
def video_means(sds: Dict[str, Tensors], frames_u8: torch.Tensor, mask: torch.Tensor,
                cfg: dict, eps: Optional[torch.Tensor] = None, chunk: int = 2,
                op: Operands = EXACT) -> torch.Tensor:
    """The ensemble's per-video masked sigmoid means [V, 2] (pred_func.py):
    frames_u8 [V,F,S,S,3] uint8, mask [V,F], eps [V*F, latent] or None (z =
    mu). ED rows then VAE rows share the mask. Runs `chunk` videos at a
    time, so that float32 activations fit."""
    v, f = frames_u8.shape[:2]
    out = []
    for a in range(0, v, chunk):
        b = min(v, a + chunk)
        x = normalize(frames_u8[a:b].reshape((-1,) + frames_u8.shape[2:]))
        e = None if eps is None else eps[a * f:b * f]
        logits = torch.cat([ed_logits(sds["ed"], x, cfg, op).reshape(b - a, f, 2),
                            vae_logits(sds["vae"], x, cfg, e, op).reshape(b - a, f, 2)], dim=1)
        m = torch.cat([mask[a:b], mask[a:b]], dim=1).float()
        probs = torch.sigmoid(logits) * m[..., None]
        out.append(probs.sum(1) / m.sum(1).clamp(min=1.0)[:, None])
    return torch.cat(out)
