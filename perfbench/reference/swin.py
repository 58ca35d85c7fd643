"""GenConViT's ED branch on a Swin backbone in plain float32 PyTorch, over
state dicts with the reference checkpoints' keys: the ED's encoder, decoder
and head (erprogs/GenConViT model/genconvit_ed.py, pred_func.py) around
timm 0.6.5's `swin_*_patch4_window7_224` under `backbone.` (Liu et al.,
arXiv 2103.14030), the backbone `timm.create_model` builds when
config.yaml's model.backbone names the Swin.

The Swin forward: a 4x4/4 patch convolution and LayerNorm; per stage its
blocks, each x + W-MSA(LN1(x)) then x + MLP(LN2(x)), the attention over
window x window windows with a relative-position bias gathered from each
block's table, every other block in windows cyclically shifted by half a
window under the shifted-window mask (-100 between regions), none where the
grid is no larger than the window (timm clamps the window to the grid);
patch merging (2x2 neighbours concatenated, LayerNorm, a linear map to 2C)
between stages; the final LayerNorm, the mean over tokens and the head:
the 1000 logits the ED concatenates for the reconstruction and for the
original. LayerNorm eps 1e-5; exact-erf GELU, as torch.nn.GELU. The index
and the mask are computed here, as timm computes them, never read.

Departures from the published code, each one of form only: the modules
are functions over the state dict; the head's width is read off its
weight, where the reference reads `backbone.head.fc.out_features`, which a
timm 0.6.5 Swin's plain Linear head lacks (model/genconvit_ed.py:72).

`Operands("fp8")` (perfbench/reference/model.py) takes every product's
operands in float8, the attention's two products included: the comparison's
control.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.model import EXACT, Operands, Tensors, _head, normalize

LN_EPS = 1e-5


def relative_position_index(window: int, device) -> torch.Tensor:
    """[L, L] int64 index into the (2w - 1)^2-row bias table (timm's
    WindowAttention)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).to(device)


def shift_mask(h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
    """[nW, L, L] float32: 0 within a region of the rolled grid, -100
    across regions (timm's SwinTransformerBlock attn_mask)."""
    img = torch.zeros(h, w)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.view(h // window, window, w // window, window).permute(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(device)


def _ln(x: torch.Tensor, sd: Tensors, key: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), sd[key + ".weight"], sd[key + ".bias"], LN_EPS)


def _attention(sd: Tensors, q: str, x: torch.Tensor, heads: int, window: int,
               mask, op: Operands) -> torch.Tensor:
    """W-MSA on windows x [B, L, C] (timm WindowAttention.forward)."""
    b, l, c = x.shape
    hd = c // heads
    qkv = op.linear(x, sd[q + "attn.qkv.weight"], sd[q + "attn.qkv.bias"])
    qh, kh, vh = qkv.view(b, l, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    attn = op(qh * hd ** -0.5) @ op(kh).transpose(-2, -1)
    table = sd[q + "attn.relative_position_bias_table"]
    idx = relative_position_index(window, x.device).reshape(-1)
    attn = attn + table[idx].view(l, l, heads).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b // nw, nw, heads, l, l) + mask[None, :, None]).view(b, heads, l, l)
    out = op(attn.softmax(dim=-1)) @ op(vh)
    out = out.transpose(1, 2).reshape(b, l, c)
    return op.linear(out, sd[q + "attn.proj.weight"], sd[q + "attn.proj.bias"])


def _block(sd: Tensors, q: str, x: torch.Tensor, hw: Tuple[int, int], heads: int,
           window: int, shift: int, op: Operands) -> torch.Tensor:
    h, w = hw
    n, _, c = x.shape
    y = _ln(x, sd, q + "norm1").view(n, h, w, c)
    mask = None
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = shift_mask(h, w, window, shift, x.device)
    y = y.view(n, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    y = _attention(sd, q, y.reshape(-1, window * window, c), heads, window, mask, op)
    y = y.view(n, h // window, w // window, window, window, c).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, h, w, c)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = x + y.reshape(n, h * w, c)
    z = F.gelu(op.linear(_ln(x, sd, q + "norm2"), sd[q + "mlp.fc1.weight"],
                         sd[q + "mlp.fc1.bias"]))
    return x + op.linear(z, sd[q + "mlp.fc2.weight"], sd[q + "mlp.fc2.bias"])


def _merge(sd: Tensors, key: str, x: torch.Tensor, hw: Tuple[int, int], op: Operands):
    h, w = hw
    n, _, c = x.shape
    x = x.view(n, h, w, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1).reshape(n, (h // 2) * (w // 2), 4 * c)
    x = _ln(x, sd, key + ".norm")
    return op.linear(x, sd[key + ".reduction.weight"], None), (h // 2, w // 2)


def swin_features(sd: Tensors, p: str, x: torch.Tensor, cfg: dict,
                  op: Operands = EXACT) -> torch.Tensor:
    """[N, 3, S, S] -> the final tokens [N, L, C] after the final LayerNorm."""
    x = op.conv2d(x, sd[p + "patch_embed.proj.weight"], sd[p + "patch_embed.proj.bias"],
                  stride=4)
    n, c, h, w = x.shape
    x = _ln(x.flatten(2).transpose(1, 2), sd, p + "patch_embed.norm")
    hw = (h, w)
    last = len(cfg["depths"]) - 1
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        window = min(cfg["window_size"], min(hw))
        for b in range(depth):
            shift = 0 if b % 2 == 0 or min(hw) <= cfg["window_size"] else window // 2
            x = _block(sd, f"{p}layers.{s}.blocks.{b}.", x, hw, heads, window, shift, op)
        if s < last:
            x, hw = _merge(sd, f"{p}layers.{s}.downsample", x, hw, op)
    return _ln(x, sd, p + "norm")


def swin_logits(sd: Tensors, p: str, x: torch.Tensor, cfg: dict,
                op: Operands = EXACT) -> torch.Tensor:
    """The Swin's head logits [N, classes]: the mean token, then the head."""
    return op.linear(swin_features(sd, p, x, cfg, op).mean(dim=1), sd[p + "head.weight"],
                     sd[p + "head.bias"])


def ed_logits(sd: Tensors, x: torch.Tensor, cfg: dict, op: Operands = EXACT) -> torch.Tensor:
    """The ED branch (model/genconvit_ed.py) on the Swin: encoder, decoder,
    the backbone on [x_hat, x], GELU -> fc -> GELU -> fc2."""
    h = x
    for i in range(5):
        k = f"encoder.features.{3 * i}"
        h = F.max_pool2d(F.relu(op.conv2d(h, sd[k + ".weight"], sd[k + ".bias"], padding=1)),
                         2, 2)
    for i in range(5):
        k = f"decoder.features.{2 * i}"
        h = F.relu(op.conv_transpose2d(h, sd[k + ".weight"], sd[k + ".bias"], stride=2))
    n = x.shape[0]
    feats = swin_logits(sd, "backbone.", torch.cat([h, x]), cfg, op)
    return _head(sd, F.gelu(torch.cat([feats[:n], feats[n:]], dim=1)), F.gelu, op)


@torch.no_grad()
def video_means(sds: Dict[str, Tensors], frames_u8: torch.Tensor, mask: torch.Tensor,
                cfg: dict, chunk: int = 2, op: Operands = EXACT) -> torch.Tensor:
    """The ED branch's per-video masked sigmoid means [V, 2] (pred_func.py
    under --net ed): frames_u8 [V,F,S,S,3] uint8, mask [V,F]; `chunk`
    videos at a time, so that float32 activations fit."""
    v, f = frames_u8.shape[:2]
    out = []
    for a in range(0, v, chunk):
        b = min(v, a + chunk)
        x = normalize(frames_u8[a:b].reshape((-1,) + frames_u8.shape[2:]))
        logits = ed_logits(sds["ed"], x, cfg, op).reshape(b - a, f, 2)
        m = mask[a:b].float()
        probs = torch.sigmoid(logits) * m[..., None]
        out.append(probs.sum(1) / m.sum(1).clamp(min=1.0)[:, None])
    return torch.cat(out)
