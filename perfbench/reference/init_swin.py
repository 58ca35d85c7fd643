"""The seeded weights of GenConViT's ED branch on a Swin backbone: one state
dict, with the reference checkpoints' keys (timm 0.6.5's swin_* under
`backbone.`), made on the device from one generator in one draw of
uniforms that every leaf then transforms (`reference/init.py`'s rules), in
the dtype asked for. The port takes them as its `Predictor(params=...)`
does, the reference upcast to float32.

The Swin's rules, as `spec.convnext_leaves` sets a ConvNeXt's: weights of
std 1/sqrt(fan_in); qkv, proj and the MLP's fc1 and fc2 with the outliers
of trained weights (init.mlp_weights, 2% of them scaled by
init.outlier_gain); LayerNorm gains exp(init.ln_gain_sigma * N(0, 1)) and
biases of std 0.05; the relative-position bias tables of std
init.bias_table_std; small non-zero biases. The ED's encoder, decoder and
head as `spec.ed_leaves` makes them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.reference.init import _drawn, _transform
from perfbench.reference.spec import ED_DEC, ED_ENC, Leaf, _head, _torch_default


def swin_leaves(cfg: dict, prefix: str) -> List[Leaf]:
    """timm's swin_* keys (relative_position_index and attn_mask left out:
    buffers the models recompute)."""
    init = cfg["init"]
    out: List[Leaf] = []

    def ln(key: str, c: int) -> None:
        out.append(Leaf(f"{prefix}{key}.weight", (c,), "gain", init["ln_gain_sigma"]))
        out.append(Leaf(f"{prefix}{key}.bias", (c,), "normal", 0.05))

    def lin(key: str, cout: int, cin: int, kernel: Tuple[int, ...] = (),
            rule: str = "normal", bias: bool = True) -> None:
        fan = cin * (1 if not kernel else kernel[0] * kernel[1])
        arg = (fan ** -0.5, init["outlier_gain"]) if rule == "heavy" else fan ** -0.5
        out.append(Leaf(f"{prefix}{key}.weight", (cout, cin) + kernel, rule, arg))
        if bias:
            out.append(Leaf(f"{prefix}{key}.bias", (cout,), "normal", 0.02))

    heavy = init["mlp_weights"]
    dim, win = cfg["embed_dim"], cfg["window_size"]
    lin("patch_embed.proj", dim, 3, (4, 4))
    ln("patch_embed.norm", dim)
    last = len(cfg["depths"]) - 1
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for b in range(depth):
            q = f"layers.{s}.blocks.{b}."
            ln(q + "norm1", dim)
            lin(q + "attn.qkv", 3 * dim, dim, rule=heavy)
            out.append(Leaf(f"{prefix}{q}attn.relative_position_bias_table",
                            ((2 * win - 1) ** 2, heads), "normal", init["bias_table_std"]))
            lin(q + "attn.proj", dim, dim, rule=heavy)
            ln(q + "norm2", dim)
            lin(q + "mlp.fc1", 4 * dim, dim, rule=heavy)
            lin(q + "mlp.fc2", dim, 4 * dim, rule=heavy)
        if s < last:
            ln(f"layers.{s}.downsample.norm", 4 * dim)
            lin(f"layers.{s}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            dim *= 2
    ln("norm", dim)
    lin("head", cfg["backbone_classes"], dim)
    return out


def ed_leaves(cfg: dict) -> List[Leaf]:
    out: List[Leaf] = []
    for i in range(5):
        out += _torch_default(f"encoder.features.{3 * i}", (ED_ENC[i + 1], ED_ENC[i], 3, 3),
                              ED_ENC[i + 1], ED_ENC[i] * 9)
    for i in range(5):   # transposed convs: weight [Cin, Cout, 2, 2], fan_in Cout * 4
        out += _torch_default(f"decoder.features.{2 * i}", (ED_DEC[i], ED_DEC[i + 1], 2, 2),
                              ED_DEC[i + 1], ED_DEC[i + 1] * 4)
    return out + swin_leaves(cfg, "backbone.") + _head(cfg)


@torch.no_grad()
def make_state_dicts(cfg: dict, seed: int, device, dtype=torch.float32
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'ed': sd} of the configuration, from `seed`: every leaf takes its
    slice of one torch.rand draw on `device`, in the order of `ed_leaves`."""
    leaves = _drawn(ed_leaves(cfg))
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(math.prod(lf.shape) for lf in leaves), generator=g, device=device,
                      dtype=torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for lf in leaves:
        n = math.prod(lf.shape)
        sd[lf.key] = _transform(flat[off:off + n], lf).to(dtype).reshape(lf.shape)
        off += n
    del flat
    return {"ed": sd}
