"""The parameters of GenConViT's ED and original-VAE branches, by the
reference checkpoints' keys (erprogs/GenConViT model/genconvit_ed.py,
model/genconvit_vae.py; the backbone keys are timm 0.6.5's convnext_*),
with the shape and the init rule of each.

A configuration is the dict of a `perfbench/configs/<name>.json` file:
`dims`, `depths`, `img_size`, `latent_dims`, `backbone_classes`,
`num_classes`, and the `init` block (`logit_scale`, `layer_scale`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

ED_ENC = (3, 16, 32, 64, 128, 256)
ED_DEC = (256, 128, 64, 32, 16, 3)
VAE_ENC = (3, 16, 32, 64, 128)
VAE_DEC = (256, 64, 32, 16, 3)


class Leaf(NamedTuple):
    key: str
    shape: Tuple[int, ...]
    rule: str        # 'normal' (std = arg, cut at 2 std) | 'heavy' ((std, outlier gain) = arg)
    #                  | 'gain' (exp(arg * N(0, 1))) | 'uniform' (+-arg) | 'range' (U(arg))
    #                  | 'const' (arg) | 'count' (int64 zero)
    arg: object


def _fan_std(fan_in: int) -> float:
    return fan_in ** -0.5


def convnext_leaves(cfg: dict, prefix: str) -> List[Leaf]:
    """timm's convnext keys. Weights of std 1/sqrt(fan_in), so that every
    block's MLP branch is a sizable part of its output; the blocks' MLP
    weights with the outliers of trained weights ('heavy'), LayerNorm gains
    log-normal (init.ln_gain_sigma), as trained networks have them; small
    non-zero biases; layer scale U(init.layer_scale)."""
    dims, depths = cfg["dims"], cfg["depths"]
    init = cfg["init"]
    lo, hi = init["layer_scale"]
    out: List[Leaf] = []

    def ln(key: str, c: int) -> None:
        out.append(Leaf(f"{prefix}{key}.weight", (c,), "gain", init["ln_gain_sigma"]))
        out.append(Leaf(f"{prefix}{key}.bias", (c,), "normal", 0.05))

    def lin(key: str, cout: int, cin: int, kernel: Tuple[int, ...] = (),
            rule: str = "normal") -> None:
        fan = cin * (1 if not kernel else kernel[0] * kernel[1])
        arg = (_fan_std(fan), init["outlier_gain"]) if rule == "heavy" else _fan_std(fan)
        out.append(Leaf(f"{prefix}{key}.weight", (cout, cin) + kernel, rule, arg))
        out.append(Leaf(f"{prefix}{key}.bias", (cout,), "normal", 0.02))

    lin("stem.0", dims[0], 3, (4, 4))
    ln("stem.1", dims[0])
    for s, (c, d) in enumerate(zip(dims, depths)):
        if s:
            ln(f"stages.{s}.downsample.0", dims[s - 1])
            lin(f"stages.{s}.downsample.1", c, dims[s - 1], (2, 2))
        for b in range(d):
            q = f"stages.{s}.blocks.{b}."
            out.append(Leaf(f"{prefix}{q}gamma", (c,), "range", (lo, hi)))
            out.append(Leaf(f"{prefix}{q}conv_dw.weight", (c, 1, 7, 7), "normal", 1 / 7))
            out.append(Leaf(f"{prefix}{q}conv_dw.bias", (c,), "normal", 0.02))
            ln(q + "norm", c)
            lin(q + "mlp.fc1", 4 * c, c, rule=init["mlp_weights"])
            lin(q + "mlp.fc2", c, 4 * c, rule=init["mlp_weights"])
    ln("head.norm", dims[-1])
    lin("head.fc", cfg["backbone_classes"], dims[-1])
    return out


def _torch_default(key: str, shape: Tuple[int, ...], cout: int, fan_in: int) -> List[Leaf]:
    """torch's Linear / Conv default: U(+-1/sqrt(fan_in)) for weight and bias."""
    b = fan_in ** -0.5
    return [Leaf(f"{key}.weight", shape, "uniform", b), Leaf(f"{key}.bias", (cout,), "uniform", b)]


def _head(cfg: dict) -> List[Leaf]:
    """fc (2F -> F/4) and fc2 (F/4 -> classes), the latter scaled by
    logit_scale so that the verdicts spread over (0, 1)."""
    f2 = 2 * cfg["backbone_classes"]
    hid = cfg["backbone_classes"] // 2
    s = cfg["init"]["logit_scale"]
    return ([Leaf("fc.weight", (hid, f2), "uniform", f2 ** -0.5),
             Leaf("fc.bias", (hid,), "uniform", f2 ** -0.5)] +
            [Leaf("fc2.weight", (cfg["num_classes"], hid), "uniform", s * hid ** -0.5),
             Leaf("fc2.bias", (cfg["num_classes"],), "uniform", s * hid ** -0.5)])


def ed_leaves(cfg: dict) -> List[Leaf]:
    out: List[Leaf] = []
    for i in range(5):
        out += _torch_default(f"encoder.features.{3 * i}", (ED_ENC[i + 1], ED_ENC[i], 3, 3),
                              ED_ENC[i + 1], ED_ENC[i] * 9)
    for i in range(5):   # transposed convs: weight [Cin, Cout, 2, 2], fan_in Cout * 4
        out += _torch_default(f"decoder.features.{2 * i}", (ED_DEC[i], ED_DEC[i + 1], 2, 2),
                              ED_DEC[i + 1], ED_DEC[i + 1] * 4)
    return out + convnext_leaves(cfg, "backbone.") + _head(cfg)


def vae_flat(cfg: dict) -> int:
    return 128 * (cfg["img_size"] // 16) ** 2


def vae_leaves(cfg: dict) -> List[Leaf]:
    out: List[Leaf] = []
    for i in range(4):
        out += _torch_default(f"encoder.features.{3 * i}", (VAE_ENC[i + 1], VAE_ENC[i], 3, 3),
                              VAE_ENC[i + 1], VAE_ENC[i] * 9)
        bn, c = f"encoder.features.{3 * i + 1}", VAE_ENC[i + 1]
        out += [Leaf(f"{bn}.weight", (c,), "range", (0.75, 1.25)),
                Leaf(f"{bn}.bias", (c,), "normal", 0.05),
                Leaf(f"{bn}.running_mean", (c,), "const", 0.0),
                Leaf(f"{bn}.running_var", (c,), "const", 1.0),
                Leaf(f"{bn}.num_batches_tracked", (), "count", 0)]
    flat, latent = vae_flat(cfg), cfg["latent_dims"]
    for head in ("mu", "var"):
        out += [Leaf(f"encoder.{head}.weight", (latent, flat), "uniform", flat ** -0.5),
                Leaf(f"encoder.{head}.bias", (latent,), "uniform", flat ** -0.5)]
    for i in range(4):
        out += _torch_default(f"decoder.features.{2 * i}", (VAE_DEC[i], VAE_DEC[i + 1], 2, 2),
                              VAE_DEC[i + 1], VAE_DEC[i + 1] * 4)
    return out + convnext_leaves(cfg, "convnext_backbone.") + _head(cfg)


def branch_leaves(cfg: dict) -> Dict[str, List[Leaf]]:
    return {"ed": ed_leaves(cfg), "vae": vae_leaves(cfg)}
