"""Weight bridge: the JAX package's parameter tree (numpy leaves) -> the
port's reference-keyed state_dict.

The inverse of genconvit_tpu/core/convert.py `_conv`/`_convT`/`_linear`/
`_norm`/`_bn` (:70-99) and of `convert_convnext`/`convert_swin`/`convert_ed`/
`convert_vae` (:158-281):

  conv   HWIO -> OIHW                  transpose(3, 2, 0, 1)
         (depthwise (7,7,1,C) -> (C,1,7,7) is the same map)
  convT  (kH,kW,Cin,Cout) -> (Cin,Cout,kH,kW)   transpose(2, 3, 0, 1)
  linear (in, out) -> (out, in)
  LN/BN  scale/bias(/mean/var) -> weight/bias(/running_mean/running_var)

Branches: 'ed', 'vae' (the original variant), 'convnext', 'swin' (a Swin
tree, timm's keys) and 'hybrid_embed' (the {"backbone", "proj"} tree of
`init_hybrid_embed`: `backbone.*` and `proj.*`). The 'ed' and 'vae' branches
never read the dead parameter groups of the reference checkpoints
(`embedder`, `hybrid_proj`, `fc3`, VAE `encoder.fc1/fc2`), so their result
loads into the port's branch modules with `load_state_dict(strict=True)`; a
converted checkpoint's embedder comes across on its own with
`state_dict_from_jax(tree["embedder"], "swin")`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _put(sd: StateDict, name: str, p: Mapping[str, Any], weight: np.ndarray) -> None:
    sd[f"{name}.weight"] = _t(weight)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _put(sd, name, p, np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _convT(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _put(sd, name, p, np.asarray(p["kernel"]).transpose(2, 3, 0, 1))


def _linear(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _put(sd, name, p, np.asarray(p["kernel"]).T)


def _norm(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _norm(sd, name, p)
    sd[f"{name}.running_mean"] = _t(p["mean"])
    sd[f"{name}.running_var"] = _t(p["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _convnext(sd: StateDict, prefix: str, tree: Mapping[str, Any]) -> None:
    _conv(sd, f"{prefix}stem.0", tree["stem"]["conv"])
    _norm(sd, f"{prefix}stem.1", tree["stem"]["norm"])
    for si, stage in enumerate(tree["stages"]):
        s = f"{prefix}stages.{si}"
        if "downsample" in stage:
            _norm(sd, f"{s}.downsample.0", stage["downsample"]["norm"])
            _conv(sd, f"{s}.downsample.1", stage["downsample"]["conv"])
        for bi, blk in enumerate(stage["blocks"]):
            b = f"{s}.blocks.{bi}"
            _conv(sd, f"{b}.conv_dw", blk["conv_dw"])
            _norm(sd, f"{b}.norm", blk["norm"])
            _linear(sd, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
            sd[f"{b}.gamma"] = _t(blk["gamma"])
    _norm(sd, f"{prefix}head.norm", tree["head"]["norm"])
    _linear(sd, f"{prefix}head.fc", tree["head"]["fc"])


def _swin(sd: StateDict, prefix: str, tree: Mapping[str, Any]) -> None:
    _conv(sd, f"{prefix}patch_embed.proj", tree["patch_embed"]["proj"])
    _norm(sd, f"{prefix}patch_embed.norm", tree["patch_embed"]["norm"])
    for li, layer in enumerate(tree["layers"]):
        s = f"{prefix}layers.{li}"
        for bi, blk in enumerate(layer["blocks"]):
            b = f"{s}.blocks.{bi}"
            _norm(sd, f"{b}.norm1", blk["norm1"])
            _linear(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
            _linear(sd, f"{b}.attn.proj", blk["attn"]["proj"])
            sd[f"{b}.attn.relative_position_bias_table"] = _t(
                blk["attn"]["relative_position_bias_table"])
            _norm(sd, f"{b}.norm2", blk["norm2"])
            _linear(sd, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
        if "downsample" in layer:
            _norm(sd, f"{s}.downsample.norm", layer["downsample"]["norm"])
            _linear(sd, f"{s}.downsample.reduction", layer["downsample"]["reduction"])
    _norm(sd, f"{prefix}norm", tree["norm"])
    _linear(sd, f"{prefix}head", tree["head"])


def state_dict_from_jax(tree: Mapping[str, Any], branch: str) -> StateDict:
    """branch: 'ed' | 'vae' (original variant) | 'convnext' | 'swin' |
    'hybrid_embed'."""
    sd: StateDict = {}
    if branch == "convnext":
        _convnext(sd, "", tree)
        return sd
    if branch == "swin":
        _swin(sd, "", tree)
        return sd
    if branch == "hybrid_embed":
        _swin(sd, "backbone.", tree["backbone"])
        _conv(sd, "proj", tree["proj"])
        return sd
    if branch == "ed":
        for p, i in zip(tree["encoder"], (0, 3, 6, 9, 12)):
            _conv(sd, f"encoder.features.{i}", p)
        for p, i in zip(tree["decoder"], (0, 2, 4, 6, 8)):
            _convT(sd, f"decoder.features.{i}", p)
        _convnext(sd, "backbone.", tree["backbone"])
    elif branch == "vae":
        enc = tree["encoder"]
        for conv, bn, i in zip(enc["convs"], enc["bns"], (0, 3, 6, 9)):
            _conv(sd, f"encoder.features.{i}", conv)
            _bn(sd, f"encoder.features.{i + 1}", bn)
        _linear(sd, "encoder.mu", enc["mu"])
        _linear(sd, "encoder.var", enc["var"])
        for p, i in zip(tree["decoder"], (0, 2, 4, 6)):
            _convT(sd, f"decoder.features.{i}", p)
        _convnext(sd, "convnext_backbone.", tree["backbone"])
    else:
        raise ValueError(f"unknown branch {branch!r}")
    _linear(sd, "fc", tree["fc"])
    _linear(sd, "fc2", tree["fc2"])
    return sd
