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

Branches: 'ed', 'vae', 'convnext', 'swin' (a Swin
tree, timm's keys), 'hybrid_embed' (the {"backbone", "proj"} tree of
`init_hybrid_embed`: `backbone.*` and `proj.*`) and 'facedet' (the face
detector of models/facedet.py). A 'vae' tree is the original variant
or the updated one, told apart as the JAX package tells them apart
(`is_updated_vae`): the updated tree's decoder is a dict {"input", "convs",
"bns"}, the original's a list; a SwiGLU head shows only in fc's width
(`branch_spec`). The 'ed' and 'vae' branches never read the dead parameter groups of the reference checkpoints
(`embedder`, `hybrid_proj`, `fc3`, VAE `encoder.fc1/fc2`), so their result
loads into the port's branch modules with `load_state_dict(strict=True)`; a
converted checkpoint's embedder comes across on its own with
`state_dict_from_jax(tree["embedder"], "swin")`. Leaves may be numpy
arrays or torch tensors (the checkpoint reader's bfloat16 leaves).

`state_dict_from_reference` takes the reference's own torch checkpoints
(the published `.pth` files, `genconvit_vae_updated` ones too) to the same
state dicts, and
`tree_from_state_dict` is the bridge's inverse for 'ed', 'vae' and
'convnext' (the trees the JAX package's `convert_ed`/`convert_vae`/
`convert_convnext` give, without the dead groups).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _f32(a: Any) -> torch.Tensor:
    """A float32 tensor of a leaf (no copy of a float32 numpy array)."""
    if isinstance(a, torch.Tensor):
        return a.float()
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _t(a: Any) -> torch.Tensor:
    return _f32(a).contiguous()


def _put(sd: StateDict, name: str, p: Mapping[str, Any], weight: torch.Tensor) -> None:
    sd[f"{name}.weight"] = weight.contiguous()
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _put(sd, name, p, _f32(p["kernel"]).permute(3, 2, 0, 1))


def _convT(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _put(sd, name, p, _f32(p["kernel"]).permute(2, 3, 0, 1))


def _linear(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _put(sd, name, p, _f32(p["kernel"]).T)


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


def _facedet(sd: StateDict, tree: Mapping[str, Any]) -> None:
    _conv(sd, "stem", tree["stem"])
    for group in ("blocks16", "blocks8"):
        for i, blk in enumerate(tree[group]):
            _conv(sd, f"{group}.{i}.dw", blk["dw"])
            _conv(sd, f"{group}.{i}.pw", blk["pw"])
    _conv(sd, "head16", tree["head16"])
    _conv(sd, "head8", tree["head8"])


def state_dict_from_jax(tree: Mapping[str, Any], branch: str) -> StateDict:
    """branch: 'ed' | 'vae' (original variant) | 'convnext' | 'swin' |
    'hybrid_embed' | 'facedet'."""
    sd: StateDict = {}
    if branch == "facedet":
        _facedet(sd, tree)
        return sd
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
        dec = tree["decoder"]
        if isinstance(dec, Mapping):   # the updated variant
            _linear(sd, "decoder.decoder_input", dec["input"])
            for i, p in zip((0, 3, 6, 9), dec["convs"]):
                _convT(sd, f"decoder.features.{i}", p)
            for i, bn in zip((1, 4, 7), dec["bns"]):
                _bn(sd, f"decoder.features.{i}", bn)
        else:
            for p, i in zip(dec, (0, 2, 4, 6)):
                _convT(sd, f"decoder.features.{i}", p)
        _convnext(sd, "convnext_backbone.", tree["backbone"])
    else:
        raise ValueError(f"unknown branch {branch!r}")
    _linear(sd, "fc", tree["fc"])
    _linear(sd, "fc2", tree["fc2"])
    return sd


def branch_spec(sd: Mapping[str, Any], branch: str) -> Dict[str, str]:
    """What module a branch's state dict needs: {'head_act': 'default' or
    'swiglu'} and, for 'vae', {'variant': 'original' or 'updated'}, read
    off the weights as the JAX package dispatches on its trees: the SwiGLU
    head's fc emits twice fc2's input width (models/ed.py:95-100 there)."""
    swiglu = sd["fc.weight"].shape[0] == 2 * sd["fc2.weight"].shape[1]
    spec = {"head_act": "swiglu" if swiglu else "default"}
    if branch == "vae":
        spec["variant"] = "updated" if "decoder.decoder_input.weight" in sd else "original"
    return spec


# ------------------------------------------------------------------ reference


# The reference checkpoints' parameter groups that no forward reads
# (genconvit_tpu/core/convert.py:15-19): the Swin embedder, the HybridEmbed
# copy under the backbone's patch_embed, the VAE encoder's fc1/fc2 and fc3.
_DEAD = {"ed": re.compile(r"^(embedder\.|backbone\.patch_embed\.)"),
         "vae": re.compile(r"^(embedder\.|convnext_backbone\.patch_embed\.|"
                           r"encoder\.fc[12]\.|fc3\.)")}


def state_dict_from_reference(obj: Mapping[str, Any], branch: str) -> StateDict:
    """A reference-keyed torch checkpoint (bare, or nested under
    'state_dict' as train.py saves it) -> the port's state dict for branch
    'ed' or 'vae' (either variant: `branch_spec` tells them apart): float16
    tensors to float32, the dead groups dropped, so that it loads with
    `load_state_dict(strict=True)` (the JAX package's `convert_checkpoint`
    accepts the same files)."""
    if branch not in _DEAD:
        raise ValueError(f"unknown branch {branch!r}")
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    sd: StateDict = {}
    for k, v in obj.items():
        if _DEAD[branch].match(k):
            continue
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        sd[k] = v.float() if v.dtype == torch.float16 else v
    return sd


# ------------------------------------------------------------------ inverse


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def _with_bias(sd: Mapping[str, torch.Tensor], name: str, kernel: torch.Tensor) -> Dict[str, Any]:
    out = {"kernel": _np(kernel)}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _conv_tree(sd, name):
    return _with_bias(sd, name, sd[f"{name}.weight"].permute(2, 3, 1, 0))


def _convT_tree(sd, name):
    return _with_bias(sd, name, sd[f"{name}.weight"].permute(2, 3, 0, 1))


def _linear_tree(sd, name):
    return _with_bias(sd, name, sd[f"{name}.weight"].T)


def _norm_tree(sd, name):
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def _bn_tree(sd, name):
    return dict(_norm_tree(sd, name), mean=_np(sd[f"{name}.running_mean"]),
                var=_np(sd[f"{name}.running_var"]))


def _count(sd: Mapping[str, Any], pattern: str) -> int:
    rx = re.compile(pattern)
    return len({m.group(1) for k in sd for m in [rx.match(k)] if m})


def _convnext_tree(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {
        "stem": {"conv": _conv_tree(sd, f"{prefix}stem.0"),
                 "norm": _norm_tree(sd, f"{prefix}stem.1")},
        "stages": [],
        "head": {"norm": _norm_tree(sd, f"{prefix}head.norm"),
                 "fc": _linear_tree(sd, f"{prefix}head.fc")}}
    p = re.escape(prefix)
    for si in range(_count(sd, rf"{p}stages\.(\d+)\.")):
        s = f"{prefix}stages.{si}"
        stage: Dict[str, Any] = {"blocks": []}
        if f"{s}.downsample.0.weight" in sd:
            stage["downsample"] = {"norm": _norm_tree(sd, f"{s}.downsample.0"),
                                   "conv": _conv_tree(sd, f"{s}.downsample.1")}
        for bi in range(_count(sd, rf"{p}stages\.{si}\.blocks\.(\d+)\.")):
            b = f"{s}.blocks.{bi}"
            stage["blocks"].append({
                "conv_dw": _conv_tree(sd, f"{b}.conv_dw"),
                "norm": _norm_tree(sd, f"{b}.norm"),
                "mlp": {"fc1": _linear_tree(sd, f"{b}.mlp.fc1"),
                        "fc2": _linear_tree(sd, f"{b}.mlp.fc2")},
                "gamma": _np(sd[f"{b}.gamma"])})
        tree["stages"].append(stage)
    return tree


def tree_from_state_dict(sd: Mapping[str, torch.Tensor], branch: str) -> Dict[str, Any]:
    """The inverse of `state_dict_from_jax` for 'ed', 'vae' (either variant)
    and 'convnext': the JAX package's tree (float32 numpy leaves), e.g. to
    write a `.gcv` that both packages read."""
    if branch == "convnext":
        return _convnext_tree(sd, "")
    if branch == "ed":
        tree = {"encoder": [_conv_tree(sd, f"encoder.features.{i}") for i in (0, 3, 6, 9, 12)],
                "decoder": [_convT_tree(sd, f"decoder.features.{i}") for i in (0, 2, 4, 6, 8)],
                "backbone": _convnext_tree(sd, "backbone.")}
    elif branch == "vae":
        if "decoder.decoder_input.weight" in sd:   # the updated variant
            decoder: Any = {
                "input": _linear_tree(sd, "decoder.decoder_input"),
                "convs": [_convT_tree(sd, f"decoder.features.{i}") for i in (0, 3, 6, 9)],
                "bns": [_bn_tree(sd, f"decoder.features.{i}") for i in (1, 4, 7)]}
        else:
            decoder = [_convT_tree(sd, f"decoder.features.{i}") for i in (0, 2, 4, 6)]
        tree = {"encoder": {"convs": [_conv_tree(sd, f"encoder.features.{i}") for i in (0, 3, 6, 9)],
                            "bns": [_bn_tree(sd, f"encoder.features.{i}") for i in (1, 4, 7, 10)],
                            "mu": _linear_tree(sd, "encoder.mu"),
                            "var": _linear_tree(sd, "encoder.var")},
                "decoder": decoder,
                "backbone": _convnext_tree(sd, "convnext_backbone.")}
    else:
        raise ValueError(f"unknown branch {branch!r}")
    tree["fc"] = _linear_tree(sd, "fc")
    tree["fc2"] = _linear_tree(sd, "fc2")
    return tree
