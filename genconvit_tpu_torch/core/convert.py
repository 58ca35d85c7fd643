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

An 'ed' branch may hold a Swin backbone (the reference's ED on a
config.yaml that names one): timm's keys under `backbone.` (`backbone.layers.*`,
`backbone.patch_embed.*`, `backbone.head`), a Swin tree under "backbone"
(one with "layers"). There `backbone.patch_embed.` is the Swin's own
patch embedding, read and kept; timm's relative_position_index and
attn_mask buffers are dropped, as the model recomputes them.

`state_dict_from_reference` takes the reference's own torch checkpoints
(the published `.pth` files, `genconvit_vae_updated` ones too) to the same
state dicts, and
`tree_from_state_dict` is the bridge's inverse for 'ed', 'vae', 'convnext',
'swin' and 'facedet' (the trees the JAX package's `convert_ed`/
`convert_vae`/`convert_convnext`/`convert_swin` give, without the dead
groups). `tree_from_reference` is the JAX package's `convert_checkpoint`:
a reference checkpoint to the JAX tree, the dead groups carried or
dropped, with strict key accounting; `preflight_manifest` runs it on a
manifest of shapes (meta tensors: nothing is materialized).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple

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
        (_swin if "layers" in tree["backbone"] else _convnext)(sd, "backbone.", tree["backbone"])
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
# ... and of an ED on a Swin backbone, whose patch_embed is its own: the
# embedder, and timm's buffers, which the model recomputes
_DEAD_SWIN_ED = re.compile(r"^embedder\.|^backbone\..*(relative_position_index|attn_mask)$")


def swin_backbone(sd: Mapping[str, Any]) -> bool:
    """Whether an 'ed' state dict holds a Swin backbone (timm's
    `backbone.layers.*`) rather than a ConvNeXt."""
    return any(k.startswith("backbone.layers.") for k in sd)


def _dead(sd: Mapping[str, Any], branch: str):
    return _DEAD_SWIN_ED if branch == "ed" and swin_backbone(sd) else _DEAD[branch]


def unwrap_state_dict(obj: Any) -> Mapping[str, Any]:
    """A bare state dict, or the one nested under 'state_dict' (the
    reference's {'state_dict': ...} files and train.py's {'epoch',
    'state_dict', 'optimizer', 'min_loss'} saves)."""
    if isinstance(obj, Mapping) and "state_dict" in obj:
        return obj["state_dict"]
    return obj


def detect_branch(sd: Mapping[str, Any]) -> str:
    """'ed' | 'vae' | 'vae_updated' from the key signature."""
    if "decoder.decoder_input.weight" in sd:
        return "vae_updated"
    if any(k.startswith("convnext_backbone.") for k in sd):
        return "vae"
    return "ed"


def state_dict_from_reference(obj: Mapping[str, Any], branch: str) -> StateDict:
    """A reference-keyed torch checkpoint (bare, or nested under
    'state_dict' as train.py saves it) -> the port's state dict for branch
    'ed' or 'vae' (either variant: `branch_spec` tells them apart): float16
    tensors to float32, the dead groups dropped, so that it loads with
    `load_state_dict(strict=True)` (the JAX package's `convert_checkpoint`
    accepts the same files)."""
    if branch not in _DEAD:
        raise ValueError(f"unknown branch {branch!r}")
    sd: StateDict = {}
    src = unwrap_state_dict(obj)
    dead = _dead(src, branch)
    for k, v in src.items():
        if dead.match(k):
            continue
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        sd[k] = v.float() if v.dtype == torch.float16 else v
    return sd


# ------------------------------------------------------------------ inverse


def _np(t: torch.Tensor):
    """A leaf of the JAX tree: float32 numpy (float16 upcast); a meta
    tensor stays a float32 meta tensor, a leaf with a shape and no data."""
    t = t.detach().float()
    return t if t.is_meta else np.ascontiguousarray(t.cpu().numpy())


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


def _swin_tree(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    """The inverse of `_swin`, in the order of the JAX package's
    `convert_swin` (:188-221 there); timm's relative_position_index and
    attn_mask buffers are not read (the models recompute them)."""
    tree: Dict[str, Any] = {
        "patch_embed": {"proj": _conv_tree(sd, f"{prefix}patch_embed.proj"),
                        "norm": _norm_tree(sd, f"{prefix}patch_embed.norm")},
        "layers": [],
        "norm": _norm_tree(sd, f"{prefix}norm"),
        "head": _linear_tree(sd, f"{prefix}head")}
    p = re.escape(prefix)
    for li in range(_count(sd, rf"{p}layers\.(\d+)\.")):
        s = f"{prefix}layers.{li}"
        layer: Dict[str, Any] = {"blocks": []}
        for bi in range(_count(sd, rf"{p}layers\.{li}\.blocks\.(\d+)\.")):
            b = f"{s}.blocks.{bi}"
            layer["blocks"].append({
                "norm1": _norm_tree(sd, f"{b}.norm1"),
                "attn": {"qkv": _linear_tree(sd, f"{b}.attn.qkv"),
                         "proj": _linear_tree(sd, f"{b}.attn.proj"),
                         "relative_position_bias_table": _np(
                             sd[f"{b}.attn.relative_position_bias_table"])},
                "norm2": _norm_tree(sd, f"{b}.norm2"),
                "mlp": {"fc1": _linear_tree(sd, f"{b}.mlp.fc1"),
                        "fc2": _linear_tree(sd, f"{b}.mlp.fc2")}})
        if f"{s}.downsample.reduction.weight" in sd:
            layer["downsample"] = {"norm": _norm_tree(sd, f"{s}.downsample.norm"),
                                   "reduction": _linear_tree(sd, f"{s}.downsample.reduction")}
        tree["layers"].append(layer)
    return tree


def _facedet_tree(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"stem": _conv_tree(sd, "stem")}
    for group in ("blocks16", "blocks8"):
        tree[group] = [{"dw": _conv_tree(sd, f"{group}.{i}.dw"),
                        "pw": _conv_tree(sd, f"{group}.{i}.pw")}
                       for i in range(_count(sd, rf"{group}\.(\d+)\."))]
    tree["head16"] = _conv_tree(sd, "head16")
    tree["head8"] = _conv_tree(sd, "head8")
    return tree


def _consume_aliases(sd: Mapping[str, Any], backbone: str) -> None:
    """The reference's HybridEmbed registers the embedder's Swin a second
    time as `<backbone>.patch_embed.backbone` (the same tensors): a tracking
    dict counts those keys as read (genconvit_tpu/core/convert.py:130)."""
    used = getattr(sd, "used", None)
    if used is not None:
        used.update(k for k in sd if k.startswith(f"{backbone}.patch_embed.backbone."))


def _ed_tree(sd: Mapping[str, torch.Tensor], carry_dead_params: bool = False) -> Dict[str, Any]:
    swin = swin_backbone(sd)
    tree = {"encoder": [_conv_tree(sd, f"encoder.features.{i}") for i in (0, 3, 6, 9, 12)],
            "decoder": [_convT_tree(sd, f"decoder.features.{i}") for i in (0, 2, 4, 6, 8)],
            "backbone": (_swin_tree if swin else _convnext_tree)(sd, "backbone."),
            "fc": _linear_tree(sd, "fc"),
            "fc2": _linear_tree(sd, "fc2")}
    if carry_dead_params and "embedder.patch_embed.proj.weight" in sd:
        tree["embedder"] = _swin_tree(sd, "embedder.")
        if "backbone.patch_embed.proj.weight" in sd and not swin:
            tree["hybrid_proj"] = _conv_tree(sd, "backbone.patch_embed.proj")
        _consume_aliases(sd, "backbone")
    return tree


def _vae_tree(sd: Mapping[str, torch.Tensor], carry_dead_params: bool = False,
              updated: bool = False) -> Dict[str, Any]:
    """The original VAE (decoder ConvTs at features.{0,2,4,6}) or the
    updated one (decoder.decoder_input, ConvTs at {0,3,6,9}, BNs at
    {1,4,7}); with carry_dead_params, in the JAX package's
    `convert_vae`/`convert_vae_updated` order, encoder.fc1/fc2 and fc3
    (which must be there) and the embedder and hybrid_proj (where they are)."""
    enc: Dict[str, Any] = {
        "convs": [_conv_tree(sd, f"encoder.features.{i}") for i in (0, 3, 6, 9)],
        "bns": [_bn_tree(sd, f"encoder.features.{i}") for i in (1, 4, 7, 10)],
        "mu": _linear_tree(sd, "encoder.mu"),
        "var": _linear_tree(sd, "encoder.var")}
    if carry_dead_params:
        enc["fc1"] = _linear_tree(sd, "encoder.fc1")
        enc["fc2"] = _linear_tree(sd, "encoder.fc2")
    if updated:
        decoder: Any = {
            "input": _linear_tree(sd, "decoder.decoder_input"),
            "convs": [_convT_tree(sd, f"decoder.features.{i}") for i in (0, 3, 6, 9)],
            "bns": [_bn_tree(sd, f"decoder.features.{i}") for i in (1, 4, 7)]}
    else:
        decoder = [_convT_tree(sd, f"decoder.features.{i}") for i in (0, 2, 4, 6)]
    tree = {"encoder": enc, "decoder": decoder,
            "backbone": _convnext_tree(sd, "convnext_backbone."),
            "fc": _linear_tree(sd, "fc"),
            "fc2": _linear_tree(sd, "fc2")}
    if carry_dead_params:
        tree["fc3"] = _linear_tree(sd, "fc3")
        if "embedder.patch_embed.proj.weight" in sd:
            tree["embedder"] = _swin_tree(sd, "embedder.")
        if "convnext_backbone.patch_embed.proj.weight" in sd:
            tree["hybrid_proj"] = _conv_tree(sd, "convnext_backbone.patch_embed.proj")
        _consume_aliases(sd, "convnext_backbone")
    return tree


def tree_from_state_dict(sd: Mapping[str, torch.Tensor], branch: str) -> Dict[str, Any]:
    """The inverse of `state_dict_from_jax` for 'ed', 'vae' (either variant),
    'convnext', 'swin' and 'facedet': the JAX package's tree (float32 numpy
    leaves), e.g. to write a `.gcv` that both packages read."""
    if branch == "convnext":
        return _convnext_tree(sd, "")
    if branch == "swin":
        return _swin_tree(sd, "")
    if branch == "facedet":
        return _facedet_tree(sd)
    if branch == "ed":
        return _ed_tree(sd)
    if branch == "vae":
        return _vae_tree(sd, updated="decoder.decoder_input.weight" in sd)
    raise ValueError(f"unknown branch {branch!r}")


# ------------------------------------------------------------------ reference -> tree

# Checkpoint keys that are legitimately not converted: torch's BatchNorm
# counter and timm's Swin buffers, which depend only on the window and the
# grid (genconvit_tpu/core/convert.py:32).
_EXPECTED_UNCONSUMED = re.compile(r".*(num_batches_tracked|relative_position_index|attn_mask)$")


class _TrackingDict(Mapping):
    """A state dict that records which keys the conversion reads (a
    presence test is no read), so that strict mode can prove that nothing
    was left over (genconvit_tpu/core/convert.py:36-58)."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self._sd = sd
        self.used: Set[str] = set()

    def __getitem__(self, k):
        self.used.add(k)
        return self._sd[k]

    def __contains__(self, k):
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)


def reference_branch(sd: Mapping[str, Any], which: Optional[str] = None) -> str:
    """`which`, or `detect_branch`'s answer. 'vae' names either VAE variant,
    as everywhere in the port: an updated checkpoint under 'vae' converts
    as 'vae_updated' (the JAX converter reads it as the original and fails
    on the missing decoder.features.2)."""
    if which == "vae" and "decoder.decoder_input.weight" in sd:
        return "vae_updated"
    return which or detect_branch(sd)


def _convert(sd: Mapping[str, Any], which: str,
             carry_dead_params: bool) -> Tuple[Dict[str, Any], List[str]]:
    """(tree, the checkpoint keys the conversion left unread). Without
    carry_dead_params the dead groups are dropped on purpose, so they count
    as read: the JAX converter's strict mode refuses them."""
    tracked = _TrackingDict(sd)
    if which == "ed":
        tree = _ed_tree(tracked, carry_dead_params)
    elif which in ("vae", "vae_updated"):
        tree = _vae_tree(tracked, carry_dead_params, which == "vae_updated")
    else:
        raise ValueError(f"unknown branch {which!r}")
    dropped = None if carry_dead_params else _dead(sd, "ed" if which == "ed" else "vae")
    unused = sorted(k for k in sd if k not in tracked.used and not _EXPECTED_UNCONSUMED.match(k)
                    and not (dropped and dropped.match(k)))
    return tree, unused


def _strict_message(unused: List[str]) -> str:
    shown = ", ".join(unused[:20])
    more = f" (+{len(unused) - 20} more)" if len(unused) > 20 else ""
    return (f"strict conversion: {len(unused)} checkpoint key(s) were not consumed — "
            f"layout mismatch or new parameter group: {shown}{more}")


def tree_from_reference(obj: Any, which: Optional[str] = None, carry_dead_params: bool = True,
                        strict: bool = False) -> Dict[str, Any]:
    """A reference checkpoint of torch tensors (bare or nested under
    'state_dict') -> the JAX package's tree of branch `which`
    (`reference_branch`), the tree `genconvit_tpu.core.convert.
    convert_checkpoint` gives (:341-378 there): float32 numpy leaves
    (float16 upcast), or meta tensors for meta leaves (shapes alone). With
    carry_dead_params the dead groups come across in the JAX layout
    ('embedder' as a Swin tree, 'hybrid_proj', the VAE's encoder fc1/fc2
    and fc3), else they are dropped. strict raises ValueError when a key
    was left unread, apart from torch's counters, timm's Swin buffers and
    the dead groups dropped on purpose."""
    sd = unwrap_state_dict(obj)
    tree, unused = _convert(sd, reference_branch(sd, which), carry_dead_params)
    if strict and unused:
        raise ValueError(_strict_message(unused))
    return tree


# ------------------------------------------------------------------ manifest
# The weights run's pre-flight (genconvit_tpu/core/convert.py:380-509): a
# manifest {key: {"shape", "dtype"}} of a checkpoint, which the reference
# side records without shipping the weights, goes through the whole strict
# conversion on meta tensors: every shape, no data, so the published VAE's
# 2 x 25088 x 12544 latent heads cost nothing.

_DTYPE_ALIASES = {"float": "float32", "double": "float64", "half": "float16",
                  "long": "int64", "int": "int32"}


def manifest_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """{key: {"shape": [...], "dtype": "float32"}} for a state dict of
    torch tensors (meta ones too) or numpy arrays ('torch.' stripped)."""
    out = {}
    for k, v in sd.items():
        dt = str(getattr(v, "dtype", "float32"))
        if dt.startswith("torch."):
            dt = dt[len("torch."):]
        out[k] = {"shape": [int(s) for s in getattr(v, "shape", ())], "dtype": dt}
    return out


def state_dict_from_manifest(manifest: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Meta tensors of the manifest's shapes and dtypes (torch's short
    names too; an unknown name is float32)."""
    sd = {}
    for k, spec in manifest.items():
        name = spec.get("dtype", "float32")
        dtype = getattr(torch, _DTYPE_ALIASES.get(name, name), None)
        sd[k] = torch.empty(tuple(spec.get("shape", ())), device="meta",
                            dtype=dtype if isinstance(dtype, torch.dtype) else torch.float32)
    return sd


def _leaf_shapes(tree: Any, prefix: str = "") -> Dict[str, tuple]:
    """{'/'-joined path: shape} over a tree of dicts and lists whose leaves
    have a shape (arrays, tensors, jax.eval_shape's structs)."""
    out: Dict[str, tuple] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_leaf_shapes(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaf_shapes(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix.rstrip("/")] = tuple(int(d) for d in getattr(tree, "shape", ()))
    return out


def preflight_manifest(manifest: Mapping[str, Any], which: Optional[str] = None,
                       carry_dead_params: bool = True, expected: Any = None) -> Dict[str, Any]:
    """The strict conversion of a manifest, on shapes alone. The JAX
    package's report (genconvit_tpu/core/convert.py:424-509): {"ok",
    "branch", "keys", "error", "unused", "suggestions", "shape_mismatches"};
    ok=False with `error` where a key the converter reads is missing (with
    close matches among the manifest's keys in `suggestions`), with
    `unused` where keys were left unread, with `shape_mismatches` where the
    tree's leaves differ from `expected` (a tree whose leaves have shapes).
    Without carry_dead_params the dead groups count as read."""
    import difflib

    sd = state_dict_from_manifest(manifest)
    report: Dict[str, Any] = {"ok": False, "keys": len(sd), "error": None, "unused": [],
                              "suggestions": {}, "shape_mismatches": []}
    try:
        report["branch"] = reference_branch(sd, which)
        tree, unused = _convert(sd, report["branch"], carry_dead_params)
        if unused:
            report["error"], report["unused"] = _strict_message(unused), unused
            return report
        if expected is not None:
            exp, got = _leaf_shapes(expected), _leaf_shapes(tree)
            report["shape_mismatches"] = (
                [f"{p}: checkpoint {got[p]} vs expected {exp[p]}"
                 for p in sorted(set(exp) & set(got)) if exp[p] != got[p]]
                + [f"{p}: missing from checkpoint (expected {exp[p]})"
                   for p in sorted(set(exp) - set(got))]
                + [f"{p}: not in the expected tree (checkpoint {got[p]})"
                   for p in sorted(set(got) - set(exp))])
            if report["shape_mismatches"]:
                report["error"] = (f"{len(report['shape_mismatches'])} leaf shape/structure "
                                   f"mismatch(es) vs the expected init tree")
                return report
        report["ok"] = True
    except ValueError as e:   # an unknown branch
        report["error"] = str(e)
    except KeyError as e:     # the converter read a key the manifest lacks
        missing = str(e).strip("'\"")
        report["error"] = f"converter expects missing key: {missing}"
        close = difflib.get_close_matches(missing, list(sd), n=3, cutoff=0.6)
        if close:
            report["suggestions"][missing] = close
    except Exception as e:    # a leaf of the wrong rank, etc.
        report["error"] = f"{type(e).__name__}: {e}"
    return report
