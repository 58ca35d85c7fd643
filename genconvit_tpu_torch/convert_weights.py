"""Reference torch checkpoint -> `.gcv` converter of the PyTorch/CUDA port,
flag-compatible with the repository's `convert_weights.py` (:19-95):

    python -m genconvit_tpu_torch.convert_weights weight/genconvit_ed_inference.pth
        [--out weight/genconvit_ed_inference.gcv] [--which ed|vae] [--no-dead] [--strict]
    python -m genconvit_tpu_torch.convert_weights --preflight MANIFEST_JSON
        [--expect-init] [--which ed|vae] [--no-dead]

The `.gcv` holds the JAX package's tree of the branch
(`core/convert.tree_from_reference`), the dead parameter groups carried
unless --no-dead, with the file's epoch and min_loss and extra {"source",
"branch"}: the file the root CLI writes, which both packages read. It is
host I/O: no device is touched. `--preflight` runs the strict conversion on
a key/shape manifest (`core/convert.preflight_manifest`, on meta tensors)
and exits 0 when it would consume the checkpoint whole, 1 otherwise.

Where the root CLI cannot pass the published layout, the port departs:

  * `--no-dead --strict` counts the dead groups it drops as read (the JAX
    converter's strict mode refuses them once dropped);
  * `--expect-init` checks the converted shapes against the port's own
    modules at the configuration `load_config` gives (by default
    convnext_tiny, 224 px, latent 12544, swin_tiny), built on the meta
    device, with the dead groups exactly when the conversion carries them
    (the JAX init tree never has them);
  * `--which vae` takes an updated VAE checkpoint as well (the JAX
    converter reads it as the original and fails).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from genconvit_tpu_torch.config import Config, load_config
from genconvit_tpu_torch.core.checkpoint import save_checkpoint
from genconvit_tpu_torch.core.convert import (preflight_manifest, reference_branch,
                                              state_dict_from_manifest, tree_from_reference,
                                              unwrap_state_dict)
from genconvit_tpu_torch.core.pytree import param_count
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.swin import SwinTransformer, block_window
from genconvit_tpu_torch.models.vae import GenConViTVAE

BACKBONE_CLASSES = 1000   # timm's ImageNet heads, which the reference keeps
HYBRID_DIM = 768          # the reference's HybridEmbed(embed_dim=768)
SWIN_IMG = 224            # the embedder's own input size (swin_*_224)


def _swin_buffers(swin: SwinTransformer) -> Dict[str, torch.Tensor]:
    """timm 0.6.5's Swin buffers, as meta tensors: each block's
    relative_position_index [L, L] and, in blocks that shift,
    attn_mask [nW, L, L] (L = the block's window squared)."""
    out = {}
    grid = SWIN_IMG // 4
    for li, layer in enumerate(swin.layers):
        for bi in range(len(layer.blocks)):
            window, shift = block_window((grid, grid), swin.cfg["window"], bi)
            l = window * window
            b = f"layers.{li}.blocks.{bi}"
            out[f"{b}.attn.relative_position_index"] = torch.empty(l, l, dtype=torch.long,
                                                                   device="meta")
            if shift:
                out[f"{b}.attn_mask"] = torch.empty((grid // window) ** 2, l, l, device="meta")
        grid //= 2
    return out


def published_layout(branch: str, config: Optional[Config] = None,
                     dead: bool = True) -> Dict[str, torch.Tensor]:
    """The keys and shapes of the reference checkpoint of `branch` ('ed',
    'vae' or 'vae_updated') at `config` (`Config()` by default), as meta
    tensors: the state dict of the port's module and, with `dead`, the
    groups that only the reference's modules hold: the Swin `embedder`
    (timm's buffers included), the HybridEmbed's second registration of it
    under `<backbone>.patch_embed.backbone` (the same tensors) and its 1x1
    `proj`, and for the VAE `encoder.fc1`/`fc2` and `fc3`."""
    config = config or Config()
    with torch.device("meta"):
        if branch == "ed":
            module: nn.Module = GenConViTED(config.model.backbone, config.num_classes,
                                            BACKBONE_CLASSES)
        elif branch in ("vae", "vae_updated"):
            module = GenConViTVAE(config.model.backbone, config.img_size, config.vae_latent_dims(),
                                  config.num_classes, BACKBONE_CLASSES,
                                  variant="updated" if branch == "vae_updated" else "original")
        else:
            raise ValueError(f"unknown branch {branch!r}")
        sd = dict(module.state_dict())
        if not dead:
            return sd
        swin = SwinTransformer(config.model.embedder, BACKBONE_CLASSES)
        groups = {"proj": nn.Conv2d(BACKBONE_CLASSES, HYBRID_DIM, 1)}
        if branch != "ed":
            flat = 128 * (config.img_size // 16) ** 2
            groups.update({"encoder.fc1": nn.Linear(flat, 256), "encoder.fc2": nn.Linear(256, 128),
                           "fc3": nn.Linear(BACKBONE_CLASSES, BACKBONE_CLASSES // 2)})
    bb = "backbone" if branch == "ed" else "convnext_backbone"
    embedder = dict(swin.state_dict(), **_swin_buffers(swin))
    for k, v in embedder.items():
        sd[f"embedder.{k}"] = sd[f"{bb}.patch_embed.backbone.{k}"] = v
    for name, m in groups.items():
        prefix = f"{bb}.patch_embed.proj" if name == "proj" else name
        sd.update({f"{prefix}.{k}": v for k, v in m.state_dict().items()})
    return sd


def expected_tree(branch: str, config: Optional[Config] = None,
                  carry_dead_params: bool = True) -> Dict[str, Any]:
    """The tree (meta leaves) that a checkpoint of `branch` at `config`
    converts to: `--expect-init`'s yardstick, with the dead groups exactly
    when the conversion carries them."""
    return tree_from_reference(published_layout(branch, config, dead=carry_dead_params),
                               branch, carry_dead_params)


def gen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("convert_weights")
    p.add_argument("pth", nargs="?", help="torch checkpoint path")
    p.add_argument("--out", default=None)
    p.add_argument("--which", choices=["ed", "vae"], default=None)
    p.add_argument("--no-dead", action="store_true",
                   help="drop checkpoint-only parameter groups (SURVEY.md §8 B9)")
    p.add_argument("--strict", action="store_true",
                   help="fail unless every checkpoint key was consumed (the dead groups "
                        "dropped by --no-dead count as consumed)")
    p.add_argument("--preflight", metavar="MANIFEST_JSON",
                   help="dry-run the strict conversion against a key/shape manifest "
                        "(tools/record_reference_torch.py --manifest); exits non-zero on "
                        "any naming/shape drift")
    p.add_argument("--expect-init", action="store_true",
                   help="with --preflight: also check the converted tree's leaf shapes against "
                        "the port's modules at the default configuration (built on the meta "
                        "device)")
    return p


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    """Run the CLI on argv (sys.argv[1:] by default); returns the path of
    the `.gcv` written. `--preflight` ends in SystemExit(0 or 1)."""
    p = gen_parser()
    args = p.parse_args(argv)
    if args.preflight:
        with open(args.preflight) as f:
            manifest = json.load(f)
        expected = None
        if args.expect_init:
            branch = reference_branch(state_dict_from_manifest(manifest), args.which)
            expected = expected_tree(branch, load_config(), carry_dead_params=not args.no_dead)
        report = preflight_manifest(manifest, which=args.which,
                                    carry_dead_params=not args.no_dead, expected=expected)
        print(json.dumps(report, indent=2))
        if report["ok"]:
            print(f"PREFLIGHT OK: the converter consumes all {report['keys']} keys of this "
                  f"{report['branch']} checkpoint layout")
        raise SystemExit(0 if report["ok"] else 1)

    if not args.pth:
        p.error("pass a .pth checkpoint (or --preflight MANIFEST_JSON)")
    obj = torch.load(args.pth, map_location="cpu", weights_only=True)
    sd = unwrap_state_dict(obj)
    which = reference_branch(sd, args.which)
    params = tree_from_reference(sd, which, carry_dead_params=not args.no_dead,
                                 strict=args.strict)
    out = args.out or os.path.splitext(args.pth)[0] + ".gcv"
    epoch = obj.get("epoch", 0) if isinstance(obj, dict) else 0
    min_loss = obj.get("min_loss", 0.0) if isinstance(obj, dict) else 0.0
    save_checkpoint(out, params, epoch=int(epoch), min_loss=float(min_loss),
                    extra={"source": os.path.basename(args.pth), "branch": which})
    print(f"{args.pth} [{which}] -> {out}  ({param_count(params):,} params)")
    return out


if __name__ == "__main__":
    main()
