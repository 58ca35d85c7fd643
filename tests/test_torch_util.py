"""Shared builders for the port's parity tests (this file holds no tests):
torch-oracle state dicts of the reference models at a small size, with
non-trivial layer scale and BatchNorm statistics, and the matching JAX
trees through the JAX package's converter."""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn as nn

from genconvit_tpu.core import convert

from tests.torch_oracles import (ConvNeXtOracle, EDDecoderOracle,
                                 EDEncoderOracle, VAEDecoderOracle,
                                 VAEEncoderOracle)

SMALL_DEPTHS = (1, 1, 1, 1)
SMALL_DIMS = (8, 16, 32, 64)
SMALL_NAME = "convnext_test"
IMG = 64
BACKBONE_CLASSES = 10


@pytest.fixture
def small_backbone(monkeypatch):
    """Register the small ConvNeXt under a name the port's configs accept."""
    from genconvit_tpu_torch.models import convnext as port_convnext

    monkeypatch.setitem(port_convnext.CONVNEXT_CFGS, SMALL_NAME,
                        dict(depths=SMALL_DEPTHS, dims=SMALL_DIMS))
    return SMALL_NAME


def _prefixed(sd, prefix, module):
    sd.update({f"{prefix}{k}": v.detach().clone()
               for k, v in module.state_dict().items()})


def convnext_oracle(seed, rng, num_classes=BACKBONE_CLASSES):
    """Small ConvNeXt oracle with layer scale U(0.1, 1): the 1e-6 init
    would make block parity nearly vacuous."""
    torch.manual_seed(seed)
    bb = ConvNeXtOracle(depths=SMALL_DEPTHS, dims=SMALL_DIMS,
                        num_classes=num_classes).eval()
    with torch.no_grad():
        for name, p in bb.named_parameters():
            if name.endswith("gamma"):
                p.copy_(torch.from_numpy(
                    rng.uniform(0.1, 1.0, p.shape).astype(np.float32)))
    return bb


def _head(sd, num_classes, backbone_classes):
    nf = 2 * backbone_classes
    _prefixed(sd, "fc.", nn.Linear(nf, nf // 4))
    _prefixed(sd, "fc2.", nn.Linear(nf // 4, num_classes))


def ed_state_dict(seed, rng, backbone_classes=BACKBONE_CLASSES):
    bb = convnext_oracle(seed, rng, backbone_classes)
    sd = {}
    _prefixed(sd, "encoder.", EDEncoderOracle())
    _prefixed(sd, "decoder.", EDDecoderOracle())
    _prefixed(sd, "backbone.", bb)
    _head(sd, 2, backbone_classes)
    return sd


def vae_state_dict(seed, rng, backbone_classes=BACKBONE_CLASSES, img=IMG):
    bb = convnext_oracle(seed, rng, backbone_classes)
    enc = VAEEncoderOracle(img_size=img)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    sd = {}
    _prefixed(sd, "encoder.", enc)
    _prefixed(sd, "decoder.", VAEDecoderOracle(s=img // 32))
    _prefixed(sd, "convnext_backbone.", bb)
    _head(sd, 2, backbone_classes)
    return sd


def jax_trees(sd_ed, sd_vae):
    """The JAX package's trees for the oracle state dicts."""
    return {"ed": convert.convert_ed(sd_ed),
            "vae": convert.convert_vae(sd_vae, carry_dead_params=False)}


def images(rng, n=2, img=IMG):
    """(NCHW float32 numpy, the port's channels_last tensor, JAX NHWC)."""
    x = rng.standard_normal((n, 3, img, img), dtype=np.float32)
    t = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    return x, t, np.ascontiguousarray(x.transpose(0, 2, 3, 1))


@contextlib.contextmanager
def small_backbone_registered():
    """small_backbone for fixtures wider than one test."""
    from genconvit_tpu_torch.models import convnext as port_convnext

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_convnext.CONVNEXT_CFGS, SMALL_NAME,
                   dict(depths=SMALL_DEPTHS, dims=SMALL_DIMS))
        yield SMALL_NAME


def write_gcv_weights(wdir, seed=0, head_scale=10.0):
    """The ED and VAE `.gcv` files of the small oracle models, written by the
    JAX package's save_checkpoint and nested as train_model nests them, both
    heads' last layer scaled by `head_scale` so that verdicts are decisive."""
    from genconvit_tpu.core import checkpoint as jax_ckpt

    rng = np.random.default_rng(seed)
    sd_ed, sd_vae = ed_state_dict(seed, rng), vae_state_dict(seed + 1, rng)
    for sd in (sd_ed, sd_vae):
        sd["fc2.weight"] *= head_scale
        sd["fc2.bias"] *= head_scale
    trees = jax_trees(sd_ed, sd_vae)
    wdir.mkdir(parents=True, exist_ok=True)
    jax_ckpt.save_checkpoint(str(wdir / "genconvit_ed_inference.gcv"), {"ed": trees["ed"]})
    jax_ckpt.save_checkpoint(str(wdir / "genconvit_vae_inference.gcv"), {"vae": trees["vae"]})


def write_small_config(path):
    """A model/config.yaml both packages read (load_config): the small
    backbone at IMG px."""
    path.write_text(f"model:\n  backbone: {SMALL_NAME}\n  latent_dims: {256 * (IMG // 32) ** 2}\n"
                    f"img_size: {IMG}\nnum_classes: 2\n")
    return str(path)
