"""The weight bridge: torch-oracle state dict -> the JAX package's converter
-> state_dict_from_jax gives back the original arrays, and the result loads
into the port's modules with strict key matching."""

import numpy as np
import pytest
import torch

from genconvit_tpu.core import convert as jax_convert

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.convnext import ConvNeXt
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.vae import GenConViTVAE

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, SMALL_DEPTHS,
                                   SMALL_DIMS, convnext_oracle, ed_state_dict,
                                   small_backbone, vae_state_dict)

_ = small_backbone  # fixture


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
        assert got[k].shape == want[k].shape, k


@pytest.mark.parametrize("branch", ["ed", "vae", "convnext"])
def test_round_trip_is_identity_and_loads_strict(branch, small_backbone):
    rng = np.random.default_rng(0)
    if branch == "ed":
        sd = ed_state_dict(0, rng)
        tree = jax_convert.convert_ed(sd)
        module = GenConViTED(small_backbone, backbone_classes=BACKBONE_CLASSES)
    elif branch == "vae":
        sd = vae_state_dict(0, rng)
        tree = jax_convert.convert_vae(sd, carry_dead_params=False)
        module = GenConViTVAE(small_backbone, img_size=IMG,
                              backbone_classes=BACKBONE_CLASSES)
    else:
        sd = convnext_oracle(0, rng).state_dict()
        tree = jax_convert.convert_convnext(sd)
        module = ConvNeXt(SMALL_DEPTHS, SMALL_DIMS, BACKBONE_CLASSES)
    got = state_dict_from_jax(tree, branch)
    _assert_same(got, sd)
    module.load_state_dict(got, strict=True)
    _assert_same({k: v for k, v in module.state_dict().items()}, sd)


def test_dead_parameter_groups_are_ignored():
    """Converted reference checkpoints carry groups that never run (the
    Swin embedder, hybrid_proj, fc3, VAE encoder.fc1/fc2); the bridge skips
    them and the result still loads strictly."""
    rng = np.random.default_rng(1)
    sd = vae_state_dict(1, rng)
    tree = jax_convert.convert_vae(sd, carry_dead_params=False)
    flat = tree["encoder"]["mu"]["kernel"].shape[0]
    dead = dict(tree)
    dead["fc3"] = {"kernel": np.zeros((10, 5), np.float32),
                   "bias": np.zeros(5, np.float32)}
    dead["hybrid_proj"] = {"kernel": np.zeros((1, 1, 10, 768), np.float32)}
    dead["embedder"] = {"patch_embed": {}}
    dead["encoder"] = dict(tree["encoder"],
                           fc1={"kernel": np.zeros((flat, 256), np.float32),
                                "bias": np.zeros(256, np.float32)})
    _assert_same(state_dict_from_jax(dead, "vae"), state_dict_from_jax(tree, "vae"))


def test_unknown_branch_raises():
    with pytest.raises(ValueError, match="unknown branch"):
        state_dict_from_jax({}, "bogus")


def test_layouts():
    """The four layout maps on one tensor each (inverse of convert.py:70-99)."""
    k = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    tree = {"stem": {"conv": {"kernel": k, "bias": np.zeros(5, np.float32)},
                     "norm": {"scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)}},
            "stages": [],
            "head": {"norm": {"scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)},
                     "fc": {"kernel": k[0, 0], "bias": np.zeros(5, np.float32)}}}
    sd = state_dict_from_jax(tree, "convnext")
    assert sd["stem.0.weight"].shape == (5, 4, 2, 3)           # HWIO -> OIHW
    assert torch.equal(sd["stem.0.weight"][1, 2], torch.from_numpy(k[:, :, 2, 1]))
    assert torch.equal(sd["head.fc.weight"], torch.from_numpy(k[0, 0].T.copy()))
