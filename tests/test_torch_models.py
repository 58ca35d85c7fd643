"""The port's models against the JAX package in float32 on the CPU, on the
same weights (torch-oracle state dicts -> the JAX converter -> the port's
bridge) and the same inputs: rtol 1e-3, atol 1e-4, the bounds of
tests/test_full_model_parity.py. Also the kernel backbone's wiring (stem
K2, per-block K1, downsample LN fused into the previous K1) against the
JAX kernel backbone in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.models.ed import ed_apply
from genconvit_tpu.models.genconvit import genconvit_apply
from genconvit_tpu.models.vae import vae_apply

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.convnext import ConvNeXt
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.models.vae import GenConViTVAE
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, SMALL_DEPTHS,
                                   SMALL_DIMS, convnext_oracle, ed_state_dict,
                                   images, jax_trees, small_backbone,
                                   vae_state_dict)

TOL = dict(rtol=1e-3, atol=1e-4)
_ = small_backbone  # fixture


def _port_convnext(jax_tree):
    m = ConvNeXt(SMALL_DEPTHS, SMALL_DIMS, BACKBONE_CLASSES).eval()
    m.load_state_dict(state_dict_from_jax(jax_tree, "convnext"), strict=True)
    return m.to(memory_format=torch.channels_last)


def _port(cls, branch, tree, name):
    kw = dict(backbone=name, backbone_classes=BACKBONE_CLASSES)
    if cls is GenConViTVAE:
        kw["img_size"] = IMG
    m = cls(**kw).eval()
    m.load_state_dict(state_dict_from_jax(tree, branch), strict=True)
    return m.to(memory_format=torch.channels_last)


def test_convnext_matches_jax():
    rng = np.random.default_rng(0)
    tree = jax_convert.convert_convnext(convnext_oracle(0, rng).state_dict())
    _, x, x_nhwc = images(rng)
    ref = jax_convnext.convnext_apply(tree, jnp.asarray(x_nhwc))
    with torch.no_grad():
        got = _port_convnext(tree)(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("tier", ["default", "hp"])
def test_kernel_backbone_wiring_matches_jax_kernel_backbone(tier, monkeypatch):
    """The port's kernel backbone with the wrappers' CPU path against the
    JAX whole-backbone kernel path (_features_mlp_kernel, Pallas in
    interpret mode), both with the plan's rational GELU."""
    monkeypatch.setenv("GENCONVIT_GELU", tier)
    rng = np.random.default_rng(1)
    tree = jax_convert.convert_convnext(convnext_oracle(1, rng).state_dict())
    _, x, x_nhwc = images(rng)
    ref = jax_convnext._features_mlp_kernel(tree, jnp.asarray(x_nhwc))
    m = _port_convnext(tree)
    m.prepare_kernels()
    km.reset_launch_counts()
    with torch.no_grad():
        got = m._features_kernels(x, tier)
    assert km.launch_counts() == {"ln_mlp_residual": 0, "layer_norm_rows": 0}
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_kernel_backbone_equals_plain_graph_in_f32():
    """Kernel wiring with the hp GELU against the plain exact-GELU graph:
    the only difference is the 8.7e-7 erf fit."""
    rng = np.random.default_rng(2)
    tree = jax_convert.convert_convnext(convnext_oracle(2, rng).state_dict())
    _, x, _ = images(rng)
    m = _port_convnext(tree)
    with torch.no_grad(), pytest.raises(RuntimeError, match="prepare_kernels"):
        m._features_kernels(x, "hp")
    m.prepare_kernels()
    with torch.no_grad():
        torch.testing.assert_close(m._features_kernels(x, "hp"),
                                   m._features_plain(x, "exact"),
                                   rtol=1e-4, atol=1e-4)


def test_ed_matches_jax(small_backbone):
    rng = np.random.default_rng(3)
    tree = jax_convert.convert_ed(ed_state_dict(3, rng))
    _, x, x_nhwc = images(rng)
    ref, _ = ed_apply(tree, jnp.asarray(x_nhwc))
    with torch.no_grad():
        got = _port(GenConViTED, "ed", tree, small_backbone)(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_vae_deterministic_matches_jax(small_backbone):
    rng = np.random.default_rng(4)
    tree = jax_convert.convert_vae(vae_state_dict(4, rng), carry_dead_params=False)
    _, x, x_nhwc = images(rng)
    ref, ref_recon, _ = vae_apply(tree, jnp.asarray(x_nhwc), sample=False)
    with torch.no_grad():
        got, recon = _port(GenConViTVAE, "vae", tree, small_backbone)(
            x, sample=False, return_recon=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(recon.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_recon), **TOL)


def test_vae_sampled_with_the_jax_eps_matches_jax(small_backbone):
    """Quirk B4 (z = mu + eps * exp(0.5 * mu)) with the eps JAX draws
    itself (vae.py:214), injected into the port."""
    rng = np.random.default_rng(5)
    tree = jax_convert.convert_vae(vae_state_dict(5, rng), carry_dead_params=False)
    _, x, x_nhwc = images(rng)
    key = jax.random.PRNGKey(11)
    latent = Config(img_size=IMG).vae_latent_dims()
    eps = np.array(jax.random.normal(key, (x.shape[0], latent), jnp.float32))
    ref, _, _ = vae_apply(tree, jnp.asarray(x_nhwc), key, sample=True)
    ref_det, _, _ = vae_apply(tree, jnp.asarray(x_nhwc), sample=False)
    assert not np.allclose(np.asarray(ref), np.asarray(ref_det), **TOL)
    with torch.no_grad():
        got = _port(GenConViTVAE, "vae", tree, small_backbone)(
            x, sample=True, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("net", ["ed", "vae", "genconvit"])
def test_genconvit_matches_jax(net, small_backbone):
    rng = np.random.default_rng(6)
    trees = jax_trees(ed_state_dict(6, rng), vae_state_dict(7, rng))
    _, x, x_nhwc = images(rng)
    ref, _ = genconvit_apply(trees, jnp.asarray(x_nhwc), net=net, sample=False)
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG)
    model = GenConViT(cfg, net, BACKBONE_CLASSES).eval()
    for b in model.branches():
        name = "ed" if isinstance(b, GenConViTED) else "vae"
        b.load_state_dict(state_dict_from_jax(trees[name], name), strict=True)
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model(x, KernelPlan(), sample=False)
    assert got.shape == ((2 if net == "genconvit" else 1) * x.shape[0], 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_on_cpu_runs_the_plain_graph(small_backbone):
    """bf16 off CUDA never reaches a kernel: finite logits, no launches."""
    rng = np.random.default_rng(8)
    tree = jax_convert.convert_ed(ed_state_dict(8, rng))
    _, x, _ = images(rng)
    m = _port(GenConViTED, "ed", tree, small_backbone).to(torch.bfloat16)
    km.reset_launch_counts()
    with torch.no_grad():
        out = m(x.to(torch.bfloat16))
    assert torch.isfinite(out.float()).all()
    assert km.launch_counts() == {"ln_mlp_residual": 0, "layer_norm_rows": 0}
