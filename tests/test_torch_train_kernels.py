"""The port's differentiable kernel paths against the JAX package's custom
VJPs on the CPU, and train-mode BatchNorm.

`KernelBackbone`, `FusedBlock` and `FusedStage` (models/convnext.py) take
their kernels as arguments; here they get the plain versions (K1/K4 and
K2, K5, K6). Their backward is held against the JAX package's backward
functions called directly on the same residuals and cotangent
(`_features_mlp_bwd`, `_block_pallas_bwd`, `_stage_pallas_bwd`): float32
within 1e-5 relative L2 over the whole gradient tree (the same graph up
to float32 summation order), bfloat16 within 2e-2 (the same graph rounded
to bf16 at the same points, summed in other orders). Their forward must
equal the kernel path with folds made from the weights of the call, never
from earlier ones. Small ConvNeXt (depths 1,1,1,1, dims 8..64, 64 px),
layer scale U(0.1, 1)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core.pytree import cast_floats
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.ops import norm as jax_norm

from genconvit_tpu_torch.core.convert import state_dict_from_jax, tree_from_state_dict
from genconvit_tpu_torch.models import convnext as pc
from genconvit_tpu_torch.models.convnext import (FeatureTensors, FusedBlock, FusedStage,
                                                 KernelBackbone, features_kernels,
                                                 kernel_weights)
from genconvit_tpu_torch.ops import norm as port_norm
from genconvit_tpu_torch.ops.cuda import convnext_block as k5
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4
from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

from tests.test_torch_util import SMALL_DEPTHS, SMALL_DIMS, convnext_oracle

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PX = 64


@pytest.fixture(scope="module")
def backbone():
    """(JAX tree, port ConvNeXt) of the small oracle backbone, float32."""
    bb = convnext_oracle(7, np.random.default_rng(7))
    sd = {k: v.detach().clone() for k, v in bb.state_dict().items()}
    tree = tree_from_state_dict(sd, "convnext")
    m = pc.ConvNeXt(depths=SMALL_DEPTHS, dims=SMALL_DIMS, num_classes=10)
    m.load_state_dict(state_dict_from_jax(tree, "convnext"))
    return tree, m.to(memory_format=torch.channels_last)


def _port_copy(m, dtype):
    """The module's parameters as leaves of `dtype` that take gradients."""
    out = pc.ConvNeXt(depths=SMALL_DEPTHS, dims=SMALL_DIMS, num_classes=10)
    out.load_state_dict(m.state_dict())
    return out.to(dtype).to(memory_format=torch.channels_last)


def _grad_tree(m):
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
          for k, p in m.named_parameters()}
    return tree_from_state_dict(sd, "convnext")


def _rel(got, want) -> float:
    """Relative L2 error over all leaves of two trees."""
    g = np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree_util.tree_leaves(got)])
    w = np.concatenate([np.asarray(a, np.float64).ravel()
                        for a in jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                            lambda v: jnp.asarray(v, jnp.float32), want))])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _nhwc_np(t):
    return np.ascontiguousarray(t.detach().float().permute(0, 2, 3, 1).numpy())


def _inputs(rng, n, c, h, dtype):
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    g = rng.standard_normal((n, c, h, h)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype).contiguous(memory_format=torch.channels_last)
    gt = torch.from_numpy(g).to(dtype).contiguous(memory_format=torch.channels_last)
    return xt, gt


@pytest.mark.parametrize("int8_mlp", ["", "fc1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_backbone_backward_matches_features_mlp_bwd(backbone, dtype, int8_mlp):
    tree, m0 = backbone
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 3, PX, PX)).astype(np.float32)).to(tdt)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    m = _port_copy(m0, tdt)
    ft = m.feature_tensors()
    tail = k4.ln_mlp_residual_int8_plain if int8_mlp else km.ln_mlp_residual_plain
    out = KernelBackbone.apply(ft.layout(), "default", int8_mlp,
                               (tail, km.layer_norm_rows_plain), x, *ft.flat())
    # the forward is the kernel path on folds of these very weights
    with torch.no_grad():
        want = features_kernels(x, ft, kernel_weights(ft, int8_mlp), "default", tail,
                                km.layer_norm_rows_plain)
    assert torch.equal(out, want)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).to(tdt)
    out.backward(g.contiguous(memory_format=torch.channels_last))
    res = (cast_floats(jax.tree_util.tree_map(jnp.asarray, tree), jdt),
           jnp.asarray(_nhwc_np(x.detach()), jdt))
    dp, dx = jax.jit(jax_convnext._features_mlp_bwd)(res, jnp.asarray(_nhwc_np(g), jdt))
    assert _rel(_grad_tree(m), dp) < TOL[dtype]
    assert _rel(_nhwc_np(x.grad), dx) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("si", [0, 2])
def test_fused_block_backward_matches_block_pallas_bwd(backbone, dtype, si):
    tree, m0 = backbone
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    m = _port_copy(m0, tdt)
    blk = m.stages[si].blocks[0]
    c, h = SMALL_DIMS[si], PX // 4 >> si
    x, g = _inputs(np.random.default_rng(12 + si), 2, c, h, tdt)
    x.requires_grad_()
    out = FusedBlock.apply("default", k5.fused_convnext_block_plain, x, *blk.tensors())
    with torch.no_grad():
        want = k5.fused_convnext_block_plain(pc._nhwc(x), blk.pack_fused())
    assert torch.equal(pc._nhwc(out), want)
    out.backward(g)
    p = cast_floats(jax.tree_util.tree_map(jnp.asarray, tree["stages"][si]["blocks"][0]), jdt)
    dp, dx = jax.jit(jax_convnext._block_pallas_bwd)(
        (p, jnp.asarray(_nhwc_np(x.detach()), jdt)), jnp.asarray(_nhwc_np(g), jdt))
    assert _rel(_grad_tree(m)["stages"][si]["blocks"][0], dp) < TOL[dtype]
    assert _rel(_nhwc_np(x.grad), dx) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stage_backward_matches_stage_pallas_bwd(dtype):
    """A chain of two blocks (the small backbone has one a stage)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    bb = convnext_oracle(8, np.random.default_rng(8))
    m = pc.ConvNeXt(depths=(1, 1, 2, 1), dims=SMALL_DIMS, num_classes=10)
    sd = {k: v for k, v in bb.state_dict().items()}
    m2 = pc.ConvNeXt(depths=SMALL_DEPTHS, dims=SMALL_DIMS, num_classes=10)
    m2.load_state_dict(sd)
    with torch.no_grad():   # stage 2's second block: the first's weights, perturbed
        for name, p in m.named_parameters():
            src = name.replace("stages.2.blocks.1.", "stages.2.blocks.0.")
            q = dict(m2.named_parameters())[src]
            p.copy_(q * (1.1 if src != name else 1.0))
    m = m.to(tdt).to(memory_format=torch.channels_last)
    tree = tree_from_state_dict({k: v.float() for k, v in m.state_dict().items()}, "convnext")
    blocks = m.stages[2].blocks
    x, g = _inputs(np.random.default_rng(13), 2, SMALL_DIMS[2], PX // 16, tdt)
    x.requires_grad_()
    flat = [t for blk in blocks for t in blk.tensors()]
    out = FusedStage.apply("default", k6.fused_convnext_stage_plain, x, *flat)
    with torch.no_grad():
        want = k6.fused_convnext_stage_plain(
            pc._nhwc(x), k5.stack_blocks([b.pack_fused() for b in blocks]))
    assert torch.equal(pc._nhwc(out), want)
    out.backward(g)
    bl = cast_floats(jax.tree_util.tree_map(jnp.asarray, tree["stages"][2]["blocks"]), jdt)
    db, dx = jax.jit(jax_convnext._stage_pallas_bwd)(
        (bl, jnp.asarray(_nhwc_np(x.detach()), jdt)), jnp.asarray(_nhwc_np(g), jdt))
    assert _rel(_grad_tree(m)["stages"][2]["blocks"], db) < TOL[dtype]
    assert _rel(_nhwc_np(x.grad), dx) < TOL[dtype]


def test_folds_come_from_the_weights_of_the_call(backbone):
    """Two calls with different weights: each forward equals the kernel
    path on its own weights' folds; a module's prepared folds (serving)
    are never read."""
    _, m0 = backbone
    m = _port_copy(m0, torch.float32)
    m.prepare_kernels()
    stale = m._kernel_weights
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((1, 3, PX, PX))
                         .astype(np.float32)).contiguous(memory_format=torch.channels_last)
    kernels = (km.ln_mlp_residual_plain, km.layer_norm_rows_plain)
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(1.25)
    ft = m.feature_tensors()
    with torch.no_grad():
        out = KernelBackbone.apply(ft.layout(), "default", "", kernels, x, *ft.flat())
        fresh = features_kernels(x, ft, kernel_weights(ft), "default", *kernels)
        old = features_kernels(x, ft, stale, "default", *kernels)
    assert torch.equal(out, fresh)
    assert (out - old).abs().max() > 1e-2 * out.abs().max()


def test_feature_tensors_round_trip(backbone):
    _, m = backbone
    ft = m.feature_tensors()
    back = FeatureTensors.unflat(ft.layout(), ft.flat())
    assert [a is b for a, b in zip(back.flat(), ft.flat())] == [True] * len(ft.flat())
    assert len(ft.flat()) == sum(1 for n, _ in m.named_parameters() if not n.startswith("head"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(dtype):
    """Output and new running statistics against batch_norm(train=True)
    (statistics within 1e-6: float32 sums in another order). In bfloat16
    the old statistic is rounded to bf16 and scaled by 0.9 in bf16, as the
    JAX step computes it on its cast_floats tree: without that rounding
    the statistics would be off by far more."""
    rng = np.random.default_rng(15)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    c = 16
    x = rng.standard_normal((3, c, 5, 5)).astype(np.float32) * 2 + 0.5
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    rm32 = bn.running_mean.numpy().copy()
    bn = bn.to(tdt)
    xt = torch.from_numpy(x).to(tdt).contiguous(memory_format=torch.channels_last)
    y, (mean, var) = port_norm.batch_norm_train(xt, bn)
    params = {"scale": jnp.asarray(bn.weight.detach().float().numpy(), jdt),
              "bias": jnp.asarray(bn.bias.detach().float().numpy(), jdt),
              "mean": jnp.asarray(bn.running_mean.float().numpy(), jdt),
              "var": jnp.asarray(bn.running_var.float().numpy(), jdt)}
    yj, stats = jax_norm.batch_norm(jnp.asarray(x.transpose(0, 2, 3, 1), jdt), params, train=True)
    assert mean.dtype == var.dtype == torch.float32
    assert np.asarray(stats["mean"]).dtype == np.asarray(stats["var"]).dtype == np.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    if dtype == "bfloat16":
        unrounded = 0.9 * rm32 + 0.1 * x.mean(axis=(0, 2, 3))
        assert np.abs(unrounded - np.asarray(stats["mean"])).max() > 1e-4
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(y.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(yj, np.float32), rtol=tol, atol=tol)
    # the module's buffers are not touched
    assert float(bn.running_mean.float().sum()) == float(np.asarray(params["mean"], np.float32).sum())
