"""K1 above C = 768, on the CPU: its plain version against the JAX Pallas
kernel in interpret mode at C = 1024 (float32, rtol = atol = 1e-4: the
same math, float32 sums over 1024 and 4096 terms in another order), the
port's ConvNeXt at convnext_large's widths against the JAX f32 backbone
through the weight bridge (rtol 1e-3, atol 1e-4, as test_torch_models),
its kernel wiring against its plain graph at those widths, and the Python
mirror of K1's tile plan (the card tests hold it against the library's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.ops.pallas.convnext_mlp import fused_ln_mlp_residual

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.convnext import CONVNEXT_CFGS, ConvNeXt
from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

from tests.test_torch_kernels import _block_params, _fold
from tests.torch_oracles import ConvNeXtOracle

LARGE_DIMS = CONVNEXT_CFGS["convnext_large"]["dims"]   # (192, 384, 768, 1536)
DEPTHS = (1, 1, 1, 1)
CLASSES = 10
PX = 32   # 8, 4, 2, 1 pixels a side through the four stages


@pytest.mark.parametrize("tier", ["default", "hp"])
@pytest.mark.parametrize("post_ln", [False, True])
def test_k1_plain_matches_pallas_interpret_above_768(post_ln, tier):
    c = 1024
    rng = np.random.default_rng(7 + 2 * post_ln + 4 * (tier == "hp"))
    shape = (1, 2, 3, c)
    dw = (2 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    p = _block_params(rng, c)
    post = None
    if post_ln:
        post = ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                (0.1 * rng.standard_normal(c)).astype(np.float32))
    ref = fused_ln_mlp_residual(
        jnp.asarray(dw), jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
        interpret=True, hp=tier == "hp",
        post_ln=None if post is None else tuple(map(jnp.asarray, post)))
    got = km.ln_mlp_residual_plain(
        torch.from_numpy(dw), torch.from_numpy(x), _fold(p),
        None if post is None else tuple(map(torch.from_numpy, post)), tier)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _large_tree(seed):
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    bb = ConvNeXtOracle(depths=DEPTHS, dims=LARGE_DIMS, num_classes=CLASSES).eval()
    with torch.no_grad():
        for name, p in bb.named_parameters():
            if name.endswith("gamma"):   # the 1e-6 init would make the blocks vacuous
                p.copy_(torch.from_numpy(rng.uniform(0.1, 1.0, p.shape).astype(np.float32)))
    return jax_convert.convert_convnext(bb.state_dict()), rng


def _port(tree):
    m = ConvNeXt(DEPTHS, LARGE_DIMS, CLASSES).eval()
    m.load_state_dict(state_dict_from_jax(tree, "convnext"), strict=True)
    return m.to(memory_format=torch.channels_last)


def test_convnext_at_large_widths_matches_jax():
    tree, rng = _large_tree(0)
    x_nhwc = rng.standard_normal((2, PX, PX, 3)).astype(np.float32)
    ref = jax_convnext.convnext_apply(tree, jnp.asarray(x_nhwc))
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = _port(tree)(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_kernel_wiring_at_large_widths_equals_plain_graph():
    """The kernel backbone (K2, K1 on every block with the next stage's LN
    fused, through the wrappers' CPU path, hp GELU) against the plain
    exact-GELU graph at C = 192..1536: the only difference is the 8.7e-7
    erf fit and float32 summation order."""
    tree, rng = _large_tree(1)
    x = torch.from_numpy(rng.standard_normal((1, 3, PX, PX)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    m = _port(tree)
    m.prepare_kernels()
    kcuda.reset_launch_counts()
    with torch.no_grad():
        got = m._features_kernels(x, "hp")
        ref = m._features_plain(x, "exact")
    assert set(kcuda.launch_counts().values()) == {0}
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c", sorted({c for cfg in CONVNEXT_CFGS.values() for c in cfg["dims"]}))
def test_k1_tile_plan_takes_every_convnext_width(c):
    plan = km.mlp_plan(c)
    assert plan is not None
    assert plan.rows == (128 if c <= 384 else 64)
    assert plan.cols in (96, 128, 192) and 2 <= plan.stages <= 8
    assert plan.smem <= 232448
    # fc2's groups cover C; a 64-row tile's two warpgroups take them in pairs
    groups = -(-c // plan.cols)
    assert plan.passes(c) == (groups if plan.rows == 128 else -(-groups // 2))
    assert plan.passes(c) * plan.cols * (1 if plan.rows == 128 else 2) >= c
    # from C = 768 the ring is shorter than a turn: those plans stream
    assert plan.streams(c) == (c >= 768)


@pytest.mark.parametrize("c", [0, 16, 48, 80, 100, 1000, 1568, 2048])
def test_k1_tile_plan_refuses_other_widths(c):
    assert km.mlp_plan(c) is None


def test_k1_folds_carry_the_transposed_matrices():
    rng = np.random.default_rng(3)
    f = _fold(_block_params(rng, 64))
    assert torch.equal(f.wgt, f.wg.t()) and f.wgt.is_contiguous()
    assert torch.equal(f.w2gt, f.w2g.t()) and f.w2gt.is_contiguous()
