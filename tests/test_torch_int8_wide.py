"""K4 (the int8 block tail) at the widths past convnext_tiny's, on the CPU:
its plain version against the JAX Pallas kernel in interpret mode at
C = 1024 (within one int8 step of a flipped rounding), the port's kernel
backbone under each int8 mode at convnext_large's widths against the JAX
kernel backbone in interpret mode, the Python mirror of K4's tile plan
(the card tests hold it against the library's), and the kernel k order of
'full' mode's fc2 weights (undone, it is the fold bit for bit; summed
through it, the plain version is unchanged bit for bit)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.ops import kernel_plan as jax_kernel_plan
from genconvit_tpu.ops.pallas import convnext_mlp as jax_mlp

from genconvit_tpu_torch.models.convnext import CONVNEXT_CFGS
from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_int8 import _fold_int8
from tests.test_torch_kernels import _block_params, _fold
from tests.test_torch_wide import PX, _large_tree, _port

t = torch.from_numpy
CONVNEXT_WIDTHS = sorted({c for cfg in CONVNEXT_CFGS.values() for c in cfg["dims"]})


# [1, 7, 1, C] -> R = 7 rows: ragged against every row tile of the kernel
@pytest.mark.parametrize("tier", ["default", "hp"])
@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("mode", ["fc1", "full"])
def test_k4_plain_matches_pallas_interpret_at_1024(mode, post_ln, tier):
    c = 1024
    rng = np.random.default_rng(21 + 2 * post_ln + 4 * (tier == "hp") + 8 * (mode == "full"))
    shape = (1, 7, 1, c)
    dw = (2 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    p = _block_params(rng, c)
    post = None
    if post_ln:
        post = ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                (0.1 * rng.standard_normal(c)).astype(np.float32))
    ref = np.asarray(jax_mlp.fused_ln_mlp_residual(
        jnp.asarray(dw), jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
        interpret=True, hp=tier == "hp", int8=mode,
        post_ln=None if post is None else tuple(map(jnp.asarray, post))))
    folded = _fold_int8(p, mode)
    post_t = None if post is None else tuple(map(t, post))
    got = k4.ln_mlp_residual_int8_plain(t(dw), t(x), folded, post_t, tier).numpy()
    # Both quantize the same f32 y and h up to the summation order of the LN
    # moments (and rsqrt's last bit), which is float32 noise (rows without a
    # flip agree to ~3e-7 of max|ref|). Test_torch_int8's 1e-5 of max|ref|
    # holds at C = 32 and 64; among a row's 1024 y and 4096 h roundings at
    # C = 1024, one within that noise of a midpoint flips now and then and
    # moves its row by one int8 step of that value: up to ~3e-4 of max|ref|
    # ('full' more often: its scales follow each row's maxima). One step is
    # allowed, and it is far below what the int8 math itself changes.
    tol = 5e-4 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol
    unquantized = km.ln_mlp_residual_plain(t(dw), t(x), _fold(p), post_t, tier).numpy()
    assert np.abs(unquantized - ref).max() > 10 * tol


@pytest.mark.parametrize("mode", ["fc1", "full"])
def test_int8_backbone_at_large_widths_matches_jax_kernel_backbone(mode):
    """The port's kernel backbone under each int8 mode at convnext_large's
    widths (K2, K4 on every block with the next stage's LN fused, through
    the wrappers' CPU path) against the JAX kernel backbone (Pallas in
    interpret mode) on the same tree; no kernel launches on the CPU."""
    tree, rng = _large_tree(2)
    x_nhwc = rng.standard_normal((2, PX, PX, 3)).astype(np.float32)
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(int8_mlp=mode)):
        ref = np.asarray(jax_convnext._features_mlp_kernel(tree, jnp.asarray(x_nhwc)))
    m = _port(tree)
    m.prepare_kernels(KernelPlan(int8_mlp=mode))
    x = t(x_nhwc).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    kcuda.reset_launch_counts()
    with torch.no_grad():
        got = m._features_kernels(x, "default", mode).permute(0, 2, 3, 1).numpy()
    assert set(kcuda.launch_counts().values()) == {0}
    if mode == "fc1":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        # 'full' quantizes y and h with each row's own max: their last bits
        # follow the summation order of the LN moments, a flipped rounding
        # moves its row by one int8 step, and the later blocks carry it on,
        # so at these widths the two agree to the int8 noise (up to ~5e-3
        # of max|ref| over seeds), not to float32
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["fc1", "full"])
@pytest.mark.parametrize("c", CONVNEXT_WIDTHS)
def test_k4_tile_plan_takes_every_convnext_width(c, mode):
    plan = k4.k4_plan(c, mode)
    assert plan is not None
    assert (plan.rows, plan.cols, plan.kbs) in k4._K4_CANDIDATES[mode]
    assert plan.smem <= 232448 and plan.stages <= 8
    # the ring holds a turn: every fc1 stage of a chunk and its fc2 stages
    nkb = -(-c // 128)
    assert plan.stages >= -(-nkb // plan.kbs) + (1 if plan.rows == 128 else 2)
    # fc2's groups cover C; a 64-row tile's two warpgroups take them in pairs
    assert plan.passes(c) * plan.cols * (1 if plan.rows == 128 else 2) >= c
    # int8 y is half K1's bytes: 128-row tiles reach C = 1024 in 'full'
    assert plan.rows == (128 if c <= (1024 if mode == "full" else 768) else 64)


@pytest.mark.parametrize("c", [0, 16, 48, 80, 1000, 1568, 2048])
def test_k4_tile_plan_refuses_other_widths(c):
    assert k4.k4_plan(c, "fc1") is None and k4.k4_plan(c, "full") is None


def test_k4_tile_plan_takes_every_multiple_of_32():
    for mode in k4.MODES:
        plans = {c: k4.k4_plan(c, mode) for c in range(32, k4.K4_MAX_C + 1, 32)}
        assert all(p is not None for p in plans.values())
        # every candidate the source builds is some width's plan
        assert {(p.rows, p.cols, p.kbs) for p in plans.values()} == set(k4._K4_CANDIDATES[mode])
    with pytest.raises(ValueError, match="mode"):
        k4.k4_plan(96, "w8")


def test_kernel_k_order_is_the_accumulator_to_fragment_map():
    """Thread t of a quad holds s32 accumulator columns 2t, 2t+1, 8+2t,
    9+2t, 16+2t, 17+2t, 24+2t, 25+2t of a 32-block (wgmma's D layout, in
    register order); its s8 k32 A fragment holds k 4t..4t+3 and
    16+4t..19+4t (mma.sync m16n8k32's A layout): the kernel packs the one
    into the other in order, so position p holds hidden order[p]."""
    order = [None] * 32
    for th in range(4):
        acc = [2 * th, 2 * th + 1, 8 + 2 * th, 9 + 2 * th,
               16 + 2 * th, 17 + 2 * th, 24 + 2 * th, 25 + 2 * th]
        frag = [4 * th + e for e in range(4)] + [16 + 4 * th + e for e in range(4)]
        for pos, col in zip(frag, acc):
            order[pos] = col
    assert tuple(order) == k4.KERNEL_K_ORDER
    assert sorted(k4.KERNEL_K_ORDER) == list(range(32))


@pytest.mark.parametrize("c", [32, 96, 1024])
def test_kernel_order_undone_is_the_fold_and_sums_the_same(c):
    rng = np.random.default_rng(40 + c)
    f = _fold_int8(_block_params(rng, c), "full")
    assert f.wq2k.shape == f.wq2.shape == (c, 4 * c) and f.wq2k.is_contiguous()
    assert not torch.equal(f.wq2k, f.wq2)
    undo = torch.tensor(np.argsort(k4.KERNEL_K_ORDER))
    undo = (torch.arange(4 * c) // 32 * 32).reshape(-1, 32) + undo
    assert torch.equal(f.wq2k[:, undo.reshape(-1)], f.wq2)
    dw = t((2 * rng.standard_normal((3, 5, c)) + 0.3).astype(np.float32))
    x = t(rng.standard_normal((3, 5, c)).astype(np.float32))
    post = (t((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)),
            t((0.1 * rng.standard_normal(c)).astype(np.float32)))
    for p in (None, post):
        want = k4.ln_mlp_residual_int8_plain(dw, x, f, p)
        got = k4.ln_mlp_residual_int8_plain(dw, x, f, p, kernel_k_order=True)
        assert torch.equal(got, want)
    # 'fc1' keeps w2g transposed for the kernel, bit for bit
    g = _fold_int8(_block_params(rng, c), "fc1")
    assert g.wq2k is None and torch.equal(g.w2t, g.w2g.t()) and g.w2t.is_contiguous()

