"""K7 (Swin window attention) and K2 (row LayerNorm) of the port against the
JAX package on the CPU, at the widths and head counts of their Hopper
designs: the plain versions against the Pallas kernels in interpret mode
(float32: K7 at 2e-4 as tests/test_pallas.py holds the kernel, K2 at 1e-5,
the same math up to float32 summation order), K7's work-item plan mirror
(every window-head and query strip exactly once, the ring and shared
memory inside the card's limits), the fragment order in which K7 stages
the bias and reads the mask (and the wrapper's staged mask), the planted
faults of the new design, and K2's choice of instantiation by width."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genconvit_tpu.ops.pallas import window_attn as jax_k7
from genconvit_tpu.ops.pallas.convnext_mlp import layer_norm_rows as jax_layer_norm_rows

from genconvit_tpu_torch.models import swin as port_swin
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.cuda import window_attn as k7

# (heads, windows per image) of swin_tiny's and swin_large's four stages
STAGES = ((3, 64), (6, 16), (12, 4), (24, 1), (6, 64), (12, 16), (24, 4), (48, 1))


def _k7_case(rng, b, l, heads, hd, nw, masked):
    """qkv [B, L, 3C] and the JAX kernel's operands: q, k, v [G, L, hd] head
    fastest, bias [heads, L, L] O(1), a shifted-window mask of nw windows."""
    w = int(round(l ** 0.5))
    qkv = rng.standard_normal((b, l, 3, heads, hd)).astype(np.float32)
    bias = rng.standard_normal((heads, l, l)).astype(np.float32)
    mask = None
    if masked:
        side = w * int(round(nw ** 0.5))
        mask = port_swin.shifted_window_mask(side, side, w, w // 2)
    qkvj = [qkv[:, :, i].transpose(0, 2, 1, 3).reshape(b * heads, l, hd) for i in range(3)]
    return qkv.reshape(b, l, -1), qkvj, bias, mask


def _pallas_k7(qkvj, bias, mask, b, l, heads, hd, nw):
    ref = jax_k7.window_attention_pallas(
        *(jnp.asarray(a) for a in qkvj), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), heads=heads,
        windows_per_mask=nw, interpret=True)
    ref = np.asarray(ref).reshape(b, heads, l, hd)
    return ref.transpose(0, 2, 1, 3).reshape(b, l, heads * hd)


# -- K7's plain version against the Pallas kernel, at heads = 3 (one item
# holds the whole window) and where the plan splits the heads into groups

@pytest.mark.parametrize("heads,hd,masked", [(3, 32, True), (3, 32, False), (6, 32, True),
                                             (4, 64, False)])
def test_k7_plain_matches_pallas_at_the_plan_groups(heads, hd, masked):
    l, nw, b = 49, 4, 8
    plan = k7.k7_plan(l, heads, hd, masked, b)
    assert (plan.group == heads) == (heads == 3)   # 6 heads of 32: G = 2; 4 of 64: G = 1
    rng = np.random.default_rng(heads + hd + masked)
    qkv, qkvj, bias, mask = _k7_case(rng, b, l, heads, hd, nw, masked)
    ref = _pallas_k7(qkvj, bias, mask, b, l, heads, hd, nw)
    got = k7.window_attention_plain(torch.from_numpy(qkv), torch.from_numpy(bias),
                                    None if mask is None else torch.from_numpy(mask), heads, nw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


# -- the plan mirror: every window-head and strip exactly once

@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("nw", [64, 16, 4, 1])
@pytest.mark.parametrize("heads", [3, 6, 12, 24, 48])
def test_k7_plan_covers_every_window_head_once(heads, nw, hd, masked):
    windows = 2 * nw + 1     # ragged against every head group's blocks
    plan = k7.k7_plan(49, heads, hd, masked, windows)
    assert plan is not None and plan.strips == 4
    assert plan.group * plan.strips * plan.teams <= k7.MAX_WARPS and plan.teams <= k7.MAX_TEAMS
    fits = [d for d in range(1, heads + 1) if heads % d == 0 and 4 * d <= k7.MAX_WARPS
            and k7.SMEM_LIMIT - 1280 - k7.k7_bias_bytes(d, 4, 49)
            >= 2 * k7.k7_stage_bytes(d, 4, hd, 49, masked)]
    wide = [d for d in fits if d * hd >= 64]
    assert plan.group in wide if wide else plan.group == max(fits)
    assert plan.threads == 32 * plan.teams * plan.group * plan.strips
    assert plan.smem <= k7.SMEM_LIMIT
    assert plan.stages >= 2   # every team computes one item while the next one loads
    assert plan.smem >= plan.teams * plan.stages * k7.k7_stage_bytes(plan.group, 4, hd, 49,
                                                                      masked)
    assert plan.blocks <= 132 or heads // plan.group > 132
    seen = {}
    for blk, item, slot, warp, win, head, strip in k7.k7_schedule(plan, heads, windows):
        assert 0 <= slot < plan.teams * plan.stages
        assert warp < plan.teams * plan.group * plan.strips
        key = (win, head, strip)
        assert key not in seen, (key, seen.get(key), blk)
        seen[key] = (blk, item, warp)
    assert len(seen) == windows * heads * 4
    # one head group per block, for its life
    groups = {}
    for blk, _, _, _, _, head, _ in k7.k7_schedule(plan, heads, windows):
        groups.setdefault(blk, set()).add(head // plan.group)
    assert all(len(g) == 1 for g in groups.values())


def test_k7_plan_at_the_swin_stage_shapes_fills_the_card():
    """At N = 120 every swin_tiny and swin_large stage takes all 132 SMs,
    and the first stage of swin_tiny is one item per window (G = 3)."""
    for heads, nw in STAGES:
        for masked in (True, False):
            plan = k7.k7_plan(49, heads, 32, masked, 120 * nw)
            assert plan.blocks == 132, (heads, nw, masked, plan)
            assert plan.group * 32 >= 64
    assert k7.k7_plan(49, 3, 32, True, 7680).group == 3
    assert k7.k7_plan(81, 3, 32, True, 8) is None
    assert k7.k7_plan(49, 3, 24, True, 8) is None


# -- the fragment order of the staged mask and the held bias

@pytest.mark.parametrize("l", [49, 16, 9])
def test_k7_fragments_unpack_to_the_plain_bias_and_mask(l):
    """What a warp (strip s) adds to its scores, bias fragments plus mask
    fragments, unpacked, equals the plain version's bias[head] + mask[win]
    for every head and window; each fragment element sits where the m16n8
    accumulator of mma.sync holds (row, key)."""
    rng = np.random.default_rng(l)
    heads, nw = 3, 4
    w = int(round(l ** 0.5))
    bias = torch.from_numpy(rng.standard_normal((heads, l, l)).astype(np.float32))
    mask = torch.from_numpy(port_swin.shifted_window_mask(2 * w, 2 * w, w, w // 2))
    fb, fm = k7.to_fragments(bias), k7.to_fragments(mask)
    s, nt = -(-l // 16), -(-l // 8)
    assert fb.shape == (heads, s, nt, 32, 4) and fm.shape == (nw, s, nt, 32, 4)
    for win in range(2 * nw):
        for head in range(heads):
            got = k7.from_fragments(fb[head] + fm[win % nw], l)
            torch.testing.assert_close(got, bias[head] + mask[win % nw], rtol=0, atol=0)
    # the accumulator layout: lane 4 g + t holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
    lane, e, strip, tile = 13, 3, s - 1, nt - 1
    r, col = 16 * strip + lane // 4 + 8, 8 * tile + 2 * (lane % 4) + 1
    want = bias[0, r, col] if r < l and col < l else 0.0
    assert fb[0, strip, tile, lane, e] == want


# -- the planted faults of the new design, refused by the card's check

@pytest.mark.parametrize("heads,masked", [(6, True), (6, False), (3, True)])
def test_k7_planted_faults_of_the_new_design_are_refused(heads, masked):
    """The card's K7 check (ulp_error <= ULP_TOL) with the plain version as
    the kernel: each fault the design could commit (the ring off by one
    stage, the bias of the neighbouring head group, the last strip's valid
    row dropped, the mask of the window before) fails it."""
    rng = np.random.default_rng(7 + heads + masked)
    l, hd, nw, b = 49, 32, 4, 9
    qkv, _, bias, mask = _k7_case(rng, b, l, heads, hd, nw, masked)
    qkv = torch.from_numpy(qkv).to(torch.bfloat16)
    bias = torch.from_numpy(bias)
    mask = None if mask is None else torch.from_numpy(mask)
    wpm = nw if masked else 1
    ref = k7.window_attention_plain(qkv, bias, mask, heads, wpm)
    faults = k7.planted_outputs(k7.window_attention_plain, qkv, bias, mask, heads, nw)
    want = {"ring off by one stage", "last strip's valid rows dropped"}
    if heads > k7.k7_plan(l, heads, hd, masked, b).group:
        want.add("bias of the neighbouring head group")
    if masked:
        want.add("mask of the window before")
    assert want <= set(faults)
    for name in want:
        assert k7.ulp_error(faults[name], ref, heads) > k7.ULP_TOL, name


# -- K2 at the stem widths of convnext_tiny and convnext_large

@pytest.mark.parametrize("c", [96, 192])
def test_k2_plain_matches_pallas_at_the_stem_widths(c):
    rng = np.random.default_rng(20 + c)
    x = (3 * rng.standard_normal((2, 7, 9, c)) + 0.5).astype(np.float32)   # 126 rows
    s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jax_layer_norm_rows(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), interpret=True)
    got = km.layer_norm_rows_plain(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_k2_instantiation_is_chosen_by_width_alone():
    """The stem widths take their own instantiation (a row in 4 or 8 lanes'
    registers), every other multiple of 32 the generic one; the wrapper's
    refusals are unchanged (C % 32 != 0)."""
    assert km.k2_plan(96) == km.K2Plan(4, 3, 0)
    assert km.k2_plan(128) == km.K2Plan(4, 4, 0)
    assert km.k2_plan(192) == km.K2Plan(8, 3, 0)
    for c in km.K2_WIDTHS:
        p = km.k2_plan(c)
        assert 8 * p.lanes * p.chunks == c and 32 % p.lanes == 0
    for c in range(32, 4096 + 1, 32):
        if c not in km.K2_WIDTHS:
            assert km.k2_plan(c) == km.K2Plan(32, 4, 1)
    for c in (0, 16, 48, 100, -32):
        assert km.k2_plan(c) is None


def test_k7_staged_mask_is_the_fragment_order_of_each_window():
    """The wrapper hands the kernel each window's mask in `to_fragments`
    order, one gather per launch; past L it may hold any finite value (the
    kernel's bias is -inf on those keys, and those rows are never stored)."""
    mask = torch.from_numpy(port_swin.shifted_window_mask(14, 14, 7, 3))
    staged = k7.staged_mask(mask)
    assert staged.shape == (4, 4 * 7 * 128) and staged.is_contiguous()
    frag = k7.to_fragments(mask)
    staged = staged.view(frag.shape)
    ones = k7.to_fragments(torch.ones(49, 49)).bool()
    torch.testing.assert_close(staged[:, ones], frag[:, ones], rtol=0, atol=0)
    assert torch.isfinite(staged).all()
    torch.testing.assert_close(k7.from_fragments(staged * ones, 49), mask, rtol=0, atol=0)
