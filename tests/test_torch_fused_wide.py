"""K5 and K6 above C = 768, on the CPU: K6's plain version against the JAX
Pallas kernel in interpret mode at C = 1024 and 1536 (float32, rtol = atol
= 1e-4: the same math, float32 sums over C and 4C terms in another order),
the Python mirrors of the two kernels' plans (the card tests hold them
against the library's), the K-major packs the kernels read, their stacked
3-D layout, and the 'stage' launch plan of convnext_large and
convnext_base against the JAX rule."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genconvit_tpu.ops.pallas.convnext_stage import fused_convnext_stage as jax_k6

from genconvit_tpu_torch.models.convnext import (CONVNEXT_CFGS, Block, block_kernel_applies,
                                                 stage_kernel_applies)
from genconvit_tpu_torch.ops.cuda import convnext_block as k5
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

from tests.test_torch_fused import _block_params, _jax_dispatch, _jnp, _pack, _port_dispatch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "genconvit_tpu_torch", "csrc")


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("c", [1024, 1536])
def test_k6_plain_matches_pallas_interpret_wide(c, nb):
    rng = np.random.default_rng(c + nb)
    x = rng.standard_normal((1, 7, 7, c)).astype(np.float32)
    ps = [_block_params(rng, c) for _ in range(nb)]
    ref = jax_k6(jnp.asarray(x), [_jnp(p) for p in ps], interpret=True)
    got = k6.fused_convnext_stage_plain(torch.from_numpy(x),
                                        k5.stack_blocks([_pack(p) for p in ps]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _instantiations():
    """(rows, NC, streams, pairs) of every kernel block_wgmma.cuh builds."""
    with open(os.path.join(_CSRC, "block_wgmma.cuh")) as f:
        src = f.read()
    out = set()
    for nc, cols, stream, pairs in re.findall(
            r"launch_block_inst<Gelu, (\d+), (true|false), (true|false), (\d+), Stop>", src):
        out.add((64 if cols == "true" else 128, int(nc), stream == "true", int(pairs)))
    return out


_WIDTHS = sorted({c for cfg in CONVNEXT_CFGS.values() for c in cfg["dims"]}
                 | set(range(32, km.K1_MAX_C + 1, 32)))


@pytest.mark.parametrize("c", _WIDTHS)
def test_k5_plan_mirror_at_every_width(c):
    """K5's plan is K1's tile plan; a lane's taps cover every channel pair
    (pairs >= C / 64, 8 pairs of an 8-row run at most held in registers);
    and the kernel is instantiated for the plan's combination."""
    p = k5.k5_plan(c)
    assert p is not None and p[:4] == tuple(km.mlp_plan(c))
    assert 64 * p.pairs >= c > 64 * p.pairs // 2 - 64 or p.pairs == 2
    assert (p.pairs <= 6) == (p.rows == 128)
    assert (p.rows, p.cols, km.mlp_plan(c).streams(c), p.pairs) in _instantiations()
    s = k6.k6_plan(c, 240, 7, 7)
    assert s[:5] == tuple(p) and 1 <= s.images <= 240


def test_block_kernels_are_instantiated_for_every_plan_and_no_more():
    want = {(p.rows, p.cols, km.mlp_plan(c).streams(c), p.pairs)
            for c in range(32, km.K1_MAX_C + 1, 32) for p in [k5.k5_plan(c)]}
    assert _instantiations() == want


@pytest.mark.parametrize("c", [0, 16, 48, 100, km.K1_MAX_C + 32, 2048])
def test_block_plans_refuse_what_the_kernels_do_not_take(c):
    assert k5.k5_plan(c) is None and k6.k6_plan(c, 2, 7, 7) is None


# (c, n, h, images per item): the five chains of a convnext_tiny ensemble
# forward, convnext_large's C = 1536 and convnext_base's stage 0
@pytest.mark.parametrize("c,n,h,images", [(384, 240, 14, 2), (768, 240, 7, 2),
                                          (384, 120, 14, 1), (768, 120, 7, 1),
                                          (384, 120, 7, 2), (1536, 240, 7, 2),
                                          (128, 240, 56, 2)])
def test_k6_images_per_item(c, n, h, images):
    """The fewest rounds of items over 132 SMs times an item's row tiles,
    and of equal costs the most images."""
    p = k6.k6_plan(c, n, h, h)
    assert p.images == images

    def cost(g):
        return -(-(-(-n // g)) // 132) * -(-(g * h * h) // p.rows)
    best = min(cost(g) for g in range(1, n + 1))
    assert cost(images) == best and all(cost(g) > best for g in range(images + 1, n + 1))


def test_packs_hold_the_torch_layouts():
    """w1t and w2t are fc1.weight and fc2.weight as stored (the kernels'
    K-major operands), the transposes of w1 and w2."""
    torch.manual_seed(0)
    blk = Block(64).to(torch.bfloat16)
    p = blk.pack_fused()
    assert torch.equal(p.w1t, blk.mlp.fc1.weight) and torch.equal(p.w2t, blk.mlp.fc2.weight)
    assert torch.equal(p.w1t, p.w1.t()) and torch.equal(p.w2t, p.w2.t())
    assert p.w1t.shape == (256, 64) and p.w2t.shape == (64, 256)
    assert p.w1t.is_contiguous() and p.w2t.is_contiguous()
    assert k5.kernel_operands(p)[4] is p.w1t and k5.kernel_operands(p)[6] is p.w2t


def _bf16_pack(rng, c):
    """A block's pack with its matrices in bf16, as the kernels take it."""
    return k5.FusedBlockWeights(*(t.to(torch.bfloat16) if t.dim() == 2 else t
                                  for t in _pack(_block_params(rng, c))))


def test_stacked_packs_are_block_major():
    """A chain's stack: block b's matrices at b times their size, what the
    kernel's 3-D tensor maps (block index outermost) read."""
    rng = np.random.default_rng(3)
    c, nb = 32, 3
    packs = [_bf16_pack(rng, c) for _ in range(nb)]
    stack = k5.stack_blocks(packs)
    assert stack.w1t.shape == (nb, 4 * c, c) and stack.w2t.shape == (nb, c, 4 * c)
    assert stack.w1t.stride() == (4 * c * c, c, 1) and stack.w2t.stride() == (4 * c * c, 4 * c, 1)
    for b in range(nb):
        assert torch.equal(k6.chain_block(stack, b).w1t, packs[b].w1t)
        assert torch.equal(k6.chain_block(stack, b).w2t, packs[b].w2t)
    prefix = k6.chain_prefix(stack, 2)
    assert prefix.w2t.shape == (2, c, 4 * c) and prefix.w2t.data_ptr() == stack.w2t.data_ptr()
    for name in ("w1t", "w2t"):
        k5.check_weights("stack", stack, c, torch.device("cpu"), (nb,), fields=(name,))


def test_weight_checks_name_a_pack_without_the_kernel_layout():
    rng = np.random.default_rng(4)
    p = _bf16_pack(rng, 32)._replace(w1t=None)
    with pytest.raises(ValueError, match="lacks w1t"):
        k5.check_weights("k5", p, 32, torch.device("cpu"), fields=("w1t",))


# (backbone, K6 launches per ensemble forward): ED and VAE x at 224 px, the
# VAE's reconstruction at 112
@pytest.mark.parametrize("name,launches", [("convnext_large", 8), ("convnext_base", 11)])
def test_stage_launch_plan_of_the_wide_backbones(name, launches, monkeypatch):
    """convnext_large under pallas='stage': ED and VAE x at stages 1-3, x_hat
    at stages 1-2 (C = 192 is no multiple of 128; x_hat's stage 3 is 3 px);
    convnext_base at every stage but x_hat's last. The JAX rule and the
    port's dispatch give the same (H, C)."""
    cfg = CONVNEXT_CFGS[name]
    count, k5_count = 0, 0
    for px in (224, 224, 112):
        hs = [(px // 4) >> si for si in range(4)]
        want = sorted((h, c) for h, c in zip(hs, cfg["dims"]) if stage_kernel_applies(h, c))
        assert _jax_dispatch(name, px, "stage", monkeypatch) == want
        assert _port_dispatch(name, px, "stage", monkeypatch) == want
        assert all(c <= km.K1_MAX_C and k6.k6_plan(c, 240, h, h) for h, c in want)
        count += len(want)
        k5_widths = [c for h, c in zip(hs, cfg["dims"]) if block_kernel_applies(h)]
        assert all(k5.k5_plan(c) for c in k5_widths)   # pallas='1' too: up to C = 384
        k5_count += sum(d for h, d in zip(hs, cfg["depths"]) if block_kernel_applies(h))
    assert count == launches and k5_count == 15
