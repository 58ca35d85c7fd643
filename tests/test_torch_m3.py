"""M3 (ops/cuda/dw_moments.py, tools/microbench_dwshift.py) on the CPU: the
bound's count of the taps that lie inside the image, against a brute-force
count; the per-forward bound at the LN-folded block shapes; `m3_plan` at
every even C up to 1536 and H up to 56; the planted faults of the kernel's
design, each refused by the check the card applies to the plain version's
outputs."""

import itertools

import numpy as np
import pytest
import torch

from genconvit_tpu_torch.models.convnext import block_kernel_applies
from genconvit_tpu_torch.ops.cuda import dw_moments as m3
from genconvit_tpu_torch.tools import _timing
from genconvit_tpu_torch.tools.kernel_ab import CALLS, DEPTHS, DIMS
from genconvit_tpu_torch.tools.microbench_dwshift import dw_bound, in_image_taps


def _brute_taps(h, w):
    """Taps (pixel, dy, dx) whose input pixel lies inside an h x w image."""
    return sum(1 for y, x, dy, dx in itertools.product(range(h), range(w), range(7), range(7))
               if 0 <= y + dy - 3 < h and 0 <= x + dx - 3 < w)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 3), (7, 7), (14, 14), (56, 56), (3, 14), (9, 2)])
def test_dw_bound_counts_the_taps_inside_the_image(h, w):
    n, c = 3, 40
    assert in_image_taps(h) * in_image_taps(w) == _brute_taps(h, w)
    ops = 2 * n * c * _brute_taps(h, w)
    nbytes = n * h * w * (4 * c + 8) + 4 * 50 * c
    want = max(nbytes / _timing.HBM, ops / _timing.FP32) * 1e3
    ms, side = dw_bound(n, h, w, c)
    assert ms == pytest.approx(want, rel=1e-12)
    assert side == ("bytes" if nbytes / _timing.HBM >= ops / _timing.FP32 else "operations")


def test_dw_bound_per_forward_at_the_ln_folded_blocks():
    """The 7 shapes of the LN-folded blocks under pallas='1' (the blocks
    K5's rule leaves out), each as often as a V=8 forward runs it (39):
    0.3861 ms, bound by the bytes at every shape; at the JAX tool's default
    (240 x 56^2 x 96) the taps bound it, 0.0993 ms."""
    shapes = [(n, (px // 4) >> si, c, DEPTHS[si]) for n, px in CALLS
              for si, c in enumerate(DIMS) if not block_kernel_applies((px // 4) >> si)]
    assert len(shapes) == 7 and sum(d for *_, d in shapes) == 39
    bounds = [dw_bound(n, h, h, c) for n, h, c, _ in shapes]
    assert {side for _, side in bounds} == {"bytes"}
    total = sum(d * ms for (_, _, _, d), (ms, _) in zip(shapes, bounds))
    assert round(total, 4) == 0.3861
    ms, side = dw_bound(240, 56, 56, 96)
    assert (round(ms, 4), side) == (0.0993, "operations")


def test_m3_plan_takes_every_even_width_and_height():
    """Every even C from 2 to 1536 at every H = W from 1 to 56 has a plan
    that fits the card: a TMA box of at most 256 per dimension (32 g
    channels), task tiles of at most 7 rows that cover the item, two or more
    stages in the shared memory a block may use. Odd C has none."""
    for h, c in itertools.product(range(1, 57), range(2, 1537, 2)):
        p = m3.m3_plan(h, h, c)
        assert p is not None, (h, c)
        assert 1 <= p.g <= 8 and p.tr <= 256 and p.tc <= 256 and p.th <= 7
        assert 2 <= p.stages <= 4 and p.smem <= 232448
        assert p.nr * m3.RUN >= p.bw == min(h, 56) and p.nt * p.th >= p.bh > (p.nt - 1) * p.th
        assert p.tr == p.bh + (6 if p.bh < h else 0) and p.tc == p.bw + (6 if p.bw < h else 0)
        assert p.tma == (c % 8 == 0)
    for c in (1, 3, 97):
        assert m3.m3_plan(7, 7, c) is None
    assert m3.m3_plan(0, 7, 96) is None and m3.m3_plan(7, 0, 96) is None


@pytest.mark.parametrize("h,w,c,want", [
    (14, 14, 384, (14, 14, 7, 2, 2, 4, 14, 14, 2)),    # ED / VAE s2: 16 tasks, 3 slices
    (7, 7, 768, (7, 7, 4, 2, 1, 8, 7, 7, 2)),          # s3: tiles of 4 and 3 rows
    (7, 7, 384, (7, 7, 4, 2, 1, 6, 7, 7, 3)),          # x_hat s2: 2 slices of 6 groups
    (14, 14, 192, (14, 14, 7, 2, 2, 3, 14, 14, 3)),    # x_hat s1: 2 slices of 3 groups
    (3, 3, 768, (3, 3, 2, 2, 1, 8, 3, 3, 3)),          # x_hat s3
    (56, 56, 96, (14, 56, 7, 2, 8, 1, 20, 56, 2)),     # the tool's default: bands of 14 rows
    (250, 250, 64, (14, 56, 7, 2, 8, 1, 20, 62, 2)),   # bands of rows and of columns
])
def test_m3_plan_at_the_card_shapes(h, w, c, want):
    """(bh, bw, th, nt, nr, g, tr, tc, stages): the whole image where two
    stages fit, 16 tasks a slice where the channels allow."""
    assert tuple(m3.m3_plan(h, w, c))[:9] == want


def _inputs(n, h, w, c, seed):
    """x that differs between images, bf16-representable weights."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((7, 7, c)).astype(np.float32) * 0.05)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.05)
    return x, k.to(torch.bfloat16).float(), b


@pytest.mark.parametrize("n,h,w,c", [(2, 14, 14, 96), (3, 7, 7, 200), (2, 9, 9, 6),
                                     (2, 3, 3, 768)])
def test_m3_design_faults_are_refused(n, h, w, c):
    """The halo taken from the image before, and the last slice left out of
    the moments: each, through the plain version, fails the card's check.
    The first moves only the rows within 6 of the top and bottom edges."""
    x, k, b = _inputs(n, h, w, c, seed=h + c)
    ref = m3.dw_moments_plain(x, k, b)
    bad_x = m3.halo_from_neighbour(x)
    out = m3.dw_moments_plain(bad_x, k, b)
    assert not m3.agrees(m3.ulp_error(out, ref))
    moved = (out[0] != ref[0]).flatten(2).any(-1).any(0)   # [H]
    assert moved[: min(h, 6)].all() and moved[max(0, h - 6):].all()
    assert not moved[6:h - 6].any()
    out = m3.moments_without_last_slice(x, k, b)
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)
    err = m3.ulp_error(out, ref)
    assert err["dw_ulps"] == 0 and not m3.agrees(err)


def test_m3_fault_helpers_leave_their_inputs():
    x, k, b = _inputs(2, 7, 7, 32, seed=1)
    before = x.clone()
    m3.halo_from_neighbour(x)
    m3.moments_without_last_slice(x, k, b)
    torch.testing.assert_close(x, before, rtol=0, atol=0)
