"""The probes M1 and M2 at the widths past convnext_tiny's, on the CPU: their
plans (`int8_dot.m1_plan`, `block_parts.m2_plan`) at every width the kernels
take and their refusals, the wrappers' checks against the plans, and the
plain versions against the JAX tools' bodies at C = 1024 and 1536 (a few
rows), through the jnp transcriptions of tests/test_torch_probes.py, which
cite the tools line by line. Inputs come from a numpy seed; each comparison
states its tolerance and the reason for it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genconvit_tpu_torch.ops.cuda import block_parts as m2
from genconvit_tpu_torch.ops.cuda import int8_dot as m1
from genconvit_tpu_torch.ops.cuda.convnext_block import FusedBlockWeights, check_activation
from genconvit_tpu_torch.ops.cuda.convnext_mlp import K1_MAX_C
from tests.test_torch_probes import _bf16_values, _jax_dots_bf16, _jax_dots_int8, _jax_kern, _t

BF = jnp.bfloat16
WIDTHS = list(range(32, K1_MAX_C + 1, 32))
REFUSED = [0, 16, 48, 100, K1_MAX_C + 32, 2048]
WIDE = [1024, 1536]   # convnext_base's and convnext_large's last stages


@pytest.mark.parametrize("c", WIDTHS)
def test_m1_plan_takes_every_width_and_hidden(c):
    """Every hid that is a multiple of 32 in [c, 4c]: a plan whose groups
    are 64 or 128 columns, the cheaper in columns computed (o's groups and
    z's blocks over all hid), whose ring holds at least 2 stages and fits
    the 227 KB a block may use; none off that grid."""
    for hid in range(c, 4 * c + 1, 32):
        p = m1.m1_plan(c, hid)
        assert p is not None and p.rows == 128 and p.cols in (64, 128), (c, hid)
        cost = {nc: (-(-c // nc) - (-hid // nc)) * nc for nc in (64, 128)}
        assert cost[p.cols] == min(cost.values()) and (p.cols == 128 or cost[64] < cost[128])
        assert p.stages >= 2 and p.smem == 1024 + p.stages * (16384 + 128 * p.cols) + 256
        assert p.smem <= 232448
    for hid in (c - 32, c + 16, 4 * c + 32):
        assert m1.m1_plan(c, hid) is None, (c, hid)


@pytest.mark.parametrize("c", WIDTHS)
def test_m2_plan_takes_every_width(c):
    """M2 runs K5's plan (its schedule, tiles, ring and taps) at every
    multiple of 32 up to 1536."""
    p = m2.m2_plan(c)
    assert p is not None and p.rows in (64, 128) and p.stages >= 2 and 64 * p.pairs >= c


@pytest.mark.parametrize("c", REFUSED)
def test_probe_plans_refuse_what_the_kernels_do_not_take(c):
    assert m2.m2_plan(c) is None
    for hid in (c, 3 * c, 4 * c):
        assert m1.m1_plan(c, hid) is None


@pytest.mark.parametrize("c", REFUSED + [1536])
def test_probe_wrapper_checks_follow_the_plans(c):
    """The wrappers' checks (run before a launch; on CPU tensors here)
    refuse exactly what the plans refuse, at hid = 3c and 4c."""
    bf = torch.bfloat16
    for hid in (3 * c, 4 * c):
        y, h = torch.zeros(8, c, dtype=bf), torch.zeros(8, hid, dtype=bf)
        w1, w2 = torch.zeros(hid, c, dtype=bf), torch.zeros(c, hid, dtype=bf)
        if m1.m1_plan(c, hid) is None:
            with pytest.raises(ValueError):
                m1._check("dots_bf16", (y, h), (w1, w2), bf)
        else:
            assert m1._check("dots_bf16", (y, h), (w1, w2), bf) == (8, c, hid)
    x = torch.zeros(1, 2, 2, c, dtype=bf)
    if m2.m2_plan(c) is None:
        with pytest.raises(ValueError):
            check_activation("block_parts", x)
    else:
        check_activation("block_parts", x)


def _m1_bf16(seed, rows, c, hid):
    """The tool's build('bf16') (microbench_int8_dot.py:70-75) at a few rows."""
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.standard_normal((rows, c)), BF),
            jnp.asarray(rng.standard_normal((rows, hid)), BF),
            jnp.asarray(rng.standard_normal((c, hid)) * .05, BF),
            jnp.asarray(rng.standard_normal((hid, c)) * .05, BF))


def _m1_int8(seed, rows, c, hid):
    """build('int8') (:79-86), with scales off 1 so that a scale on the
    wrong column shows."""
    rng = np.random.default_rng(seed)

    def q(shape):
        return rng.integers(-127, 127, shape).astype(np.int8)
    return (q((rows, c)), q((rows, hid)), q((c, hid)),
            rng.uniform(0.5, 2.0, hid).astype(np.float32) / 127,
            q((hid, c)), rng.uniform(0.5, 2.0, c).astype(np.float32) / 127)


@pytest.mark.parametrize("c", WIDE)
@pytest.mark.parametrize("mult", [3, 4])   # the tool's hid = 3c, K4's 4c
def test_m1_bf16_plain_matches_the_tool_at_wide_c(c, mult):
    """Both sum exact bf16 products in float32, in other orders: the one
    rounding of o + z may flip, so each element is within 1 bf16 ulp."""
    y, hh, w1, w2 = _m1_bf16(c + mult, 40, c, mult * c)
    ref = _t(_jax_dots_bf16(y, hh, w1, w2))
    args = [_t(a).to(torch.bfloat16) for a in (y, hh)]
    lw1, lw2 = (_t(w).to(torch.bfloat16).t().contiguous() for w in (w1, w2))
    got = m1.dots_bf16(*args, lw1, lw2)
    assert got.dtype == torch.bfloat16 and got.shape == (40, c)
    assert m1.ulp_error(got, ref) <= 1.0


@pytest.mark.parametrize("c", WIDE)
@pytest.mark.parametrize("mult", [3, 4])
def test_m1_int8_plain_matches_the_tool_at_wide_c_exactly(c, mult):
    """Exact integer sums on both sides, then the same float32 operations
    in the same order: bit for bit."""
    yq, hq, wq1, s1, wq2, s2 = _m1_int8(c + mult, 40, c, mult * c)
    ref = _t(_jax_dots_int8(*(jnp.asarray(a) for a in (yq, hq, wq1, s1, wq2, s2))))
    args = [torch.from_numpy(a) for a in (yq, hq)]
    lw1, lw2 = (torch.from_numpy(w).t().contiguous() for w in (wq1, wq2))
    got = m1.dots_int8(*args, lw1, torch.from_numpy(s1), lw2, torch.from_numpy(s2))
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=0)


def _m2_inputs(seed, c, n=1, h=7):
    """The tool's inputs (microbench_kernel_parts.py:119-128) at width c,
    one 7 x 7 image, no channel padding (CP = C); the depthwise weights
    bf16-representable (the probe reads K5's bf16 pack)."""
    rng = np.random.default_rng(seed)

    def mk(shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((n, h, h, c)), BF)
    e = 4 * c
    args = (_bf16_values(mk((7, 7, c))), mk((c,)), mk((c,), 1.0), mk((c,)),
            jnp.asarray(rng.standard_normal((c, e)) * .05, BF), mk((e,)),
            jnp.asarray(rng.standard_normal((e, c)) * .05, BF), mk((c,)), mk((c,), 0.5))
    dwk, dwb, lns, lnb, w1, b1, w2, b2, gam = args
    tw1, tw2 = _t(w1).to(torch.bfloat16), _t(w2).to(torch.bfloat16)
    pack = FusedBlockWeights(
        w_dw=torch.from_numpy(dwk.reshape(49, c)).to(torch.bfloat16),
        b_dw=torch.from_numpy(dwb), ln_scale=torch.from_numpy(lns),
        ln_bias=torch.from_numpy(lnb), w1=tw1, b1=torch.from_numpy(b1), w2=tw2,
        b2=torch.from_numpy(b2), gamma=torch.from_numpy(gam),
        w1t=tw1.t().contiguous(), w2t=tw2.t().contiguous())
    xp = jnp.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))
    return xp, tuple(jnp.asarray(a) for a in args), _t(x).to(torch.bfloat16), pack


# (phase, the tool's fp32dw, ulps allowed), as test_torch_probes.py holds
# them at C = 32: dma, dw, dw_bf16acc bit for bit (a copy; the same exact
# products, or the same bf16 roundings, in the same order); ln: the LN
# statistics summed in another order can flip one rounding of y; fc1, gelu:
# that and the fc1 sums in another order; full: K5's bound
@pytest.mark.parametrize("c", WIDE)
@pytest.mark.parametrize("phase,fp32dw,ulps", [
    ("dma", True, 0.0), ("dw", True, 0.0), ("dw_bf16acc", False, 0.0), ("ln", True, 1.0),
    ("fc1", True, 2.0), ("gelu", True, 2.0), ("full", True, 2.0)])
def test_m2_plain_matches_the_pallas_body_at_wide_c(c, phase, fp32dw, ulps):
    xp, args, x, pack = _m2_inputs(c + len(phase), c)
    ref = _t(_jax_kern(xp, args, "dw" if phase == "dw_bf16acc" else phase, fp32dw))
    got = m2.block_parts(x, pack, phase)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    if ulps == 0.0:
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=0)
    else:
        assert m2.ulp_error(got, ref, x, phase) <= ulps
    for name, bad in m2.planted_faults(pack, phase).items():
        assert m2.ulp_error(m2.block_parts_plain(x, bad, phase), got, x, phase) > m2.ULP_TOL, name
