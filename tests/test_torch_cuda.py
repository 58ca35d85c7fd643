"""The port's CUDA kernels against their plain PyTorch versions on the card,
in bf16: max|diff| / max|ref| <= 3e-2 (the on-card tolerance of the JAX
package's tools/onchip_parity.py) and every element within km.ULP_TOL bf16
ulps, since both versions round at the same points. Marked `cuda`: they
skip without a GPU.
This file imports no JAX, so on a machine with the card but without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from genconvit_tpu_torch.ops.cuda import convnext_mlp as km

TOL = 3e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _agrees(out, ref, x=None, scale=None):
    return _rel(out, ref) <= TOL and km.bf16_ulp_error(out, ref, x, scale) <= km.ULP_TOL


def _branch_max(dw, folded, tier="default"):
    """max|bf16(o)|, K1's output at x = 0: the scale floor of its check."""
    zero = torch.zeros_like(dw)
    return km.ln_mlp_residual_plain(dw, zero, folded, None, tier).float().abs().max().item()


def _folded(c, dev, g):
    def r(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=g)
    return km.fold_block_mlp(1 + r(c, s=0.1), r(c, s=0.1), r(4 * c, c, s=c ** -0.5),
                             r(4 * c, s=0.05), r(c, 4 * c, s=(4 * c) ** -0.5),
                             r(c, s=0.05), 0.1 + 0.9 * torch.rand(c, device=dev, generator=g),
                             torch.bfloat16)


@pytest.mark.parametrize("tier", ["default", "hp"])
@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("c", [96, 128, 192, 384, 768])  # 128: run-time width
def test_k1_matches_plain(dev, c, post_ln, tier):
    g = torch.Generator(device=dev).manual_seed(c)
    rows = 1037  # ragged against every row tile
    dw = (2 * torch.randn(rows, c, device=dev, generator=g)).to(torch.bfloat16)
    x = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
    folded = _folded(c, dev, g)
    post = None
    if post_ln:
        post = ((1 + 0.1 * torch.randn(c, device=dev, generator=g)).float(),
                (0.1 * torch.randn(c, device=dev, generator=g)).float())
    before = km.ln_mlp_residual.launches
    out = km.ln_mlp_residual(dw, x, folded, post, tier)
    torch.cuda.synchronize()
    assert km.ln_mlp_residual.launches == before + 1
    ref = km.ln_mlp_residual_plain(dw, x, folded, post, tier)
    if post_ln:
        assert _agrees(out, ref, None, ref.float().abs().max().item())
    else:
        assert _agrees(out, ref, x, _branch_max(dw, folded, tier))


@pytest.mark.parametrize("c", [96, 192, 384, 768])
def test_k1_mlp_branch_alone_matches_plain(dev, c):
    """x = 0: the output is bf16(o), so the MLP is the whole signal."""
    g = torch.Generator(device=dev).manual_seed(100 + c)
    dw = (2 * torch.randn(517, c, device=dev, generator=g)).to(torch.bfloat16)
    zero = torch.zeros_like(dw)
    folded = _folded(c, dev, g)
    out = km.ln_mlp_residual(dw, zero, folded)
    ref = km.ln_mlp_residual_plain(dw, zero, folded)
    o_max = ref.float().abs().max().item()
    assert _agrees(out, ref, zero, o_max)
    # and the check refuses a K1 that drops the fc2 bias
    dropped = folded._replace(b2g=torch.zeros_like(folded.b2g))
    assert not _agrees(km.ln_mlp_residual(dw, zero, dropped), ref, zero, o_max)


def test_k2_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (3 * torch.randn(2, 37, 29, 96, device=dev, generator=g)).to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(96, device=dev, generator=g)).float()
    b = (0.1 * torch.randn(96, device=dev, generator=g)).float()
    out = km.layer_norm_rows(x, s, b)
    torch.cuda.synchronize()
    assert out.shape == x.shape
    assert _agrees(out, km.layer_norm_rows_plain(x, s, b))


# K2 at each width with its own instantiation and at generic widths (one
# past the registers' 1024 columns), rows ragged against a block's rows
@pytest.mark.parametrize("c", [96, 128, 192, 64, 320, 1056])
def test_k2_at_every_instantiation(dev, c):
    g = torch.Generator(device=dev).manual_seed(c)
    x = (3 * torch.randn(1013, c, device=dev, generator=g) + 0.5).to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).float()
    b = (0.1 * torch.randn(c, device=dev, generator=g)).float()
    before = km.layer_norm_rows.launches
    out = km.layer_norm_rows(x, s, b)
    torch.cuda.synchronize()
    assert km.layer_norm_rows.launches == before + 1
    ref = km.layer_norm_rows_plain(x, s, b)
    assert _agrees(out, ref)
    assert not _agrees(km.layer_norm_rows(x, s, 0 * b), ref)   # LN bias dropped
    assert km.library_k2_plan(c) == km.k2_plan(c)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    folded = _folded(96, dev, g)
    x = torch.randn(64, 96, device=dev, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        km.ln_mlp_residual(x.float(), x.float(), folded)
    with pytest.raises(ValueError, match="contiguous"):
        km.ln_mlp_residual(x.t().contiguous().t(), x, folded)
    with pytest.raises(ValueError, match="multiple of 32"):
        km.layer_norm_rows(x[:, :48].contiguous(), folded.b2g[:48].contiguous(),
                           folded.b2g[:48].contiguous())
    with pytest.raises(ValueError, match="devices"):
        km.ln_mlp_residual(x, x.cpu(), folded)


# K1 at every width of the repo's ConvNeXt configurations (convnext_tiny's,
# base's and large's: up to C = 1536), at the row counts around its tile.
_CFG_WIDTHS = (96, 128, 192, 256, 384, 512, 768, 1024, 1536)


def _folded_args(c, dev, seed):
    """The arguments of fold_block_mlp for one random block, as _folded draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=g)
    return [1 + r(c, s=0.1), r(c, s=0.1), r(4 * c, c, s=c ** -0.5), r(4 * c, s=0.05),
            r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.05),
            0.1 + 0.9 * torch.rand(c, device=dev, generator=g)]


@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("c", _CFG_WIDTHS)
def test_k1_at_every_convnext_width(dev, c, post_ln):
    args = _folded_args(c, dev, 500 + c)
    folded = km.fold_block_mlp(*args, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(600 + c + post_ln)
    tile = km.library_plan(c).rows
    post = None
    if post_ln:
        post = ((1 + 0.1 * torch.randn(c, device=dev, generator=g)).float(),
                (0.1 * torch.randn(c, device=dev, generator=g)).float())
    for rows in (1, tile - 1, tile + 1, 19 * tile + 37):
        dw = (2 * torch.randn(rows, c, device=dev, generator=g)).to(torch.bfloat16)
        x = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
        zero = torch.zeros_like(x)
        o_max = _branch_max(dw, folded)
        for xin in (x, zero):
            before = km.ln_mlp_residual.launches
            out = km.ln_mlp_residual(dw, xin, folded, post)
            torch.cuda.synchronize()
            assert km.ln_mlp_residual.launches == before + 1
            ref = km.ln_mlp_residual_plain(dw, xin, folded, post)
            if post_ln:
                assert _agrees(out, ref, None, ref.float().abs().max().item()), (rows, xin is zero)
            else:
                assert _agrees(out, ref, xin, o_max), (rows, xin is zero)
    # planted faults at the ragged large count (x = 0, the residual
    # epilogue, as chip_smoke.py plants them): fc2 bias, LN-bias fold and
    # layer scale dropped
    ref = km.ln_mlp_residual_plain(dw, zero, folded)
    no_lnb, no_gamma = list(args), list(args)
    no_lnb[1] = torch.zeros_like(args[1])
    no_gamma[6] = torch.ones_like(args[6])
    for bad in (folded._replace(b2g=torch.zeros_like(folded.b2g)),
                km.fold_block_mlp(*no_lnb, torch.bfloat16),
                km.fold_block_mlp(*no_gamma, torch.bfloat16)):
        assert not _agrees(km.ln_mlp_residual(dw, zero, bad), ref, zero, o_max)


def test_k1_tile_plan_mirror_matches_the_library(dev):
    for c in range(0, 1600, 16):
        assert km.mlp_plan(c) == km.library_plan(c), c


def test_k1_refuses_widths_past_its_plan(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    for c in (1568, 80):
        x = torch.zeros(4, c, device=dev, dtype=torch.bfloat16)
        folded = _folded(96, dev, g)
        with pytest.raises(ValueError):
            km.ln_mlp_residual(x, x, folded)


# K1's ordered route (csrc/mlp_ordered.cuh): every width where the fused plan
# makes more than one pass, no post-LN. Row counts ragged against its
# 128-row blocks, up to the ED call's 47040.
_ORD_WIDTHS = (384, 768, 1024, 1536)
_ORD_ROWS = (1080, 5880, 11760 + 37, 47040)


def _ord_inputs(c, dev, seed, rows):
    g = torch.Generator(device=dev).manual_seed(seed)
    dw = (2 * torch.randn(rows, c, device=dev, generator=g)).to(torch.bfloat16)
    x = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
    return dw, x


@pytest.mark.parametrize("tier", ["default", "hp"])
@pytest.mark.parametrize("c", _ORD_WIDTHS)
def test_k1_ordered_route_matches_plain(dev, c, tier):
    """Within 2 ulps of the plain version at every row count, one launch a
    call counted on both counters, the same bits from two launches."""
    assert km.k1_route(c, False) and not km.k1_route(c, True)
    folded = km.fold_block_mlp(*_folded_args(c, dev, 700 + c), torch.bfloat16)
    for rows in _ORD_ROWS:
        dw, x = _ord_inputs(c, dev, 800 + c + rows, rows)
        before = (km.ln_mlp_residual.launches, km.ln_mlp_residual.ordered_launches)
        out = km.ln_mlp_residual(dw, x, folded, None, tier)
        again = km.ln_mlp_residual(dw, x, folded, None, tier)
        torch.cuda.synchronize()
        assert (km.ln_mlp_residual.launches - before[0],
                km.ln_mlp_residual.ordered_launches - before[1]) == (2, 2)
        assert torch.equal(out.view(torch.int16), again.view(torch.int16)), rows
        ref = km.ln_mlp_residual_plain(dw, x, folded, None, tier)
        assert _agrees(out, ref, x, _branch_max(dw, folded, tier)), rows


@pytest.mark.parametrize("c", _ORD_WIDTHS)
def test_k1_ordered_route_planted_faults_fail(dev, c):
    """The check refuses the route with fc1's bias dropped, with its
    readiness waits skipped (a stale hidden) and with the last launch's
    generation passed again; a sound launch after them is right again."""
    args = _folded_args(c, dev, 900 + c)
    folded = km.fold_block_mlp(*args, torch.bfloat16)
    dw, x = _ord_inputs(c, dev, 1000 + c, 11760 + 37)
    ref = km.ln_mlp_residual_plain(dw, x, folded)
    o_max = _branch_max(dw, folded)
    assert _agrees(km.ln_mlp_residual(dw, x, folded), ref, x, o_max)
    no_bias = folded._replace(bw=torch.zeros_like(folded.bw))
    assert not _agrees(km.ln_mlp_residual(dw, x, no_bias), ref, x, o_max)
    for plant in km.ORDERED_PLANTS:
        assert not _agrees(km.ln_mlp_residual_planted(dw, x, folded, plant), ref, x, o_max), plant
    assert _agrees(km.ln_mlp_residual(dw, x, folded), ref, x, o_max)


@pytest.mark.parametrize("c,rows", [(384, 47040), (768, 5880 + 37), (1536, 11760 + 37)])
def test_k1_ordered_route_holds_under_relaunches(dev, c, rows):
    """Many launches, half of them with the items in row order (every item
    waits on the one before it, so the ring drains and refills at each
    hand-over from one warpgroup to the other): every launch gives the
    first one's bits, which are within 2 ulps of the plain version."""
    folded = km.fold_block_mlp(*_folded_args(c, dev, 1100 + c), torch.bfloat16)
    dw, x = _ord_inputs(c, dev, 1200 + c, rows)
    first = km.ln_mlp_residual(dw, x, folded)
    ref = km.ln_mlp_residual_plain(dw, x, folded)
    assert _agrees(first, ref, x, _branch_max(dw, folded))
    for i in range(24):
        out = (km.ln_mlp_residual_planted(dw, x, folded, "row_order") if i % 2
               else km.ln_mlp_residual(dw, x, folded))
        assert torch.equal(out.view(torch.int16), first.view(torch.int16)), i


@pytest.mark.parametrize("backbone,k1,ordered", [("convnext_tiny", 54, 33),
                                                 ("convnext_large", 108, 93)])
def test_k1_ordered_launches_per_forward(dev, backbone, k1, ordered):
    """One default-plan ensemble forward at 224 px: every K1 launch counted
    once, the ordered route's at C = 384, 768 and 1536 without post-LN."""
    from genconvit_tpu_torch.config import Config, ModelConfig
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import cuda as kcuda

    pred = Predictor(Config(model=ModelConfig(backbone=backbone)), device=dev,
                     deterministic_vae=True, face_backend="center")
    g = torch.Generator(device=dev).manual_seed(11)
    frames = torch.randint(0, 256, (1, 15, 224, 224, 3), dtype=torch.uint8, device=dev,
                           generator=g)
    mask = torch.ones(1, 15, device=dev)
    pred.forward_batched(frames, mask)
    torch.cuda.synchronize()
    kcuda.reset_launch_counts()
    assert km.ln_mlp_residual.ordered_launches == 0
    _, y_val = pred.forward_batched(frames, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(y_val).all()
    assert (km.ln_mlp_residual.launches, km.ln_mlp_residual.ordered_launches) == (k1, ordered)


# K3 and K4 (the int8 configuration). K4 is held within k4.ULP_TOL bf16
# ulps: K1's two rounding flips plus one int8 step (convnext_mlp_int8).

def _int8_block(c, dev, g):
    """Block weights in bf16, as the kernel path holds them."""
    def r(*shape, s=1.0):
        return (s * torch.randn(*shape, device=dev, generator=g)).to(torch.bfloat16)
    gamma = (0.1 + 0.9 * torch.rand(c, device=dev, generator=g)).to(torch.bfloat16)
    return (1 + r(c, s=0.1), r(c, s=0.1), r(4 * c, c, s=0.02), r(4 * c, s=0.02),
            r(c, 4 * c, s=0.02), r(c, s=0.02), gamma)


# (C, post-LN): 160 is a width off the path; the post-LN goes to C = 768
_K4_WIDTHS = [(c, post) for c in (96, 160, 192, 384, 768, 1024, 1536)
              for post in ((False, True) if c <= 768 else (False,))]


@pytest.mark.parametrize("c,post_ln", _K4_WIDTHS)
@pytest.mark.parametrize("mode", ["fc1", "full"])
def test_k4_matches_plain(dev, mode, c, post_ln):
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4

    g = torch.Generator(device=dev).manual_seed(c + post_ln)
    rows = 1037  # ragged against every row tile
    args = _int8_block(c, dev, g)
    folded = k4.fold_block_mlp_int8(*args, mode, torch.bfloat16)
    dw = (2 * torch.randn(rows, c, device=dev, generator=g)).to(torch.bfloat16)
    x = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
    post = None
    if post_ln:
        post = ((1 + 0.1 * torch.randn(c, device=dev, generator=g)).float(),
                (0.1 * torch.randn(c, device=dev, generator=g)).float())
    zero = torch.zeros_like(x)
    o_max = k4.ln_mlp_residual_int8_plain(dw, zero, folded).float().abs().max().item()
    before = k4.ln_mlp_residual_int8.launches
    for xin in (x, zero):
        out = k4.ln_mlp_residual_int8(dw, xin, folded, post)
        torch.cuda.synchronize()
        ref = k4.ln_mlp_residual_int8_plain(dw, xin, folded, post)
        if post_ln:
            scale, xr = ref.float().abs().max().item(), None
        else:
            scale, xr = o_max, xin
        assert _rel(out, ref) <= TOL
        assert km.bf16_ulp_error(out, ref, xr, scale) <= k4.ULP_TOL
    assert k4.ln_mlp_residual_int8.launches == before + 2
    # planted faults: b2g dropped, LN-bias fold dropped, s1 by its mean
    ref = k4.ln_mlp_residual_int8_plain(dw, zero, folded)
    no_lnb = list(args)
    no_lnb[1] = torch.zeros_like(args[1])
    for bad in (folded._replace(b2g=torch.zeros_like(folded.b2g)),
                k4.fold_block_mlp_int8(*no_lnb, mode, torch.bfloat16),
                folded._replace(s1=folded.s1.mean().expand_as(folded.s1).contiguous())):
        out = k4.ln_mlp_residual_int8(dw, zero, bad)
        assert km.bf16_ulp_error(out, ref, zero, o_max) > k4.ULP_TOL


@pytest.mark.parametrize("m,k,n", [(7, 1000, 300), (15, 2048, 520), (33, 4096, 130),
                                   (130, 520, 200)])
def test_k3_matches_plain(dev, m, k, n):
    from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
    from genconvit_tpu_torch.ops.quant import quantize_wint8

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    wq, s = quantize_wint8(0.02 * torch.randn(n, k, device=dev, generator=g), dim=1)
    b = 0.1 * torch.randn(n, device=dev, generator=g)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    before = k3.matmul_wint8.launches
    out = k3.matmul_wint8(x, wq, s, b)
    torch.cuda.synchronize()
    assert k3.matmul_wint8.launches == before + 1
    ref = k3.matmul_wint8_plain(x, wq, s, b)
    assert out.dtype == torch.bfloat16 and _agrees(out, ref)
    out32 = k3.matmul_wint8(x.float(), wq, s, b)
    ref32 = k3.matmul_wint8_plain(x.float(), wq, s, b)
    assert out32.dtype == torch.float32
    assert ((out32 - ref32).abs().max() / ref32.abs().max()).item() <= 1e-5
    # planted faults: bias dropped, scale by its mean
    assert not _agrees(k3.matmul_wint8(x, wq, s, torch.zeros_like(b)), ref)
    assert not _agrees(k3.matmul_wint8(x, wq, s.mean().expand_as(s).contiguous(), b), ref)


# K3 at the row counts of every x tile (16 .. 256 rows, and past 256), with
# K and N off every 64-multiple: K = 2064 takes the 16-byte weight loads,
# K = 1000 the byte loads.
@pytest.mark.parametrize("m,k,n", [(1, 2064, 520), (15, 1000, 300), (30, 2064, 520),
                                   (120, 2064, 130), (129, 1000, 200), (240, 2064, 520),
                                   (300, 1000, 70)])
def test_k3_at_every_row_tile(dev, m, k, n):
    from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
    from genconvit_tpu_torch.ops.quant import quantize_wint8

    g = torch.Generator(device=dev).manual_seed(7 * m + k + n)
    wq, s = quantize_wint8(0.02 * torch.randn(n, k, device=dev, generator=g), dim=1)
    b = 0.1 * torch.randn(n, device=dev, generator=g)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    before = k3.matmul_wint8.launches
    out = k3.matmul_wint8(x, wq, s, b)
    torch.cuda.synchronize()
    assert k3.matmul_wint8.launches == before + 1
    ref = k3.matmul_wint8_plain(x, wq, s, b)
    assert out.shape == (m, n) and _agrees(out, ref)
    ref32 = k3.matmul_wint8_plain(x.float(), wq, s, b)
    assert ((k3.matmul_wint8(x.float(), wq, s, b) - ref32).abs().max()
            / ref32.abs().max()).item() <= 1e-5
    # planted faults: bias dropped, scale by its mean, one weight row's
    # bytes reversed in k (a wrong k order would pass any check that
    # multiplies by a k-constant x)
    assert not _agrees(k3.matmul_wint8(x, wq, s, torch.zeros_like(b)), ref)
    assert not _agrees(k3.matmul_wint8(x, wq, s.mean().expand_as(s).contiguous(), b), ref)
    flipped = wq.clone()
    flipped[n // 2] = wq[n // 2].flip(0)
    assert not _agrees(k3.matmul_wint8(x, flipped, s, b), ref)


# K4 at every width of the repo's ConvNeXt configurations, at the row
# counts around its tile (a count ragged against it, and the few-row counts
# where the passes of a tile become work items of their own), with the
# planted faults at each.
@pytest.mark.parametrize("c", _CFG_WIDTHS)
@pytest.mark.parametrize("mode", ["fc1", "full"])
def test_k4_at_every_convnext_width(dev, mode, c):
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4

    g = torch.Generator(device=dev).manual_seed(700 + c)
    args = _int8_block(c, dev, g)
    folded = k4.fold_block_mlp_int8(*args, mode, torch.bfloat16)
    tile = k4.library_plan(c, mode).rows
    for rows in (1, tile - 1, tile + 1, 19 * tile + 37):
        dw = (2 * torch.randn(rows, c, device=dev, generator=g)).to(torch.bfloat16)
        x = torch.randn(rows, c, device=dev, generator=g).to(torch.bfloat16)
        zero = torch.zeros_like(x)
        o_max = k4.ln_mlp_residual_int8_plain(dw, zero, folded).float().abs().max().item()
        for xin in (x, zero):
            before = k4.ln_mlp_residual_int8.launches
            out = k4.ln_mlp_residual_int8(dw, xin, folded)
            torch.cuda.synchronize()
            assert k4.ln_mlp_residual_int8.launches == before + 1
            ref = k4.ln_mlp_residual_int8_plain(dw, xin, folded)
            assert _rel(out, ref) <= TOL, (rows, xin is zero)
            assert km.bf16_ulp_error(out, ref, xin, o_max) <= k4.ULP_TOL, (rows, xin is zero)
    # planted faults at the ragged large count (x = 0): b2g dropped, LN-bias
    # fold dropped, s1 by its mean
    ref = k4.ln_mlp_residual_int8_plain(dw, zero, folded)
    no_lnb = list(args)
    no_lnb[1] = torch.zeros_like(args[1])
    for bad in (folded._replace(b2g=torch.zeros_like(folded.b2g)),
                k4.fold_block_mlp_int8(*no_lnb, mode, torch.bfloat16),
                folded._replace(s1=folded.s1.mean().expand_as(folded.s1).contiguous())):
        out = k4.ln_mlp_residual_int8(dw, zero, bad)
        assert km.bf16_ulp_error(out, ref, zero, o_max) > k4.ULP_TOL


def test_k4_tile_plan_mirror_matches_the_library(dev):
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4

    for mode in k4.MODES:
        for c in range(0, 1600, 16):
            assert k4.k4_plan(c, mode) == k4.library_plan(c, mode), (mode, c)


def test_k4_refuses_widths_past_its_plan(dev):
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4

    g = torch.Generator(device=dev).manual_seed(10)
    folded = k4.fold_block_mlp_int8(*_int8_block(96, dev, g), "full", torch.bfloat16)
    for c in (1568, 80):
        x = torch.zeros(4, c, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            k4.ln_mlp_residual_int8(x, x, folded)


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4
    from genconvit_tpu_torch.ops.cuda import int8_matmul as k3

    g = torch.Generator(device=dev).manual_seed(2)
    folded = k4.fold_block_mlp_int8(*_int8_block(96, dev, g), "full", torch.bfloat16)
    x = torch.randn(64, 96, device=dev, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        k4.ln_mlp_residual_int8(x.float(), x.float(), folded)
    with pytest.raises(ValueError, match="contiguous"):
        k4.ln_mlp_residual_int8(x.t().contiguous().t(), x, folded)
    with pytest.raises(ValueError, match="devices"):
        k4.ln_mlp_residual_int8(x, x.cpu(), folded)
    with pytest.raises(ValueError, match="multiple of 32"):
        k4.ln_mlp_residual_int8(x[:, :48].contiguous(), x[:, :48].contiguous(), folded)
    with pytest.raises(ValueError, match="mode"):
        k4.ln_mlp_residual_int8(x, x, folded._replace(mode="w4"))
    with pytest.raises(ValueError, match="int8"):
        k4.ln_mlp_residual_int8(x, x, folded._replace(wq1=folded.wq1.float()))
    with pytest.raises(ValueError, match="wq2k"):
        k4.ln_mlp_residual_int8(x, x, folded._replace(wq2k=None))
    wq = torch.zeros(8, 96, dtype=torch.int8, device=dev)
    s = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        k3.matmul_wint8(x, wq.float(), s, s)
    with pytest.raises(ValueError, match="float32"):
        k3.matmul_wint8(x, wq, s.to(torch.bfloat16), s)
    with pytest.raises(ValueError, match="contiguous"):
        k3.matmul_wint8(x.t().contiguous().t(), wq, s, s)
    with pytest.raises(ValueError, match="another device"):
        k3.matmul_wint8(x, wq.cpu(), s, s)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k3.matmul_wint8(x.half(), wq, s, s)


# K5 and K6 (the fused-block and fused-stage backbones): rows ragged against
# every row tile, H and W off each other; planted faults must fail the check.
# K6 is held block by block, each block at K5's bound.

def _fused_block_weights(c, dev, g):
    """A block's K5 pack, made as chip_smoke.py makes it: a ConvNeXt block at
    timm's init, layer scale U(0.1, 1), every bias non-trivial, in bf16."""
    from chip_smoke import random_fused_block

    with torch.no_grad():
        return random_fused_block(torch, c, dev, g).pack_fused()


def _fused_check(out, ref, x):
    """rel <= TOL and within K5's ulps of max(|ref|, |x|), floored at the
    ulp of the largest change the block made."""
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5

    scale = (ref.float() - x.float()).abs().max().item()
    return _rel(out, ref) <= TOL and km.bf16_ulp_error(out, ref, x, scale) <= k5.ULP_TOL


def _stage_holds(x, stack, truth=None):
    """K6 held block by block (convnext_stage.stage_steps): False at the
    first block whose output is off its plain block on the same input."""
    from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

    return all(_fused_check(out, ref, xin) for xin, out, ref
               in k6.stage_steps(k6.fused_convnext_stage, x, stack, truth))


@pytest.mark.parametrize("c", [96, 192, 384, 768, 128, 1024, 1536])
def test_k5_matches_plain(dev, c):
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5

    g = torch.Generator(device=dev).manual_seed(200 + c)
    x = torch.randn(3, 13, 11, c, device=dev, generator=g).to(torch.bfloat16)
    p = _fused_block_weights(c, dev, g)
    before = k5.fused_convnext_block.launches
    out = k5.fused_convnext_block(x, p)
    torch.cuda.synchronize()
    assert k5.fused_convnext_block.launches == before + 1
    ref = k5.fused_convnext_block_plain(x, p)
    assert out.shape == x.shape and _fused_check(out, ref, x)
    for name, bad in k5.planted_faults(p).items():
        assert not _fused_check(k5.fused_convnext_block(x, bad), ref, x), name


# (3, 7, 7, 384): two images in one 128-row tile; (134, 14, 14, 384): items of
# two images over four tiles on 132 SMs, an image ending inside a tile;
# (5, 7, 7, 768): an odd count in 64-row tiles; 1024 and 1536: convnext_base's
# and convnext_large's last stages; 56 x 56 x 128: convnext_base's stage 0
@pytest.mark.parametrize("n,h,w,c,nb", [(3, 7, 7, 384, 3), (2, 14, 14, 384, 2),
                                        (2, 7, 7, 768, 2), (2, 9, 5, 128, 1),
                                        (2, 7, 7, 384, 9),   # 9: stage 2's chain
                                        (134, 14, 14, 384, 2), (5, 7, 7, 768, 2),
                                        (3, 7, 7, 1024, 2), (3, 7, 7, 1536, 2),
                                        (2, 56, 56, 128, 2)])
def test_k6_matches_plain(dev, n, h, w, c, nb):
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5
    from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

    g = torch.Generator(device=dev).manual_seed(300 + c + nb)
    x = torch.randn(n, h, w, c, device=dev, generator=g).to(torch.bfloat16)
    packs = [_fused_block_weights(c, dev, g) for _ in range(nb)]
    stack = k5.stack_blocks(packs)
    before = k6.fused_convnext_stage.launches
    out = k6.fused_convnext_stage(x, stack)
    torch.cuda.synchronize()
    assert k6.fused_convnext_stage.launches == before + 1
    assert out.shape == x.shape
    assert torch.equal(out, k6.fused_convnext_stage(x, stack))   # deterministic
    assert _stage_holds(x, stack)
    # every fault refused, the one confined to the middle block too
    for name, bad in k6.chain_faults(packs).items():
        assert not _stage_holds(x, bad, stack), name


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5
    from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

    g = torch.Generator(device=dev).manual_seed(3)
    p = _fused_block_weights(96, dev, g)
    x = torch.randn(1, 8, 8, 96, device=dev, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        k5.fused_convnext_block(x.float(), p)
    with pytest.raises(ValueError, match="contiguous"):
        k5.fused_convnext_block(x.permute(0, 2, 1, 3), p)
    with pytest.raises(ValueError, match="N,H,W,C"):
        k5.fused_convnext_block(x[0], p)
    with pytest.raises(ValueError, match="multiple of 32"):
        k5.fused_convnext_block(x[..., :48].contiguous(), p)
    wide = torch.zeros(1, 2, 2, km.K1_MAX_C + 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds"):
        k5.fused_convnext_block(wide, p)
    with pytest.raises(ValueError, match="exceeds"):
        k6.fused_convnext_stage(wide, k5.stack_blocks([p]))
    with pytest.raises(ValueError, match="expected shape"):
        k5.fused_convnext_block(x, p._replace(w1=p.w2))
    with pytest.raises(ValueError, match="another device"):
        k5.fused_convnext_block(x, p._replace(gamma=p.gamma.cpu()))
    with pytest.raises(ValueError, match="stacked"):
        k6.fused_convnext_stage(x, p)
    with pytest.raises(ValueError, match="float32"):
        k6.fused_convnext_stage(x, k5.stack_blocks([p._replace(b1=p.b1.half())]))


def test_block_plan_mirrors_match_the_library(dev):
    """K5's and K6's plans as the library computes them, at every width K1
    takes (and its refusals), and K6's images per item at the scoring
    path's chains on this card's SMs."""
    from genconvit_tpu_torch.ops.cuda import convnext_block as k5
    from genconvit_tpu_torch.ops.cuda import convnext_stage as k6

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c in list(range(0, km.K1_MAX_C + 97, 32)) + [48, 100]:
        assert k5.library_k5_plan(c) == k5.k5_plan(c), c
        assert k6.library_k6_plan(c, 240, 7, 7, sms) == k6.k6_plan(c, 240, 7, 7, sms), c
    for c, n, h in ((384, 240, 14), (768, 240, 7), (384, 120, 14), (768, 120, 7),
                    (384, 120, 7), (128, 240, 56), (1536, 3, 7), (384, 134, 14)):
        assert k6.library_k6_plan(c, n, h, h, sms) == k6.k6_plan(c, n, h, h, sms), (c, n, h)


def test_f32_product_on_the_card_is_the_upcast_product(dev):
    """The LN-folded block's z = d . wg (models/convnext.f32_product): the
    bf16 product with a float32 result on the card, the upcast product on
    the CPU; the same up to float32 summation order."""
    from genconvit_tpu_torch.models.convnext import f32_product

    g = torch.Generator(device=dev).manual_seed(4)
    d = (3 * torch.randn(2, 9, 7, 384, device=dev, generator=g) + 1).to(torch.bfloat16)
    w = (0.05 * torch.randn(384, 1536, device=dev, generator=g)).to(torch.bfloat16)
    z = f32_product(d, w)
    assert z.dtype == torch.float32 and z.shape == (2, 9, 7, 1536)
    ref = f32_product(d.cpu(), w.cpu())
    mag = d.float().abs().cpu() @ w.float().abs().cpu()
    assert ((z.cpu() - ref).abs() <= 1e-5 * mag + 1e-6).all()


# K7 (Swin window attention): held within k7.ULP_TOL bf16 ulps of the largest
# |out| of the same window-head (window_attn.ulp_error); G = B * heads ragged
# against the 4 window-heads of a thread block; the bias table O(1), not the
# 0.02 init, so that the bias path carries weight.

def _k7_inputs(dev, g, b, l, heads, hd, nw):
    """qkv [B, L, 3C] bf16, a bias gathered from a random O(1) table as the
    model gathers it, and a shifted-window mask of nw windows (or None)."""
    import numpy as np

    from genconvit_tpu_torch.models.swin import relative_position_index, shifted_window_mask

    w = int(round(l ** 0.5))
    qkv = torch.randn(b, l, 3 * heads * hd, device=dev, generator=g).to(torch.bfloat16)
    table = torch.randn((2 * w - 1) ** 2, heads, device=dev, generator=g)
    idx = torch.from_numpy(relative_position_index(w).reshape(-1).astype(np.int64)).to(dev)
    bias = table[idx].view(l, l, heads).permute(2, 0, 1).contiguous()
    mask = None
    if nw > 1:
        side = w * int(round(nw ** 0.5))
        mask = torch.from_numpy(shifted_window_mask(side, side, w, w // 2)).to(dev)
    return qkv, bias, mask


@pytest.mark.parametrize("l,hd,nw", [(49, 32, 4), (49, 32, 1), (16, 32, 16), (16, 16, 1),
                                     (49, 64, 4), (49, 16, 4), (16, 64, 1)])
def test_k7_matches_plain(dev, l, hd, nw):
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    g = torch.Generator(device=dev).manual_seed(400 + l + hd + nw)
    heads, b = 3, 4 * nw + 1 if nw > 1 else 37     # G = 3B: ragged against 4
    qkv, bias, mask = _k7_inputs(dev, g, b, l, heads, hd, nw)
    before = (k7.window_attention.launches, k7.window_attention.masked_launches)
    out = k7.window_attention(qkv, bias, mask, heads, nw)
    torch.cuda.synchronize()
    assert (k7.window_attention.launches, k7.window_attention.masked_launches) == (
        before[0] + 1, before[1] + int(mask is not None))
    ref = k7.window_attention_plain(qkv, bias, mask, heads, nw)
    assert out.shape == ref.shape == (b, l, heads * hd)
    assert _rel(out, ref) <= TOL and k7.ulp_error(out, ref, heads) <= k7.ULP_TOL
    windows = max(nw, 4)   # the unmasked calls of a stage with 4 windows per image
    for name, bad in k7.planted_outputs(k7.window_attention, qkv, bias, mask, heads,
                                        windows).items():
        assert k7.ulp_error(bad, ref, heads) > k7.ULP_TOL, name


# K7 at every stage shape of swin_tiny and swin_large: (heads, windows per
# image), masked where the stage has more than one window; B ragged against
# the persistent grid (2 nW + 5 windows over the head groups' blocks)
_K7_STAGES = ((3, 64), (6, 16), (12, 4), (24, 1), (6, 64), (12, 16), (24, 4), (48, 1))


@pytest.mark.parametrize("heads,nw", _K7_STAGES)
def test_k7_at_every_swin_stage_shape(dev, heads, nw):
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    g = torch.Generator(device=dev).manual_seed(500 + heads + nw)
    b = 2 * nw + 5
    qkv, bias, mask = _k7_inputs(dev, g, b, 49, heads, 32, nw)
    for m in ([mask, None] if mask is not None else [None]):
        wpm = nw if m is not None else 1
        out = k7.window_attention(qkv, bias, m, heads, wpm)
        ref = k7.window_attention_plain(qkv, bias, m, heads, wpm)
        torch.cuda.synchronize()
        assert _rel(out, ref) <= TOL and k7.ulp_error(out, ref, heads) <= k7.ULP_TOL
        for name, bad in k7.planted_outputs(k7.window_attention, qkv, bias, m, heads,
                                            nw).items():
            assert k7.ulp_error(bad, ref, heads) > k7.ULP_TOL, name


def test_k7_plan_mirror_matches_the_library(dev):
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    for heads, nw in _K7_STAGES:
        for hd in (16, 32, 64):
            for masked in (True, False):
                for windows in (1, 2 * nw + 5, 120 * nw):
                    for sms in (132, 114):
                        want = k7.k7_plan(49, heads, hd, masked, windows, sms)
                        assert k7.library_k7_plan(49, heads, hd, masked, windows, sms) == want
    assert k7.library_k7_plan(81, 3, 32, False, 8, 132) is None


def test_k7_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    g = torch.Generator(device=dev).manual_seed(5)
    qkv, bias, mask = _k7_inputs(dev, g, 8, 49, 3, 32, 4)
    with pytest.raises(ValueError, match="L=81"):
        k7.window_attention(torch.zeros(2, 81, 288, device=dev, dtype=torch.bfloat16),
                            torch.zeros(3, 81, 81, device=dev), None, 3)
    with pytest.raises(ValueError, match="head dim"):
        k7.window_attention(qkv[..., :3 * 3 * 24].contiguous(), bias, mask, 3, 4)
    with pytest.raises(ValueError, match="bfloat16"):
        k7.window_attention(qkv.float(), bias, mask, 3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k7.window_attention(qkv.transpose(0, 1).contiguous().transpose(0, 1), bias, mask, 3, 4)
    with pytest.raises(ValueError, match="float32"):
        k7.window_attention(qkv, bias.to(torch.bfloat16), mask, 3, 4)
    with pytest.raises(ValueError, match="fewer than"):
        k7.window_attention(qkv, bias, mask, 3, 5)
    with pytest.raises(ValueError, match="another device"):
        k7.window_attention(qkv, bias.cpu(), mask, 3, 4)


def test_swin_tiny_forward_launches_k7_12_times(dev):
    """One swin_tiny forward at 224 px in bf16: 12 K7 launches, 5 with a
    mask (the blocks with a shift: one in stages 0-1, three in stage 2)."""
    from genconvit_tpu_torch.models.init import init_swin_
    from genconvit_tpu_torch.models.swin import SwinTransformer
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    g = torch.Generator(device=dev).manual_seed(6)
    model = SwinTransformer("swin_tiny_patch4_window7_224").to(dev)
    init_swin_(model, g)
    model = model.to(torch.bfloat16)
    x = torch.randn(2, 3, 224, 224, device=dev, generator=g).to(torch.bfloat16)
    before = (k7.window_attention.launches, k7.window_attention.masked_launches)
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    assert out.shape == (2, 1000) and torch.isfinite(out).all()
    assert (k7.window_attention.launches - before[0],
            k7.window_attention.masked_launches - before[1]) == (12, 5)


# The probes M1-M3 (their tools launch them; no model path does): each
# against its plain version at one small and one scoring-path shape, and one
# planted fault each that the check must refuse.

def _m1_inputs(kind, rows, c, hid, dev, g):
    from genconvit_tpu_torch.tools.microbench_int8_dot import make_inputs

    ops = list(make_inputs(kind, rows, c, hid, dev, g))
    if kind == "int8":   # scales off 1, as chip_smoke.py sets them
        ops[3] = torch.rand(hid, device=dev, generator=g) + 0.5
        ops[5] = torch.rand(c, device=dev, generator=g) + 0.5
    return ops


# 1037 rows: a ragged last tile; at 96, 768 and convnext_base's and
# convnext_large's last stages (1024, 1536), the tool's hid = 3c and K4's 4c
@pytest.mark.parametrize("rows,c,hid", [(188160, 192, 768)] + [
    (1037, c, m * c) for c in (96, 768, 1024, 1536) for m in (3, 4)])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_m1_matches_plain(dev, kind, rows, c, hid):
    from genconvit_tpu_torch.ops.cuda import int8_dot as m1

    g = torch.Generator(device=dev).manual_seed(rows + c)
    ops = _m1_inputs(kind, rows, c, hid, dev, g)
    fn, plain, tol = ((m1.dots_bf16, m1.dots_bf16_plain, m1.ULP_TOL) if kind == "bf16"
                      else (m1.dots_int8, m1.dots_int8_plain, m1.ULP_TOL_INT8))
    before = fn.launches
    out = fn(*ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(*ops)
    assert _rel(out, ref) <= TOL and m1.ulp_error(out, ref) <= tol
    s1, w2 = (ops[3], ops[4]) if kind == "int8" else (None, ops[3])
    faults = m1.planted_faults(kind, ops[2], s1, w2)
    for name in ("w2 transposed",) + (("s1 by its mean",) if kind == "int8" else ()):
        b1, bs1, b2 = faults[name]
        bad = ops[:2] + ([b1, bs1, b2, ops[5]] if kind == "int8" else [b1, b2])
        assert m1.ulp_error(fn(*bad), ref) > tol, name


# 15: ragged row tiles; 192 and convnext_large's 1536 (64-row cols plans)
@pytest.mark.parametrize("n,h,c", [(2, 15, 96), (120, 28, 96), (2, 9, 192), (2, 7, 1536)])
@pytest.mark.parametrize("phase", ["dma", "dw", "dw_bf16acc", "ln", "fc1", "gelu", "full"])
def test_m2_matches_plain(dev, phase, n, h, c):
    from genconvit_tpu_torch.ops.cuda import block_parts as m2

    g = torch.Generator(device=dev).manual_seed(n + h + c)
    p = _fused_block_weights(c, dev, g)
    x = torch.randn(n, h, h, c, device=dev, generator=g).to(torch.bfloat16)
    before = m2.block_parts.launches
    out = m2.block_parts(x, p, phase)
    torch.cuda.synchronize()
    assert m2.block_parts.launches == before + 1
    ref = m2.block_parts_plain(x, p, phase)
    assert _rel(out, ref) <= TOL and m2.ulp_error(out, ref, x, phase) <= m2.ULP_TOL
    for name, bad in m2.planted_faults(p, phase).items():
        assert m2.ulp_error(m2.block_parts(x, bad, phase), ref, x, phase) > m2.ULP_TOL, name


def test_m1_plan_mirror_matches_the_library(dev):
    from genconvit_tpu_torch.ops.cuda import int8_dot as m1

    for c in list(range(0, km.K1_MAX_C + 97, 32)) + [48, 100]:
        for hid in {c - 32, c, c + 16, 3 * c, 4 * c, 4 * c + 32}:
            assert m1.library_m1_plan(c, hid) == m1.m1_plan(c, hid), (c, hid)


# 13: a ragged last run; 7 and 1536: 6 slices of 8 groups; 3: W < 7; 200: a
# ragged last slice (4 + 3 groups, the last one partial); 6: C % 8 != 0 (the
# producer's copies); 56: the tool's width, in bands of rows
@pytest.mark.parametrize("n,h,c", [(2, 13, 96), (240, 14, 384), (3, 7, 1536), (5, 3, 768),
                                   (4, 14, 200), (2, 9, 6), (2, 56, 96)])
def test_m3_matches_plain(dev, n, h, c):
    """Within ULP_TOL and MOMENT_TOL of the plain version (dw bit for bit
    with these bf16-representable weights, but for the sign of a zero),
    the same bits from two launches, every planted fault refused."""
    from genconvit_tpu_torch.ops.cuda import dw_moments as m3
    from genconvit_tpu_torch.tools.microbench_dwshift import make_inputs

    g = torch.Generator(device=dev).manual_seed(n + h + c)
    x, k, b = make_inputs(n, h, c, dev, g)
    before = m3.dw_moments.launches
    out = m3.dw_moments(x, k, b)
    torch.cuda.synchronize()
    assert m3.dw_moments.launches == before + 1
    ref = m3.dw_moments_plain(x, k, b)
    assert _rel(out[0], ref[0]) <= TOL and m3.agrees(m3.ulp_error(out, ref))
    assert torch.equal(out[0].float(), ref[0].float())
    again = m3.dw_moments(x, k, b)
    for a, z in zip(out, again):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32),
                           z.view(torch.int16) if z.dtype == torch.bfloat16 else z.view(torch.int32))
    for name, (bk, bb) in m3.planted_faults(k, b).items():
        assert not m3.agrees(m3.ulp_error(m3.dw_moments(x, bk, bb), ref)), name
    assert not m3.agrees(m3.ulp_error(m3.dw_moments(m3.halo_from_neighbour(x), k, b), ref))
    assert not m3.agrees(m3.ulp_error(m3.moments_without_last_slice(x, k, b), ref))


def test_m3_plan_mirror_matches_the_library(dev):
    from genconvit_tpu_torch.ops.cuda import dw_moments as m3

    for h in list(range(1, 57)) + [100, 250, 1000]:
        for c in list(range(2, 1537, 2)) + [1, 97]:
            assert m3.library_m3_plan(h, h, c) == m3.m3_plan(h, h, c), (h, c)
    for h, w in ((3, 14), (14, 3), (9, 57), (57, 9), (300, 120)):
        assert m3.library_m3_plan(h, w, 96) == m3.m3_plan(h, w, 96), (h, w)


def test_probe_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from genconvit_tpu_torch.ops.cuda import block_parts as m2
    from genconvit_tpu_torch.ops.cuda import dw_moments as m3
    from genconvit_tpu_torch.ops.cuda import int8_dot as m1

    bf = torch.bfloat16
    y, h = torch.zeros(64, 96, dtype=bf, device=dev), torch.zeros(64, 288, dtype=bf, device=dev)
    w1, w2 = torch.zeros(288, 96, dtype=bf, device=dev), torch.zeros(96, 288, dtype=bf, device=dev)
    with pytest.raises(ValueError, match="hid"):
        m1.dots_bf16(y, torch.zeros(64, 416, dtype=bf, device=dev), w1, w2)
    with pytest.raises(ValueError, match="expected"):
        m1.dots_bf16(y, h, w2, w2)
    with pytest.raises(ValueError, match="int8"):
        m1.dots_int8(y, h, w1, torch.ones(288, device=dev), w2, torch.ones(96, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        m1.dots_bf16(torch.zeros(96, 64, dtype=bf, device=dev).t(), h, w1, w2)
    x = torch.zeros(2, 7, 7, 96, dtype=bf, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        m3.dw_moments(x.float(), torch.zeros(7, 7, 96, device=dev), torch.zeros(96, device=dev))
    with pytest.raises(ValueError, match="expected shape"):
        m3.dw_moments(x, torch.zeros(49, 96, device=dev), torch.zeros(96, device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    with pytest.raises(ValueError, match="multiple of 32"):
        m2.block_parts(torch.zeros(2, 7, 7, 80, dtype=bf, device=dev),
                       _fused_block_weights(96, dev, g), "ln")
    # past the probes' limit, K1's 1536
    wide = km.K1_MAX_C + 32
    with pytest.raises(ValueError, match="up to 1536"):
        m1.dots_bf16(torch.zeros(64, wide, dtype=bf, device=dev),
                     torch.zeros(64, 3 * wide, dtype=bf, device=dev),
                     torch.zeros(3 * wide, wide, dtype=bf, device=dev),
                     torch.zeros(wide, 3 * wide, dtype=bf, device=dev))
    with pytest.raises(ValueError, match="exceeds 1536"):
        m2.block_parts(torch.zeros(1, 2, 2, wide, dtype=bf, device=dev),
                       _fused_block_weights(96, dev, g), "full")


def test_predict_videos_stream_equals_the_batched_path(dev, monkeypatch):
    """The stream's uploads (pinned host memory, on a copy stream the
    forward waits for) give each batch, ragged ones too, the verdicts
    predict_videos_batched gives it, bit for bit (a small bf16 ConvNeXt
    through K1 and K2, deterministic VAE)."""
    import numpy as np

    from genconvit_tpu_torch.config import Config, ModelConfig
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.models import convnext

    monkeypatch.setitem(convnext.CONVNEXT_CFGS, "convnext_card_test",
                        dict(depths=(1, 1, 1, 1), dims=(32, 64, 96, 128)))
    pred = Predictor(Config(model=ModelConfig(backbone="convnext_card_test"), img_size=64),
                     device=dev, deterministic_vae=True, face_backend="center")
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (v, 5, 64, 64, 3), np.uint8),
                (rng.random((v, 5)) < 0.8).astype(np.float32)) for v in (3, 3, 1)]
    got = pred.predict_videos_stream(iter(batches))
    for (gy, gv), (f, m) in zip(got, batches, strict=True):
        wy, wv = pred.predict_videos_batched(f, m)
        assert np.array_equal(gy, wy) and np.array_equal(gv, wv)


# GenConViT's ED on Swin-L: K1 and K2 at Swin's eps 1e-5 at the four (R, C)
# of a V=8 forward's ED call (752640 x 192, 188160 x 384, 47040 x 768,
# 11760 x 1536), each against its plain version within km.ULP_TOL ulps, on
# rows a third of which have a variance near 1e-5, where ConvNeXt's 1e-6 (a
# planted fault) moves rsqrt(var + eps) by a quarter and must fail.

_SWIN_L_ROWS = [(752640, 192), (188160, 384), (47040, 768), (11760, 1536)]


def _swin_rows(rows, c, dev, g):
    x = torch.randn(rows, c, device=dev, generator=g)
    quiet = torch.arange(rows, device=dev) % 3 == 0
    scale = torch.where(quiet, 3e-3, 1.0)[:, None]
    return (x * scale).to(torch.bfloat16)


@pytest.mark.parametrize("rows,c", _SWIN_L_ROWS)
def test_k1_at_swin_eps(dev, rows, c):
    g = torch.Generator(device=dev).manual_seed(700 + c)
    x = _swin_rows(rows, c, dev, g)

    def r(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=g)
    folded = km.fold_block_mlp(1 + r(c, s=0.1), r(c, s=0.1), r(4 * c, c, s=c ** -0.5),
                               r(4 * c, s=0.05), r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.05),
                               torch.ones(c, device=dev), torch.bfloat16)
    out = km.ln_mlp_residual(x, x, folded, None, "default", 1e-5)
    ref = km.ln_mlp_residual_plain(x, x, folded, None, "default", 1e-5)
    scale = km.ln_mlp_residual_plain(x, torch.zeros_like(x), folded, None, "default",
                                     1e-5).float().abs().max().item()
    torch.cuda.synchronize()
    assert _agrees(out, ref, x, scale)
    assert not _agrees(km.ln_mlp_residual(x, x, folded, None, "default", 1e-6), ref, x, scale)


@pytest.mark.parametrize("rows,c", _SWIN_L_ROWS)
def test_k2_at_swin_eps(dev, rows, c):
    g = torch.Generator(device=dev).manual_seed(800 + c)
    x = _swin_rows(rows, c, dev, g)
    scale = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).float()
    bias = (0.1 * torch.randn(c, device=dev, generator=g)).float()
    out = km.layer_norm_rows(x, scale, bias, 1e-5)
    ref = km.layer_norm_rows_plain(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert _agrees(out, ref)
    assert not _agrees(km.layer_norm_rows(x, scale, bias, 1e-6), ref)


def _swin_block(dev, c, heads, g):
    from genconvit_tpu_torch.models.init import init_swin_
    from genconvit_tpu_torch.models.swin import SwinBlock

    blk = SwinBlock(c, heads, 7).to(dev)
    init_swin_(blk, g)
    with torch.no_grad():   # off init's trivial values: O(1) bias table, LN affines
        blk.attn.relative_position_bias_table.normal_(generator=g)
        for ln in (blk.norm1, blk.norm2):
            ln.weight.add_(0.2 * torch.randn(c, device=dev, generator=g))
            ln.bias.add_(0.1 * torch.randn(c, device=dev, generator=g))
    return blk.to(torch.bfloat16).eval()


@pytest.mark.parametrize("c,heads,hw,shift", [(192, 6, 56, 3), (768, 24, 14, 3),
                                              (768, 24, 14, 0), (1536, 48, 7, 0)])
def test_swin_block_on_k1_and_k7_matches_the_plain_bf16_graph(dev, c, heads, hw, shift):
    """A Swin-L block on its kernels (K2 for LN1, K7, K1 for the MLP half)
    against the same block's plain bf16 graph (the port's two-pass
    LayerNorms, the XLA attention, F.linear): the same function, rounded
    at other points."""
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    g = torch.Generator(device=dev).manual_seed(900 + c + shift)
    blk = _swin_block(dev, c, heads, g)
    x = torch.randn(4, hw * hw, c, device=dev, generator=g).to(torch.bfloat16)
    ln1 = (blk.norm1.weight.float().contiguous(), blk.norm1.bias.float().contiguous())
    before = (km.ln_mlp_residual.launches, k7.window_attention.launches,
              km.layer_norm_rows.launches)
    with torch.inference_mode():
        out = blk(x, (hw, hw), 7, shift, "default", True, blk.fold(), ln1)
        ref = blk(x, (hw, hw), 7, shift, "default", False)
    torch.cuda.synchronize()
    assert (km.ln_mlp_residual.launches, k7.window_attention.launches,
            km.layer_norm_rows.launches) == tuple(b + 1 for b in before)
    assert _rel(out, ref) <= TOL
    assert torch.isfinite(out).all() and not out.equal(ref)


def test_swin_ed_stream_launches_per_forward(dev):
    """Predictor(net='ed') on swin_large_patch4_window7_224 through
    predict_videos_stream, one V=8 batch: 24 K1 launches (22 on the ordered
    route: C >= 224), 24 K7 (11 masked), 29 K2 (the patch embedding's, 24
    LN1, 3 patch mergings', the final one), per forward."""
    import numpy as np

    from genconvit_tpu_torch.config import Config, ModelConfig
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import cuda as kcuda
    from genconvit_tpu_torch.ops.cuda import window_attn as k7

    pred = Predictor(Config(model=ModelConfig(backbone="swin_large_patch4_window7_224")),
                     net="ed", device=dev, face_backend="center")
    rng = np.random.default_rng(12)
    batch = (rng.integers(0, 256, (8, 15, 224, 224, 3), dtype=np.uint8),
             np.ones((8, 15), np.float32))
    pred.predict_videos_stream([batch])
    kcuda.reset_launch_counts()
    (y, y_val), = pred.predict_videos_stream([batch])
    assert np.isfinite(y_val).all() and y.shape == (8,)
    assert (km.ln_mlp_residual.launches, km.ln_mlp_residual.ordered_launches) == (24, 22)
    assert (k7.window_attention.launches, k7.window_attention.masked_launches) == (24, 11)
    assert km.layer_norm_rows.launches == 29
