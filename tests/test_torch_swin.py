"""The Swin family of the port against the JAX package on the CPU: K7's plain
version against the Pallas kernel in interpret mode (float32 at 2e-4, as
tests/test_pallas.py holds the kernel; bfloat16 within window_attn.ULP_TOL
ulps), the relative position index and the shift mask bit for bit, the
port's Swin and HybridEmbed against swin_features / swin_apply /
hybrid_embed_tokens on weights carried by the bridge (float32, 1e-4: the
same graph up to float32 summation order), the port's K7 wiring against the
JAX package's Pallas branch, K7's launches per forward against the JAX
shift rule (meta device / abstract shapes), and the bridge round trips.
Bias tables are O(1) random, never the 0.02 init, so that the bias path
carries weight; LayerNorm affines are off their trivial values.

Small configurations, from explicit cfgs: _w4 (embed 16, depths (2, 2),
heads (2, 4), window 4, 32 px), _w7 (window 7, 56 px: L = 49, the last
stage unshifted since min(hw) <= window) and _w7c (window 7, 24 px: the
window clamped to 6, then 3, indexing the centered entries of the 13 x 13
table)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.models import hybrid_embed as jax_hybrid
from genconvit_tpu.models import swin as jax_swin
from genconvit_tpu.ops import kernel_plan as jax_kernel_plan
from genconvit_tpu.ops.pallas import window_attn as jax_k7

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models import swin as port_swin
from genconvit_tpu_torch.models.hybrid_embed import HybridEmbed
from genconvit_tpu_torch.models.init import init_hybrid_embed_, init_swin_
from genconvit_tpu_torch.models.swin import SwinTransformer
from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda import window_attn as k7

from tests.torch_oracles import SwinOracle

TOL = dict(rtol=1e-4, atol=1e-4)
CLASSES = 10
SMALL = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4))
CFGS = {"_w4": (dict(SMALL, window=4), 32), "_w7": (dict(SMALL, window=7), 56),
        "_w7c": (dict(SMALL, window=7), 24)}


@pytest.fixture(params=sorted(CFGS))
def small(request, monkeypatch):
    """(name, cfg, px) with the cfg registered in the JAX package's SWIN_CFGS."""
    cfg, px = CFGS[request.param]
    monkeypatch.setitem(jax_swin.SWIN_CFGS, request.param, cfg)
    return request.param, cfg, px


def _randomize(tree, rng):
    """O(1) bias tables and LayerNorm affines off (1, 0), in numpy."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "relative_position_bias_table":
                    out[k] = rng.standard_normal(np.shape(v)).astype(np.float32)
                elif k == "scale":
                    out[k] = (1 + 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
                elif k == "bias" and "scale" in node:
                    out[k] = (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        return np.array(node, dtype=np.float32)
    return walk(tree)


def _jax_swin_tree(name, seed, num_classes=CLASSES):
    rng = np.random.default_rng(seed)
    return _randomize(jax_swin.init_swin(jax.random.PRNGKey(seed), name, num_classes), rng)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_swin(cfg, tree, num_classes=CLASSES):
    m = SwinTransformer(cfg, num_classes)
    m.load_state_dict(state_dict_from_jax(tree, "swin"), strict=True)
    return m.eval()


def _images(seed, n, px):
    """[N, H, W, 3] float32 for the JAX package and its NCHW view for the port."""
    x = np.random.default_rng(seed).standard_normal((n, px, px, 3)).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


# -- K7: the plain version against the Pallas kernel in interpret mode

def _k7_case(rng, l, heads, hd, nw, masked):
    """qkv [B, L, 3, heads, hd] (B = 2 nW) and the JAX kernel's operands:
    q, k, v [G, L, hd] head fastest, bias, mask."""
    w = int(round(l ** 0.5))
    b = 2 * nw
    qkv = rng.standard_normal((b, l, 3, heads, hd)).astype(np.float32)
    bias = rng.standard_normal((heads, l, l)).astype(np.float32)
    mask = None
    if masked:
        side = w * int(round(nw ** 0.5))
        mask = port_swin.shifted_window_mask(side, side, w, w // 2)
    qkvj = [qkv[:, :, i].transpose(0, 2, 1, 3).reshape(b * heads, l, hd) for i in range(3)]
    return qkv.reshape(b, l, -1), qkvj, bias, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,hd,masked", [(16, 16, True), (16, 32, False), (49, 32, True),
                                         (49, 16, False)])
def test_k7_plain_matches_pallas_interpret(l, hd, masked, dtype):
    rng = np.random.default_rng(l + hd + masked)
    heads, nw = 2, 4
    qkv, qkvj, bias, mask = _k7_case(rng, l, heads, hd, nw, masked)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_k7.window_attention_pallas(
        *(jnp.asarray(a, jd) for a in qkvj), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), heads=heads,
        windows_per_mask=nw, interpret=True)
    b = qkv.shape[0]
    ref = np.asarray(ref.astype(jnp.float32)).reshape(b, heads, l, hd)
    ref = torch.from_numpy(ref.transpose(0, 2, 1, 3).reshape(b, l, heads * hd).copy())
    got = k7.window_attention_plain(
        torch.from_numpy(qkv).to(td), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), heads, nw)
    assert got.dtype == td and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    else:
        rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 3e-2 and k7.ulp_error(got, ref.to(td), heads) <= k7.ULP_TOL


def test_k7_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(3)
    qkv, _, bias, mask = _k7_case(rng, 49, 2, 32, 4, True)
    args = (torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(bias),
            torch.from_numpy(mask), 2, 4)
    kcuda.reset_launch_counts()
    torch.testing.assert_close(k7.window_attention(*args), k7.window_attention_plain(*args),
                               rtol=0, atol=0)
    assert kcuda.launch_counts()["window_attention"] == 0
    assert k7.window_attention.masked_launches == 0
    assert not _build.is_loaded()
    meta = torch.empty(8, 49, 192, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        k7.window_attention(meta, args[1].to("meta"), None, 2)


@pytest.mark.parametrize("masked", [True, False])
def test_k7_check_refuses_every_planted_fault(masked):
    """The card's K7 check (ulp_error <= ULP_TOL) with the plain version as
    the kernel: the right output passes, each planted fault fails."""
    rng = np.random.default_rng(5 + masked)
    heads, nw = 3, 4
    qkv, _, bias, mask = _k7_case(rng, 49, heads, 32, nw, masked)
    qkv = torch.from_numpy(qkv).to(torch.bfloat16)
    bias = torch.from_numpy(bias)
    mask = None if mask is None else torch.from_numpy(mask)
    wpm = nw if masked else 1
    ref = k7.window_attention_plain(qkv, bias, mask, heads, wpm)
    assert k7.ulp_error(k7.window_attention(qkv, bias, mask, heads, wpm), ref, heads) == 0
    faults = k7.planted_outputs(k7.window_attention_plain, qkv, bias, mask, heads, nw)
    want = {"relative bias dropped", "bias window-fastest", "scale omitted",
            "ring off by one stage", "last strip's valid rows dropped"}   # G = 3: one group
    assert set(faults) == (want | {"mask dropped", "mask of the window before"} if masked
                           else want)
    for name, bad in faults.items():
        assert k7.ulp_error(bad, ref, heads) > k7.ULP_TOL, name


# -- the numpy helpers, bit for bit

@pytest.mark.parametrize("window,table_window", [(7, None), (4, None), (6, 7), (3, 7), (2, 4)])
def test_relative_position_index_matches_jax(window, table_window):
    got = port_swin.relative_position_index(window, table_window)
    want = jax_swin.relative_position_index(window, table_window)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("h,w,window,shift", [(56, 56, 7, 3), (28, 28, 7, 3), (14, 14, 7, 3),
                                              (8, 8, 4, 2), (16, 8, 4, 2)])
def test_shifted_window_mask_matches_jax(h, w, window, shift):
    got = port_swin.shifted_window_mask(h, w, window, shift)
    want = jax_swin.shifted_window_mask(h, w, window, shift)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- the model against the JAX package

def test_swin_matches_jax(small):
    name, cfg, px = small
    tree = _jax_swin_tree(name, 10)
    x, xt = _images(11, 2, px)
    m = _port_swin(cfg, tree)
    with torch.no_grad():
        feats, logits = m.features(xt), m(xt)
    want_f = jax_swin.swin_features(_jnp(tree), jnp.asarray(x), name)
    want_l = jax_swin.swin_apply(_jnp(tree), jnp.asarray(x), name)
    assert feats.shape == want_f.shape and logits.shape == (2, CLASSES)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l), **TOL)


def test_k7_wiring_matches_the_jax_pallas_branch(small, monkeypatch):
    """The port's K7 branch (packed qkv in, head-fastest window-heads, mask
    of window b % nW), forced on the CPU through the plain version, against
    the JAX package's Pallas branch (pallas '1', the kernel in interpret
    mode), float32."""
    name, cfg, px = small
    tree = _jax_swin_tree(name, 20)
    x, xt = _images(21, 2, px)
    monkeypatch.setattr(jax_k7, "window_attention_pallas",
                        functools.partial(jax_k7.window_attention_pallas, interpret=True))
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(pallas="1")):
        want = jax_swin.swin_features(_jnp(tree), jnp.asarray(x), name)
    calls = []
    real = port_swin.window_attention

    def spy(qkv, bias, mask, heads, windows_per_mask):
        calls.append(mask is not None)
        return real(qkv, bias, mask, heads, windows_per_mask)

    monkeypatch.setattr(port_swin, "window_kernel_applies", lambda x, plan: True)
    monkeypatch.setattr(port_swin, "window_attention", spy)
    with torch.no_grad():
        got = _port_swin(cfg, tree).features(xt)
    assert len(calls) == sum(cfg["depths"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_k7_calls(name, px, monkeypatch):
    """(calls, masked calls) of the Pallas kernel in one JAX swin_features
    with pallas '1', traced on abstract shapes."""
    calls = []

    def spy(q, k, v, bias, mask=None, *, heads, windows_per_mask=1):
        calls.append(mask is not None)
        return q

    monkeypatch.setattr(jax_k7, "window_attention_pallas", spy)
    params = jax.eval_shape(lambda: jax_swin.init_swin(jax.random.PRNGKey(0), name))
    x = jax.ShapeDtypeStruct((1, px, px, 3), jnp.float32)
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(pallas="1")):
        jax.eval_shape(lambda p, x: jax_swin.swin_features(p, x, name), params, x)
    return len(calls), sum(calls)


def _port_k7_calls(cfg, px, monkeypatch):
    """(calls, masked calls) of K7 in one port forward on the meta device."""
    calls = []

    def spy(qkv, bias, mask, heads, windows_per_mask):
        calls.append(mask is not None)
        return qkv[..., :qkv.shape[-1] // 3]

    monkeypatch.setattr(port_swin, "window_kernel_applies", lambda x, plan: True)
    monkeypatch.setattr(port_swin, "window_attention", spy)
    with torch.device("meta"):
        m = SwinTransformer(cfg)
        out = m(torch.empty(1, 3, px, px))
    assert out.shape == (1, 1000)
    return len(calls), sum(calls)


@pytest.mark.parametrize("name,want", [("swin_tiny_patch4_window7_224", (12, 5)),
                                       ("swin_large_patch4_window7_224", (24, 11))])
def test_k7_launches_per_forward_follow_the_jax_shift_rule(name, want, monkeypatch):
    assert _jax_k7_calls(name, 224, monkeypatch) == want
    assert _port_k7_calls(name, 224, monkeypatch) == want


@pytest.mark.parametrize("px,match", [(64, "not divisible"), (112, "even grid")])
def test_non_divisible_grids_raise(px, match):
    with torch.device("meta"):
        m = SwinTransformer("swin_tiny_patch4_window7_224")
        with pytest.raises(ValueError, match=match):
            m.features(torch.empty(1, 3, px, px))


# -- HybridEmbed

def _jax_hybrid_tree(name, seed, embed_dim, feature_dim):
    rng = np.random.default_rng(seed)
    tree = jax_hybrid.init_hybrid_embed(jax.random.PRNGKey(seed), name, embed_dim, feature_dim)
    return _randomize(tree, rng)


def test_hybrid_embed_tokens_match_jax(small):
    name, cfg, px = small
    width = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
    tree = _jax_hybrid_tree(name, 30, 24, width)
    x, xt = _images(31, 2, px)
    m = HybridEmbed(cfg, embed_dim=24, feature_dim=width)
    m.load_state_dict(state_dict_from_jax(tree, "hybrid_embed"), strict=True)
    with torch.no_grad():
        got = m.tokens(xt)
    want = jax_hybrid.hybrid_embed_tokens(_jnp(tree), jnp.asarray(x), name)
    assert got.shape == want.shape and got.shape[-1] == 24
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hybrid_embed_width_mismatch_raises(monkeypatch):
    cfg, px = CFGS["_w4"]
    monkeypatch.setitem(jax_swin.SWIN_CFGS, "_w4", cfg)
    tree = _jax_hybrid_tree("_w4", 32, 24, CLASSES)
    with pytest.raises(ValueError, match="proj expects"):
        jax_hybrid.hybrid_embed_tokens(_jnp(tree), jnp.zeros((1, px, px, 3)), "_w4")
    m = HybridEmbed(cfg, embed_dim=24, feature_dim=CLASSES)
    with pytest.raises(ValueError, match="proj expects"):
        m.tokens(torch.zeros(1, 3, px, px))


# -- the bridge

def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("window,px", [(4, 32), (7, 56)])
def test_swin_bridge_round_trip_with_the_oracle(window, px):
    """SwinOracle (timm 0.6.5's keys) -> the JAX converter ->
    state_dict_from_jax gives the same arrays, which load strictly; the
    port's model reproduces the oracle."""
    torch.manual_seed(40 + window)
    oracle = SwinOracle(img=px, dim=16, depths=(2, 2), heads=(2, 4), window=window,
                        num_classes=CLASSES).eval()
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_()
            elif "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    sd = oracle.state_dict()
    got = state_dict_from_jax(jax_convert.convert_swin(sd), "swin")
    _assert_same(got, sd)
    m = SwinTransformer(dict(SMALL, window=window), CLASSES)
    m.load_state_dict(got, strict=True)
    x = torch.randn(2, 3, px, px)
    with torch.no_grad():
        torch.testing.assert_close(m(x), oracle(x), rtol=1e-5, atol=1e-5)


def test_hybrid_embed_bridge_round_trip():
    """A HybridEmbed state dict (the reference's `patch_embed.backbone.*` and
    `patch_embed.proj.*` layout) -> the JAX converter's pieces ->
    state_dict_from_jax(..., 'hybrid_embed') gives the same arrays."""
    cfg, _ = CFGS["_w4"]
    m = HybridEmbed(cfg, embed_dim=24, feature_dim=CLASSES)
    init_hybrid_embed_(m, torch.Generator().manual_seed(50))
    sd = m.state_dict()
    tree = {"backbone": jax_convert.convert_swin(jax_convert._sub(sd, "backbone.")),
            "proj": jax_convert._conv(sd, "proj")}
    got = state_dict_from_jax(tree, "hybrid_embed")
    _assert_same(got, sd)
    HybridEmbed(cfg, embed_dim=24, feature_dim=CLASSES).load_state_dict(got, strict=True)


def test_init_swin_follows_the_jax_init():
    """init_swin's distributions: torch's default bound for the patch conv
    and the linears, trunc_normal(0.02) (cut at 2 std) for the bias tables
    and the reductions, unit LayerNorms."""
    m = SwinTransformer(dict(SMALL, window=7), CLASSES)
    init_swin_(m, torch.Generator().manual_seed(60))
    blk = m.layers[0].blocks[0]
    table = blk.attn.relative_position_bias_table
    assert table.abs().max() <= 0.04 and 0.01 < table.std() < 0.03
    red = m.layers[0].downsample.reduction.weight
    assert red.abs().max() <= 0.04 and m.layers[0].downsample.reduction.bias is None
    for lin, fan_in in ((blk.attn.qkv, 16), (m.head, 32)):
        assert lin.weight.abs().max() <= fan_in ** -0.5 and lin.bias.abs().max() <= fan_in ** -0.5
        assert lin.weight.abs().max() > 0.5 * fan_in ** -0.5
    assert m.patch_embed.proj.weight.abs().max() <= 48 ** -0.5
    assert torch.equal(blk.norm1.weight, torch.ones(16)) and not blk.norm1.bias.any()
