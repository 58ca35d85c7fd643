"""The port's kernel modules against the JAX package: K1/K2 plain versions
vs the Pallas kernels in interpret mode (float32, rtol = atol = 1e-5 —
the same math in the same order up to float32 summation order), the bf16
ulp check that holds the CUDA kernels to those plain versions on the card,
the GELU tiers and erf constants, the kernel plan, and the CPU dispatch of
the kernel wrappers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.ops import act as jax_act
from genconvit_tpu.ops.pallas.common import gelu_f32
from genconvit_tpu.ops.pallas.convnext_mlp import (fused_ln_mlp_residual,
                                                   layer_norm_rows)

from genconvit_tpu_torch.ops import act
from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan


def _block_params(rng, c):
    f = np.float32
    return {
        "norm": {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(f),
                 "bias": (0.1 * rng.standard_normal(c)).astype(f)},
        "mlp": {"fc1": {"kernel": (rng.standard_normal((c, 4 * c)) / np.sqrt(c)).astype(f),
                        "bias": (0.05 * rng.standard_normal(4 * c)).astype(f)},
                "fc2": {"kernel": (rng.standard_normal((4 * c, c)) / np.sqrt(4 * c)).astype(f),
                        "bias": (0.05 * rng.standard_normal(c)).astype(f)}},
        "gamma": rng.uniform(0.1, 1.0, c).astype(f),
    }


def _fold(p):
    t = torch.from_numpy
    return km.fold_block_mlp(
        t(p["norm"]["scale"]), t(p["norm"]["bias"]),
        t(p["mlp"]["fc1"]["kernel"].T.copy()), t(p["mlp"]["fc1"]["bias"]),
        t(p["mlp"]["fc2"]["kernel"].T.copy()), t(p["mlp"]["fc2"]["bias"]),
        t(p["gamma"]), torch.float32)


# [1, 5, 10, C] -> R = 50 rows: ragged against every row tile
@pytest.mark.parametrize("tier", ["default", "hp"])
@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("c", [16, 32])
def test_k1_plain_matches_pallas_interpret(c, post_ln, tier):
    rng = np.random.default_rng(c + 2 * post_ln + 4 * (tier == "hp"))
    shape = (1, 5, 10, c)
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
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [16, 32])
def test_k2_plain_matches_pallas_interpret(c):
    rng = np.random.default_rng(10 + c)
    x = (3 * rng.standard_normal((1, 5, 10, c)) + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = layer_norm_rows(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                          interpret=True)
    got = km.layer_norm_rows_plain(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bf16_ulp_error_counts_ulps():
    ref = torch.tensor([[3.0, -0.75, 100.0, 1e-3]]).to(torch.bfloat16)
    assert km.bf16_ulp_error(ref, ref) == 0.0
    one_up = ref.float() + torch.ldexp(torch.ones(1, 4), torch.frexp(ref.float())[1] - 8)
    assert km.bf16_ulp_error(one_up.to(torch.bfloat16), ref) == 1.0
    f32_step = torch.nextafter(ref.float(), torch.tensor(1e9))
    assert km.bf16_ulp_error(f32_step, ref) < 1e-4
    # near 0 the ulp is that of max|ref| / 128 (2^-8 here); x widens it for
    # a residual sum (2^-2 at |x| = 40)
    near0 = ref.float()
    near0[0, 3] += 0.25
    assert km.bf16_ulp_error(near0, ref) == pytest.approx(0.25 * 2 ** 8, rel=1e-2)
    x = torch.tensor([[0.0, 0.0, 0.0, 40.0]])
    assert km.bf16_ulp_error(near0, ref, x) == pytest.approx(1.0, rel=1e-2)
    # scale= sets that floor: 2^-1 at scale 80
    assert km.bf16_ulp_error(near0, ref, scale=80.0) == pytest.approx(0.5, rel=1e-2)


def _timm_block(rng, c):
    """Block weights as timm initializes them (std 0.02), with layer scale
    U(0.1, 1): the MLP branch is a few percent of the residual sum."""
    f = np.float32
    p = _block_params(rng, c)
    p["mlp"]["fc1"]["kernel"] = (0.02 * rng.standard_normal((c, 4 * c))).astype(f)
    p["mlp"]["fc2"]["kernel"] = (0.02 * rng.standard_normal((4 * c, c))).astype(f)
    p["mlp"]["fc1"]["bias"] = (0.02 * rng.standard_normal(4 * c)).astype(f)
    p["mlp"]["fc2"]["bias"] = (0.02 * rng.standard_normal(c)).astype(f)
    return p


def _bf16_fold(p, **drop):
    """The block's folds in bf16; drop= zeroes a term (or sets gamma to 1),
    as a kernel that forgot it would compute."""
    t = {"ln_scale": p["norm"]["scale"], "ln_bias": p["norm"]["bias"],
         "fc1_weight": p["mlp"]["fc1"]["kernel"].T, "fc1_bias": p["mlp"]["fc1"]["bias"],
         "fc2_weight": p["mlp"]["fc2"]["kernel"].T, "fc2_bias": p["mlp"]["fc2"]["bias"],
         "gamma": p["gamma"]}
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t.items()}
    for k, v in drop.items():
        t[k] = torch.full_like(t[k], v)
    return km.fold_block_mlp(**t, dtype=torch.bfloat16)


def _branch_max(dw, f):
    """max|bf16(o)|: K1's output at x = 0 is the MLP branch alone."""
    return km.ln_mlp_residual_plain(dw, torch.zeros_like(dw), f).float().abs().max().item()


def _plain_reordered(dw, x, f, tier, chunk):
    """K1's plain math with the hidden summed chunk by chunk, last chunk
    first: another float32 summation order, as the kernel's chunk loop has."""
    d32 = dw.float()
    mean = d32.mean(-1, keepdim=True)
    var = (d32 * d32).mean(-1, keepdim=True) - mean * mean
    y = ((d32 - mean) * torch.rsqrt(var + km.LN_EPS)).to(x.dtype).float()
    o = torch.zeros(x.shape[:-1] + (x.shape[-1],))
    for k in reversed(range(0, f.wg.shape[1], chunk)):
        z = y @ f.wg[:, k:k + chunk].float() + f.bw[k:k + chunk]
        h = act.gelu_rational_f32(z, tier).to(x.dtype).float()
        o = o + h @ f.w2g[k:k + chunk].float()
    return x + (o + f.b2g).to(x.dtype)


@pytest.mark.parametrize("zero_x", [False, True])
def test_ulp_check_passes_a_reordered_sum(zero_x):
    """Another summation order stays within ULP_TOL of the plain version."""
    rng = np.random.default_rng(20 + zero_x)
    c, rows = 32, 4000
    p = _timm_block(rng, c)
    dw = torch.from_numpy(2 * rng.standard_normal((rows, c)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32)).to(torch.bfloat16)
    if zero_x:
        x = torch.zeros_like(x)
    f = _bf16_fold(p)
    ref = km.ln_mlp_residual_plain(dw, x, f)
    got = _plain_reordered(dw, x, f, "default", chunk=32)
    assert km.bf16_ulp_error(got, ref, x, _branch_max(dw, f)) <= km.ULP_TOL


@pytest.mark.parametrize("drop", [{"fc2_bias": 0.0}, {"ln_bias": 0.0}, {"gamma": 1.0}],
                         ids=["fc2_bias", "ln_bias", "layer_scale"])
def test_ulp_check_catches_a_dropped_term(drop):
    """A K1 that forgets one term of its math fails the ulp check at timm's
    weight scale, where max|diff| / max|ref| stays under 3e-2."""
    rng = np.random.default_rng(30)
    c, rows = 32, 4000
    p = _timm_block(rng, c)
    dw = torch.from_numpy(2 * rng.standard_normal((rows, c)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32)).to(torch.bfloat16)
    ref = km.ln_mlp_residual_plain(dw, x, _bf16_fold(p))
    bad = km.ln_mlp_residual_plain(dw, x, _bf16_fold(p, **drop))
    assert km.bf16_ulp_error(bad, ref, x, _branch_max(dw, _bf16_fold(p))) > km.ULP_TOL
    assert (bad.float() - ref.float()).abs().max() / ref.float().abs().max() < 3e-2


def test_erf_constants_are_the_jax_packages():
    for name in ("_ERF_P", "_ERF_Q", "_ERF_ZMAX", "_ERF_P_LO", "_ERF_Q_LO",
                 "_ERF_ZMAX_LO"):
        assert getattr(act, name) == getattr(jax_act, name), name


_Z = np.concatenate([np.linspace(-12, 12, 4001),
                     [-3.625, -3.0, 0.0, 3.0, 3.625]]).astype(np.float32)


@pytest.mark.parametrize("tier", ["default", "hp"])
def test_erf_rational_matches_act(tier):
    fn = jax_act._erf_rational_f32 if tier == "hp" else jax_act._erf_rational_f32_lo
    got = act.erf_rational(torch.from_numpy(_Z), tier).numpy()
    np.testing.assert_allclose(got, np.asarray(fn(jnp.asarray(_Z))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tier", ["default", "hp"])
def test_gelu_rational_matches_kernel_math(tier):
    ref = gelu_f32(jnp.asarray(_Z), exact_div=True, hp=tier == "hp")
    got = act.gelu_rational_f32(torch.from_numpy(_Z), tier).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_gelu_tiers_dispatch():
    z = torch.from_numpy(_Z)
    exact = jax.nn.gelu(jnp.asarray(_Z), approximate=False)
    # float32 keeps the exact erf whatever the tier
    for tier in act.GELU_TIERS:
        np.testing.assert_allclose(act.gelu(z, tier).numpy(), np.asarray(exact),
                                   rtol=1e-6, atol=1e-6)
    zb = z.to(torch.bfloat16)
    xb = jnp.asarray(_Z).astype(jnp.bfloat16)
    # bf16: the rational default tier, as gelu_fast under the default plan
    np.testing.assert_array_equal(
        act.gelu(zb, "default").float().numpy(),
        np.asarray(jax_act.gelu_fast(xb).astype(jnp.float32)))
    np.testing.assert_array_equal(
        act.gelu(zb, "exact").float().numpy(),
        torch.nn.functional.gelu(zb).float().numpy())


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    rng = np.random.default_rng(3)
    c = 32
    p = _block_params(rng, c)
    dw = torch.from_numpy(rng.standard_normal((2, 3, 4, c)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, c)).astype(np.float32))
    post = (torch.ones(c), torch.zeros(c))
    kcuda.reset_launch_counts()
    for pl in (None, post):
        torch.testing.assert_close(km.ln_mlp_residual(dw, x, _fold(p), pl),
                                   km.ln_mlp_residual_plain(dw, x, _fold(p), pl),
                                   rtol=0, atol=0)
    torch.testing.assert_close(km.layer_norm_rows(x, *post),
                               km.layer_norm_rows_plain(x, *post), rtol=0, atol=0)
    assert set(kcuda.launch_counts().values()) == {0}
    assert not _build.is_loaded()


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor on neither the CPU nor CUDA raises; it never falls back."""
    c = 32
    folded = km.FoldedMLP(*(torch.empty(s, device="meta") for s in
                            ((c, 4 * c), (4 * c,), (4 * c, c), (c,))))
    t = torch.empty(4, c, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        km.ln_mlp_residual(t, t, folded)
    with pytest.raises(ValueError, match="unsupported device"):
        km.layer_norm_rows(t, folded.b2g, folded.b2g)


def test_fold_matches_the_jax_fold():
    """fold_block_mlp == the host folds of convnext_mlp.py:388-397."""
    rng = np.random.default_rng(5)
    p = _block_params(rng, 16)
    f = _fold(p)
    w1 = p["mlp"]["fc1"]["kernel"]
    np.testing.assert_allclose(f.wg.numpy(), p["norm"]["scale"][:, None] * w1, rtol=1e-6)
    np.testing.assert_allclose(f.bw.numpy(), p["norm"]["bias"] @ w1 + p["mlp"]["fc1"]["bias"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f.w2g.numpy(), p["mlp"]["fc2"]["kernel"] * p["gamma"][None],
                               rtol=1e-6)
    np.testing.assert_allclose(f.b2g.numpy(), p["mlp"]["fc2"]["bias"] * p["gamma"], rtol=1e-6)


def test_kernel_plan_from_env(monkeypatch):
    for var in ("GENCONVIT_GELU", "GENCONVIT_EXACT_GELU", "GENCONVIT_PALLAS"):
        monkeypatch.delenv(var, raising=False)
    assert KernelPlan.from_env() == KernelPlan("", "default")
    monkeypatch.setenv("GENCONVIT_GELU", "hp")
    monkeypatch.setenv("GENCONVIT_PALLAS", "0")
    assert KernelPlan.from_env() == KernelPlan("0", "hp")
    monkeypatch.setenv("GENCONVIT_EXACT_GELU", "1")
    assert KernelPlan.from_env().gelu == "exact"
    monkeypatch.setenv("GENCONVIT_PALLAS", "stage")
    assert KernelPlan.from_env().pallas == "stage"
    monkeypatch.setenv("GENCONVIT_PALLAS", "bogus")
    with pytest.raises(ValueError, match="pallas"):
        KernelPlan.from_env()
    with pytest.raises(ValueError, match="gelu"):
        KernelPlan(gelu="tanh")


_PLAN_VARS = ("GENCONVIT_GELU", "GENCONVIT_EXACT_GELU", "GENCONVIT_PALLAS", "GENCONVIT_INT8_MLP",
              "GENCONVIT_INT8_HEADS", "GENCONVIT_DW_RANK", "GENCONVIT_KERNEL_PLAN",
              "GENCONVIT_MLP_PANEL", "GENCONVIT_MLP_SPLIT")
_TUNED = {"pallas": "stage", "gelu": "hp", "int8_mlp": "fc1", "mlp_panel_mb": 16,
          "mlp_split": 2, "_meta": {"chip": "TPU v5 lite"}, "unknown_knob": 1}


# (plan file or None, variables set, whether the port must refuse)
@pytest.mark.parametrize("plan,env,refused", [
    (None, {"GENCONVIT_DW_RANK": "1"}, True),
    (None, {"GENCONVIT_DW_RANK": "auto:0.8"}, True),
    (None, {"GENCONVIT_DW_RANK": "0", "GENCONVIT_PALLAS": "1"}, False),
    (None, {"GENCONVIT_DW_RANK": ""}, False),
    (_TUNED, {}, False),                                   # the file sets the fields
    (_TUNED, {"GENCONVIT_PALLAS": "0", "GENCONVIT_INT8_MLP": "0"}, False),  # set vars win
    (_TUNED, {"GENCONVIT_EXACT_GELU": "1", "GENCONVIT_MLP_PANEL": "4"}, False),
    ({"gelu": "hp", "dw_rank": 0}, {}, False),
    ({"pallas": "1", "dw_rank": 1}, {}, True),
    ({"dw_rank": "auto:0.8:2"}, {}, True),
    ({"dw_rank": 2}, {"GENCONVIT_DW_RANK": "0"}, False),   # a set variable overrides the file
], ids=["env-rank-1", "env-rank-auto", "env-rank-0", "env-rank-empty", "file-fields",
        "file-overridden", "file-gelu-exact", "file-rank-0", "file-rank-1", "file-rank-auto",
        "file-rank-env-0"])
def test_kernel_plan_layers_the_plan_file_and_refuses_dw_rank(monkeypatch, tmp_path, plan,
                                                               env, refused):
    """from_env layers defaults, the GENCONVIT_KERNEL_PLAN file and the set
    variables as the JAX package's from_env does, field for field; a
    non-zero dw_rank (not ported) raises instead of being ignored."""
    import json

    from genconvit_tpu.ops.kernel_plan import KernelPlan as JaxPlan

    for var in _PLAN_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GENCONVIT_KERNEL_PLAN_ASSET", "0")   # no per-chip asset in JAX
    if plan is not None:
        path = tmp_path / "plan.json"
        path.write_text(json.dumps(plan))
        monkeypatch.setenv("GENCONVIT_KERNEL_PLAN", str(path))
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    ref = JaxPlan.from_env()
    if refused:
        assert ref.dw_rank not in (0, "0")
        with pytest.raises(ValueError, match="queue 1 item 3"):
            KernelPlan.from_env()
        return
    assert ref.dw_rank == 0
    got = KernelPlan.from_env()
    assert (got.pallas, got.gelu, got.int8_mlp) == (ref.pallas, ref.gelu, ref.int8_mlp)
    assert got.int8_heads is False
