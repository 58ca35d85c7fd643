"""The port's int8 configuration against the JAX package on the CPU: the
quantizers and the K4 folds (bit for bit), the K3 and K4 plain versions
against the Pallas kernels in interpret mode (float32), the int8 backbone
wiring, and the Predictor with int8 latent heads against the JAX scoring
path on quantized trees; plus the plan's int8 switches and the wrappers'
CPU dispatch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.models.vae import quantize_latent_heads_int8
from genconvit_tpu.ops import kernel_plan as jax_kernel_plan
from genconvit_tpu.ops.pallas import convnext_mlp as jax_mlp
from genconvit_tpu.ops.pallas import int8_matmul as jax_int8

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.models.convnext import ConvNeXt
from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops import quant
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda import convnext_mlp_int8 as k4
from genconvit_tpu_torch.ops.cuda import int8_matmul as k3
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_engine import _jax_verdicts
from tests.test_torch_kernels import _block_params
from tests.test_torch_util import (BACKBONE_CLASSES, IMG, SMALL_DEPTHS,
                                   SMALL_DIMS, convnext_oracle, ed_state_dict,
                                   images, jax_trees, small_backbone,
                                   vae_state_dict)

_ = small_backbone  # fixture
t = torch.from_numpy


def _weights(rng, shape, zero_col=True):
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 2.0, shape[1])).astype(np.float32)
    if zero_col:
        w[:, 3] = 0.0  # a zero column gets scale 1
    return w


def test_quantize_wint8_is_the_jax_quantizer_bit_for_bit():
    w = _weights(np.random.default_rng(0), (257, 96))   # [K, N]
    wq_ref, s_ref = jax_int8.quantize_wint8(w)
    wq, s = quant.quantize_wint8(t(w))
    np.testing.assert_array_equal(wq.numpy(), wq_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    # the torch Linear layout [N, K], per row: the same numbers transposed
    wq_t, s_t = quant.quantize_wint8(t(w.T.copy()), dim=1)
    np.testing.assert_array_equal(wq_t.numpy(), wq_ref.T)
    np.testing.assert_array_equal(s_t.numpy(), s_ref)
    assert s_ref[3] == 1.0 and not wq_ref[:, 3].any()


def test_quant_cols_and_rows_are_the_jax_quantizers_bit_for_bit():
    rng = np.random.default_rng(1)
    w = _weights(rng, (64, 256))
    wq_ref, s_ref = jax_mlp._quant_cols_np(jnp.asarray(w))
    wq, s = quant.quant_cols(t(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    v = (3 * rng.standard_normal((50, 128))).astype(np.float32)
    v[7] = 0.0  # amax floored at 1e-30
    q_ref, sc_ref = jax_mlp._quant_rows(jnp.asarray(v))
    q, sc = quant.quant_rows(t(v))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_ref))


def _bf16_params(p):
    """The block's params rounded to bf16 (as the kernel path holds them),
    kept as float32 arrays."""
    return jax.tree_util.tree_map(
        lambda a: t(a).to(torch.bfloat16).float().numpy(), p)


def _fold_int8(p, mode, dtype=torch.float32):
    return k4.fold_block_mlp_int8(
        t(p["norm"]["scale"]), t(p["norm"]["bias"]),
        t(p["mlp"]["fc1"]["kernel"].T.copy()), t(p["mlp"]["fc1"]["bias"]),
        t(p["mlp"]["fc2"]["kernel"].T.copy()), t(p["mlp"]["fc2"]["bias"]),
        t(p["gamma"]), mode, dtype)


@pytest.mark.parametrize("mode", ["fc1", "full"])
def test_k4_fold_is_the_jax_fold(mode):
    """wq1, s1 (with 8/127 in 'fc1'), wq2, s2 equal convnext_mlp.py:388-422
    on the same bf16-cast weights."""
    p = _bf16_params(_block_params(np.random.default_rng(2), 32))
    lns = jnp.asarray(p["norm"]["scale"])
    w1 = jnp.asarray(p["mlp"]["fc1"]["kernel"])
    wg32 = lns[:, None] * w1
    w2g32 = jnp.asarray(p["mlp"]["fc2"]["kernel"]) * jnp.asarray(p["gamma"])[None, :]
    wq1, s1 = jax_mlp._quant_cols_np(wg32)
    f = _fold_int8(p, mode, torch.bfloat16)
    assert f.mode == mode
    np.testing.assert_array_equal(f.wq1.t().numpy(), np.asarray(wq1))
    if mode == "fc1":
        s1 = s1 * (jax_mlp._FIXED_ACT_CLIP / 127.0)
        np.testing.assert_array_equal(f.w2g.float().numpy(),
                                      np.asarray(w2g32.astype(jnp.bfloat16).astype(jnp.float32)))
        assert f.wq2 is None and f.s2 is None
    else:
        wq2, s2 = jax_mlp._quant_cols_np(w2g32)
        np.testing.assert_array_equal(f.wq2.t().numpy(), np.asarray(wq2))
        np.testing.assert_array_equal(f.s2.numpy(), np.asarray(s2))
        assert f.w2g is None
    np.testing.assert_array_equal(f.s1.numpy(), np.asarray(s1))
    bw = jnp.asarray(p["norm"]["bias"]) @ w1 + jnp.asarray(p["mlp"]["fc1"]["bias"])
    np.testing.assert_allclose(f.bw.numpy(), np.asarray(bw), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 200, 48), (7, 1000, 300), (15, 333, 97)])
def test_k3_plain_matches_pallas_interpret(m, k, n, xdtype):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq_ref, s = jax_int8.quantize_wint8(_weights(rng, (k, n), zero_col=False))
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    xj = jnp.asarray(x).astype(xdtype)
    ref = jax_int8.matmul_wint8(xj, jnp.asarray(wq_ref), jnp.asarray(s), jnp.asarray(b),
                                interpret=True)
    xt = t(x).to(getattr(torch, xdtype))
    got = k3.matmul_wint8_plain(xt, t(wq_ref.T.copy()), t(s), t(b))
    assert got.dtype == xt.dtype and got.shape == (m, n)
    ref32 = np.asarray(ref.astype(jnp.float32))
    if xdtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref32, rtol=1e-5, atol=1e-5)
    else:
        # both round the same f32 result to bf16; a summation-order
        # difference may flip that rounding: one bf16 ulp (2^-8 relative)
        np.testing.assert_allclose(got.float().numpy(), ref32, rtol=2 ** -8, atol=1e-5)


# [1, 5, 10, C] -> R = 50 rows, ragged against every row tile
@pytest.mark.parametrize("tier", ["default", "hp"])
@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("mode", ["fc1", "full"])
def test_k4_plain_matches_pallas_interpret(mode, c, post_ln, tier):
    rng = np.random.default_rng(c + 2 * post_ln + 4 * (tier == "hp") + 8 * (mode == "full"))
    shape = (1, 5, 10, c)
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
    got = k4.ln_mlp_residual_int8_plain(
        t(dw), t(x), _fold_int8(p, mode),
        None if post is None else tuple(map(t, post)), tier).numpy()
    # both quantize the same f32 y and h up to summation order
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _port_convnext(tree):
    m = ConvNeXt(SMALL_DEPTHS, SMALL_DIMS, BACKBONE_CLASSES).eval()
    m.load_state_dict(state_dict_from_jax(tree, "convnext"), strict=True)
    return m.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("mode", ["fc1", "full"])
def test_int8_backbone_wiring_matches_jax_kernel_backbone(mode):
    """The port's kernel backbone under each int8 mode, with the wrappers'
    CPU path, against the JAX whole-backbone kernel path (Pallas in
    interpret mode, channels padded to 128 lanes; real_c keeps the
    moments, maxima and products exact)."""
    rng = np.random.default_rng(11)
    tree = jax_convert.convert_convnext(convnext_oracle(11, rng).state_dict())
    _, x, x_nhwc = images(rng)
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(int8_mlp=mode)):
        ref = np.asarray(jax_convnext._features_mlp_kernel(tree, jnp.asarray(x_nhwc)))
    m = _port_convnext(tree)
    m.prepare_kernels(KernelPlan(int8_mlp=mode))
    with torch.no_grad(), pytest.raises(RuntimeError, match="int8_mlp"):
        m._features_kernels(x, "default")        # folds of another mode
    kcuda.reset_launch_counts()
    with torch.no_grad():
        got = m._features_kernels(x, "default", mode).permute(0, 2, 3, 1).numpy()
    assert all(v == 0 for v in kcuda.launch_counts().values())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # the int8 tails differ from K1's by far more than the tolerance
    m.prepare_kernels(KernelPlan())
    with torch.no_grad():
        k1 = m._features_kernels(x, "default").permute(0, 2, 3, 1).numpy()
    assert np.abs(k1 - ref).max() > 10 * 1e-4


def test_int8_heads_predictor_matches_jax(small_backbone):
    """The Predictor with int8 latent heads (K3's plain path on the CPU)
    against genconvit_apply on quantize_latent_heads_int8 of the same
    trees: y exact, y_val within 1e-5."""
    rng = np.random.default_rng(12)
    trees = jax_trees(ed_state_dict(12, rng), vae_state_dict(13, rng))
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG)
    params = {b: state_dict_from_jax(trees[b], b) for b in ("ed", "vae")}
    pred = Predictor(cfg, device="cpu", params=params, deterministic_vae=True,
                     kernel_plan=KernelPlan(int8_heads=True),
                     backbone_classes=BACKBONE_CLASSES)
    enc = pred.model.vae.encoder
    assert enc.heads_int8 and enc.mu.wq.dtype == torch.int8
    qtrees = dict(trees, vae=quantize_latent_heads_int8(trees["vae"]))
    frames = rng.integers(0, 256, (3, 4, IMG, IMG, 3), dtype=np.uint8)
    mask = np.ones((3, 4), np.float32)
    mask[1, 2:] = 0
    y_ref, v_ref = _jax_verdicts(qtrees, frames, mask)
    kcuda.reset_launch_counts()
    y, y_val = pred.predict_videos_batched(frames, mask)
    assert kcuda.launch_counts()["matmul_wint8"] == 0
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(y_val, v_ref, rtol=0, atol=1e-5)
    # the quantized heads differ from the float ones: the check is not vacuous
    _, v_float = _jax_verdicts(trees, frames, mask)
    assert np.abs(v_float - v_ref).max() > 1e-7
    with pytest.raises(RuntimeError, match="int8"):
        pred.state_dicts()


def test_kernel_plan_int8_switches_from_env(monkeypatch):
    for var in ("GENCONVIT_GELU", "GENCONVIT_EXACT_GELU", "GENCONVIT_PALLAS",
                "GENCONVIT_INT8_MLP", "GENCONVIT_INT8_HEADS"):
        monkeypatch.delenv(var, raising=False)
    assert KernelPlan.from_env() == KernelPlan()
    for raw, want in (("0", ""), ("", ""), ("1", "full"), ("fc1", "fc1"), ("full", "full")):
        monkeypatch.setenv("GENCONVIT_INT8_MLP", raw)
        assert KernelPlan.from_env().int8_mlp == want
        jax_want = jax_kernel_plan.KernelPlan.from_env().int8_mlp
        assert want == jax_want, raw
    for raw, want in (("1", True), ("0", False), ("", False), ("yes", False)):
        monkeypatch.setenv("GENCONVIT_INT8_HEADS", raw)
        assert KernelPlan.from_env().int8_heads is want
    monkeypatch.setenv("GENCONVIT_INT8_MLP", "w8a8")
    with pytest.raises(ValueError, match="int8_mlp"):
        KernelPlan.from_env()
    with pytest.raises(ValueError, match="int8_heads"):
        KernelPlan(int8_heads=1)


def test_int8_wrappers_take_plain_path_on_cpu_and_refuse_what_they_do_not_take():
    rng = np.random.default_rng(14)
    c = 32
    f = _fold_int8(_block_params(rng, c), "full")
    dw = t(rng.standard_normal((2, 3, 4, c)).astype(np.float32))
    x = t(rng.standard_normal((2, 3, 4, c)).astype(np.float32))
    kcuda.reset_launch_counts()
    torch.testing.assert_close(k4.ln_mlp_residual_int8(dw, x, f),
                               k4.ln_mlp_residual_int8_plain(dw, x, f), rtol=0, atol=0)
    xm = x.reshape(-1, c)
    args = (t(np.ones((8, c), np.int8)), torch.ones(8), torch.zeros(8))
    torch.testing.assert_close(k3.matmul_wint8(xm, *args), k3.matmul_wint8_plain(xm, *args),
                               rtol=0, atol=0)
    assert kcuda.launch_counts() == {"ln_mlp_residual": 0, "layer_norm_rows": 0,
                                     "ln_mlp_residual_int8": 0, "matmul_wint8": 0,
                                     "fused_convnext_block": 0, "fused_convnext_stage": 0,
                                     "window_attention": 0, "dots_bf16": 0, "dots_int8": 0,
                                     "block_parts": 0, "dw_moments": 0}
    assert not _build.is_loaded()
    with pytest.raises(ValueError, match="mode"):
        k4.ln_mlp_residual_int8(dw, x, f._replace(mode="w4a8"))
    with pytest.raises(ValueError, match="mode"):
        _fold_int8(_block_params(rng, c), "w4a8")
    meta = torch.empty(4, c, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        k4.ln_mlp_residual_int8(meta, meta, f)
    with pytest.raises(ValueError, match="unsupported device"):
        k3.matmul_wint8(meta, *args)
