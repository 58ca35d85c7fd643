"""The fused-block (K5) and fused-stage (K6) backbones of the port against
the JAX package on the CPU: the plain versions of K5 and K6 against the
Pallas kernels in interpret mode (float32, rtol = atol = 1e-5: the same
math in the same order up to float32 summation order), the port's
dispatch rules against the JAX package's on every ConvNeXt configuration,
the port's `_features_block` / `_features_stage` wiring against a JAX
reference composed from the JAX package's own pieces (float32, 1e-4), and
the kernel plan's `pallas` values. Layer scale is U(0.1, 1), never the
1e-6 init."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.ops import kernel_plan as jax_kernel_plan
from genconvit_tpu.ops.conv import conv2d as jax_conv2d
from genconvit_tpu.ops.norm import layer_norm as jax_layer_norm
from genconvit_tpu.ops.pallas.convnext_block import fused_convnext_block as jax_k5
from genconvit_tpu.ops.pallas.convnext_stage import fused_convnext_stage as jax_k6

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models import convnext as port_convnext
from genconvit_tpu_torch.models.convnext import (CONVNEXT_CFGS, ConvNeXt,
                                                 block_kernel_applies,
                                                 stage_kernel_applies)
from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops.act import gelu_rational_f32
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.cuda import _build
from genconvit_tpu_torch.ops.cuda import convnext_block as k5
from genconvit_tpu_torch.ops.cuda import convnext_stage as k6
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.torch_oracles import ConvNeXtOracle

TOL = dict(rtol=1e-5, atol=1e-5)


def _block_params(rng, c):
    """A JAX block param tree (models/convnext.py layout), float32."""
    f = np.float32
    return {
        "conv_dw": {"kernel": (0.1 * rng.standard_normal((7, 7, 1, c))).astype(f),
                    "bias": (0.1 * rng.standard_normal(c)).astype(f)},
        "norm": {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(f),
                 "bias": (0.1 * rng.standard_normal(c)).astype(f)},
        "mlp": {"fc1": {"kernel": (rng.standard_normal((c, 4 * c)) / np.sqrt(c)).astype(f),
                        "bias": (0.05 * rng.standard_normal(4 * c)).astype(f)},
                "fc2": {"kernel": (rng.standard_normal((4 * c, c)) / np.sqrt(4 * c)).astype(f),
                        "bias": (0.05 * rng.standard_normal(c)).astype(f)}},
        "gamma": rng.uniform(0.1, 1.0, c).astype(f),
    }


def _pack(p):
    """The port's pack of a JAX block tree (torch layouts in between)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    return k5.pack_block(
        t(p["conv_dw"]["kernel"].transpose(3, 2, 0, 1)), t(p["conv_dw"]["bias"]),
        t(p["norm"]["scale"]), t(p["norm"]["bias"]),
        t(p["mlp"]["fc1"]["kernel"].T), t(p["mlp"]["fc1"]["bias"]),
        t(p["mlp"]["fc2"]["kernel"].T), t(p["mlp"]["fc2"]["bias"]), t(p["gamma"]),
        torch.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# [1, 10, 12, C]: H and W off every tile and off each other
@pytest.mark.parametrize("shape", [(2, 14, 14), (1, 10, 12)], ids=["14x14", "10x12"])
@pytest.mark.parametrize("c", [16, 32])
def test_k5_plain_matches_pallas_interpret(shape, c):
    rng = np.random.default_rng(c + shape[1])
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    p = _block_params(rng, c)
    ref = jax_k5(jnp.asarray(x), _jnp(p), interpret=True)
    got = k5.fused_convnext_block_plain(torch.from_numpy(x), _pack(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape,nb", [((2, 7, 7), 3), ((1, 14, 14), 2)], ids=["7x7x3", "14x14x2"])
@pytest.mark.parametrize("c", [16, 32])
def test_k6_plain_matches_pallas_interpret(shape, nb, c):
    rng = np.random.default_rng(100 + c + shape[1])
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    ps = [_block_params(rng, c) for _ in range(nb)]
    ref = jax_k6(jnp.asarray(x), [_jnp(p) for p in ps], interpret=True)
    got = k6.fused_convnext_stage_plain(torch.from_numpy(x),
                                        k5.stack_blocks([_pack(p) for p in ps]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_k5_and_k6_gelu_forms_are_the_jax_kernels():
    """K5's erf form and K6's gelu_f32 form, each as its JAX kernel writes it."""
    from genconvit_tpu.ops.pallas.common import gelu_f32
    from genconvit_tpu.ops.pallas.convnext_block import _erf

    z = np.concatenate([np.linspace(-12, 12, 4001), [-5.127, -3.625 * 2 ** 0.5, 0.0]])
    z = z.astype(np.float32)
    zj = jnp.asarray(z)
    ref5 = 0.5 * zj * (1.0 + _erf(zj * (2.0 ** -0.5)))
    np.testing.assert_allclose(k5.gelu_erf_hp(torch.from_numpy(z)).numpy(),
                               np.asarray(ref5), rtol=1e-6, atol=1e-7)
    ref6 = gelu_f32(zj, exact_div=True, hp=True)
    np.testing.assert_allclose(gelu_rational_f32(torch.from_numpy(z), "hp").numpy(),
                               np.asarray(ref6), rtol=1e-6, atol=1e-7)


# -- dispatch: the port's rules against the JAX package's, traced with
#    abstract shapes (jax.eval_shape computes nothing)

def _jax_dispatch(name, px, pallas, monkeypatch):
    """(H, C) of every K5 call (pallas '1') or the set of (H, C) of the K6
    stages (pallas 'stage') that the JAX package's convnext_features makes
    on a bf16 [2, px, px, 3] input with the TPU as its backend."""
    calls = []

    def block_op(p, x):
        calls.append((x.shape[1], x.shape[3]))
        return x

    def stage_op(blocks, x):
        calls.append((x.shape[1], x.shape[3]))
        return x

    monkeypatch.setattr(jax_convnext, "_block_pallas_op", block_op)
    monkeypatch.setattr(jax_convnext, "_stage_pallas_op", stage_op)
    monkeypatch.setattr(jax_convnext, "_block_xla_folded", lambda p, x: x)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    params = jax.eval_shape(lambda: jax_convnext.init_convnext(jax.random.PRNGKey(0), name))
    params = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16),
                                    params)
    x = jax.ShapeDtypeStruct((2, px, px, 3), jnp.bfloat16)
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(pallas=pallas)):
        # a fresh function, so that no cached trace of another plan is reused
        jax.eval_shape(lambda p, v: jax_convnext.convnext_features(p, v), params, x)
    monkeypatch.undo()
    return calls if pallas == "1" else sorted(set(calls))


def _port_dispatch(name, px, pallas, monkeypatch):
    """The same record from the port's _features_block / _features_stage,
    run on the meta device (shapes only), with the wrappers stubbed."""
    calls = []

    def op(x, p):
        calls.append((x.shape[1], x.shape[3]))
        return x

    monkeypatch.setattr(port_convnext, "fused_convnext_block", op)
    monkeypatch.setattr(port_convnext, "fused_convnext_stage", op)
    with torch.device("meta"):
        m = ConvNeXt.from_name(name)
        x = torch.empty(2, 3, px, px).contiguous(memory_format=torch.channels_last)
        m._fused_weights = m.pack_fused_weights(pallas)
    with torch.no_grad():
        (m._features_block if pallas == "1" else m._features_stage)(x, "default")
    monkeypatch.undo()
    return calls if pallas == "1" else sorted(set(calls))


@pytest.mark.parametrize("name", sorted(CONVNEXT_CFGS))
def test_dispatch_rules_equal_the_jax_conditions(name, monkeypatch):
    assert CONVNEXT_CFGS[name] == jax_convnext.CONVNEXT_CFGS[name]
    cfg = CONVNEXT_CFGS[name]
    for px in (224, 112):
        hs = [(px // 4) >> si for si in range(4)]
        want_k5 = [(h, c) for h, c, d in zip(hs, cfg["dims"], cfg["depths"])
                   for _ in range(d) if block_kernel_applies(h)]
        want_k6 = sorted((h, c) for h, c in zip(hs, cfg["dims"]) if stage_kernel_applies(h, c))
        assert _jax_dispatch(name, px, "1", monkeypatch) == want_k5
        assert _port_dispatch(name, px, "1", monkeypatch) == want_k5
        assert _jax_dispatch(name, px, "stage", monkeypatch) == want_k6
        assert _port_dispatch(name, px, "stage", monkeypatch) == want_k6



@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_blocks_follow_the_jax_block_rule(dtype, monkeypatch):
    """Outside the kernels both packages run a block LN-folded in bf16 and
    as the reference graph in float32 (JAX: _block, convnext.py:193-198),
    traced with abstract shapes (JAX) and on the meta device (port)."""
    jax_calls, port_calls = [], []

    def spy(calls, tag):
        def f(*args, **kwargs):
            calls.append(tag)
            return args[1]
        return f

    monkeypatch.setattr(jax_convnext, "_block_xla_folded", spy(jax_calls, "folded"))
    monkeypatch.setattr(jax_convnext, "_block_xla", spy(jax_calls, "reference"))
    jdt = getattr(jnp, dtype)
    params = jax.eval_shape(lambda: jax_convnext.init_convnext(jax.random.PRNGKey(0),
                                                               "convnext_tiny"))
    params = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape, jdt), params)
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(pallas="0")):
        jax.eval_shape(lambda p, v: jax_convnext.convnext_features(p, v), params,
                       jax.ShapeDtypeStruct((2, 64, 64, 3), jdt))
    monkeypatch.setattr(port_convnext.Block, "forward_folded", spy(port_calls, "folded"))
    monkeypatch.setattr(port_convnext.Block, "forward", spy(port_calls, "reference"))
    tdt = getattr(torch, dtype)
    with torch.device("meta"):
        m = ConvNeXt.from_name("convnext_tiny").to(tdt)
        x = torch.empty(2, 3, 64, 64, dtype=tdt).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        m._features_plain(x, "default")
    want = "folded" if dtype == "bfloat16" else "reference"
    assert jax_calls == port_calls == [want] * sum(CONVNEXT_CFGS["convnext_tiny"]["depths"])

def test_tiny_ensemble_launch_plan():
    """One ensemble forward: ED at 224 px, VAE on x at 224 and on x_hat at
    112. K5 runs 15 times; K6 on stages ED {2, 3}, VAE x {2, 3}, x_hat {2}."""
    cfg = CONVNEXT_CFGS["convnext_tiny"]
    calls = {"ed": 224, "vae_x": 224, "vae_xhat": 112}
    k5_count, k6_stages = 0, {}
    for call, px in calls.items():
        hs = [(px // 4) >> si for si in range(4)]
        k5_count += sum(d for h, d in zip(hs, cfg["depths"]) if block_kernel_applies(h))
        k6_stages[call] = {si for si, (h, c) in enumerate(zip(hs, cfg["dims"]))
                           if stage_kernel_applies(h, c)}
    assert k5_count == 15
    assert k6_stages == {"ed": {2, 3}, "vae_x": {2, 3}, "vae_xhat": {2}}


# -- model-level wiring at 112 px, where both rules fire: K5 at H = 28
#    (stage 0), K6 at H = 7 (stage 2, C = 128)

WIRING_DEPTHS = (1, 1, 2, 1)
WIRING_DIMS = (16, 32, 128, 256)
WIRING_PX = 112


def _wiring_model(seed):
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    oracle = ConvNeXtOracle(depths=WIRING_DEPTHS, dims=WIRING_DIMS, num_classes=10).eval()
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if name.endswith("gamma"):
                p.copy_(torch.from_numpy(rng.uniform(0.1, 1.0, p.shape).astype(np.float32)))
    tree = jax_convert.convert_convnext(oracle.state_dict())
    m = ConvNeXt(WIRING_DEPTHS, WIRING_DIMS, 10).eval()
    m.load_state_dict(state_dict_from_jax(tree, "convnext"), strict=True)
    x = rng.standard_normal((2, 3, WIRING_PX, WIRING_PX), dtype=np.float32)
    return tree, m.to(memory_format=torch.channels_last), x


def _jax_reference(tree, x_nhwc, pallas):
    """The JAX package's fused backbone composed from its own pieces: its
    stem and downsample convs and LayerNorms, K5 / K6 in interpret mode
    where the JAX conditions fire (convnext.py:194-195, :452-454), and
    _block_xla_folded elsewhere, as the JAX package's _block runs a bf16
    block (convnext.py:193-197); float32."""
    x = jnp.asarray(x_nhwc)
    x = jax_conv2d(x, tree["stem"]["conv"]["kernel"], tree["stem"]["conv"]["bias"], stride=4)
    x = jax_layer_norm(x, tree["stem"]["norm"]["scale"], tree["stem"]["norm"]["bias"], eps=1e-6)
    for stage in tree["stages"]:
        ds = stage.get("downsample")
        if ds is not None:
            x = jax_layer_norm(x, ds["norm"]["scale"], ds["norm"]["bias"], eps=1e-6)
            x = jax_conv2d(x, ds["conv"]["kernel"], ds["conv"]["bias"], stride=2)
        h, c = x.shape[1], x.shape[-1]
        if pallas == "stage" and h >= 7 and c % 128 == 0:
            x = jax_k6(x, stage["blocks"], interpret=True)
            continue
        for blk in stage["blocks"]:
            if pallas == "1" and h >= 28 and h % 14 == 0:
                x = jax_k5(x, blk, interpret=True)
            else:
                x = jax_convnext._block_xla_folded(blk, x)
    return np.asarray(x)


@pytest.mark.parametrize("pallas", ["1", "stage"])
def test_fused_backbone_wiring_matches_jax(pallas):
    tree, m, x = _wiring_model(40 + (pallas == "stage"))
    ref = _jax_reference(tree, x.transpose(0, 2, 3, 1), pallas)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), pytest.raises(RuntimeError, match="prepare_kernels"):
        m._features_block(xt, "default") if pallas == "1" else m._features_stage(xt, "default")
    m.prepare_kernels(KernelPlan(pallas=pallas))
    kcuda.reset_launch_counts()
    with torch.no_grad():
        path = m._features_block if pallas == "1" else m._features_stage
        got = path(xt, "default")
    assert set(kcuda.launch_counts().values()) == {0}
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_fused_packs_follow_the_plan():
    """prepare_kernels keeps only the plan's weights: K5 packs for every
    block, K6 stacks for the widths K6 takes, K1 folds otherwise."""
    _, m, _ = _wiring_model(42)
    m.prepare_kernels(KernelPlan(pallas="1"))
    assert m._kernel_weights is None
    assert [len(s) for s in m._fused_weights.stages] == list(WIRING_DEPTHS)
    assert m._fused_weights.stages[2][1].w1.shape == (128, 512)
    m.prepare_kernels(KernelPlan(pallas="stage"))
    stacks = m._fused_weights.stages
    assert [s is None for s in stacks] == [True, True, False, False]
    assert stacks[2].w_dw.shape == (2, 49, 128) and stacks[3].w2.shape == (1, 1024, 256)
    assert not any(t.requires_grad for t in stacks[2])
    folds = m._fused_weights.ln_folds
    assert [len(s) for s in folds] == list(WIRING_DEPTHS)
    assert folds[0][0].wg.shape == (16, 64) and folds[3][0].gw.shape == (1024,)
    assert not any(t.requires_grad for t in folds[1][0])
    m.prepare_kernels(KernelPlan())
    assert m._fused_weights is None and m._kernel_weights is not None
    with torch.no_grad(), pytest.raises(RuntimeError, match="prepare_kernels"):
        m._features_stage(torch.zeros(1, 3, WIRING_PX, WIRING_PX), "default")


def test_fused_paths_are_chosen_by_the_plan():
    """features() takes a fused path only for bf16 on CUDA; '1' and 'stage'
    keep their kernels with exact GELU, as the JAX package's A/B paths do."""
    cuda16 = SimpleNamespace(dtype=torch.bfloat16, is_cuda=True)
    for plan, path in ((KernelPlan(pallas="1"), "1"),
                       (KernelPlan(pallas="stage", gelu="exact"), "stage"),
                       (KernelPlan(pallas="1", gelu="exact"), "1"),
                       (KernelPlan(), "kernels"), (KernelPlan(gelu="exact"), "plain"),
                       (KernelPlan(pallas="0"), "plain")):
        assert port_convnext.backbone_path(cuda16, plan) == path, plan
    for x in (torch.zeros(1, dtype=torch.bfloat16),
              SimpleNamespace(dtype=torch.float32, is_cuda=True)):
        for pallas in ("1", "stage"):
            assert port_convnext.backbone_path(x, KernelPlan(pallas=pallas)) == "plain"


def test_fused_wrappers_take_plain_path_on_cpu_and_count_nothing():
    rng = np.random.default_rng(7)
    c = 32
    ps = [_block_params(rng, c) for _ in range(2)]
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, c)).astype(np.float32))
    kcuda.reset_launch_counts()
    torch.testing.assert_close(k5.fused_convnext_block(x, _pack(ps[0])),
                               k5.fused_convnext_block_plain(x, _pack(ps[0])), rtol=0, atol=0)
    stack = k5.stack_blocks([_pack(p) for p in ps])
    torch.testing.assert_close(k6.fused_convnext_stage(x, stack),
                               k6.fused_convnext_stage_plain(x, stack), rtol=0, atol=0)
    counts = kcuda.launch_counts()
    assert counts["fused_convnext_block"] == counts["fused_convnext_stage"] == 0
    assert set(counts.values()) == {0}
    assert not _build.is_loaded()


def test_fused_wrappers_refuse_devices_without_a_kernel():
    """A tensor on neither the CPU nor CUDA raises; it never falls back."""
    c = 32
    p = k5.FusedBlockWeights(*(torch.empty(s, device="meta") for s in
                               ((49, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,),
                                (4 * c, c), (c,), (c,))))
    t = torch.empty(1, 4, 4, c, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        k5.fused_convnext_block(t, p)
    with pytest.raises(ValueError, match="unsupported device"):
        k6.fused_convnext_stage(t, k5.stack_blocks([p]))


def _stage_holds(x, stack, truth=None):
    """The card's K6 check (tests/test_torch_cuda.py), block by block at
    K5's bound, with the wrapper's CPU path as the kernel."""
    for xin, out, ref in k6.stage_steps(k6.fused_convnext_stage, x, stack, truth):
        scale = (ref.float() - xin.float()).abs().max().item()
        rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        if rel > 3e-2 or km.bf16_ulp_error(out, ref, xin, scale) > k5.ULP_TOL:
            return False
    return True


def test_chain_check_refuses_a_fault_in_one_middle_block():
    """Held block by block, a chain passes on its own blocks and every
    planted fault fails, the LN bias dropped in the middle block alone too
    (bf16, 5 blocks)."""
    rng = np.random.default_rng(9)
    c, nb = 32, 5
    packs = [k5.FusedBlockWeights(*(t.to(torch.bfloat16) if t.dim() == 2 else t
                                    for t in _pack(_block_params(rng, c))))
             for _ in range(nb)]
    stack = k5.stack_blocks(packs)
    x = torch.from_numpy(rng.standard_normal((2, 7, 7, c)).astype(np.float32)).to(torch.bfloat16)
    steps = list(k6.stage_steps(k6.fused_convnext_stage, x, stack))
    assert len(steps) == nb
    torch.testing.assert_close(steps[-1][1], k6.fused_convnext_stage_plain(x, stack),
                               rtol=0, atol=0)
    assert _stage_holds(x, stack)
    faults = k6.chain_faults(packs)
    assert {"LN bias dropped in block 2 only", "block 2 skipped", "blocks reversed"} <= set(faults)
    for name, bad in faults.items():
        assert not _stage_holds(x, bad, stack), name


@pytest.mark.parametrize("raw,want", [("1", "1"), ("stage", "stage")])
def test_kernel_plan_from_env_takes_the_fused_modes(raw, want, monkeypatch):
    monkeypatch.setenv("GENCONVIT_PALLAS", raw)
    plan = KernelPlan.from_env()
    assert plan.pallas == want
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan.from_env()):
        assert jax_kernel_plan.current_plan().pallas == want
