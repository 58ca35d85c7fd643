"""The port's pallas plan values 'mlp', 'mlp:<i,j,...>' and 'mlpfull'
against the JAX package's on the CPU.

  * the values parse as the JAX package reads them: the stages its
    `_apply_stage` sends to `_apply_stage_mlp_kernel` (traced with
    abstract shapes, the TPU as the backend of models/convnext.py alone),
    against `KernelPlan.mlp_stages`; 'mlpfull' takes the kernel backbone in
    both; values outside the set are refused;
  * a chosen stage (`stage_mlp`, K1's plain version through its wrapper on
    CPU tensors) against JAX `_apply_stage_mlp_kernel` (Pallas in interpret
    mode) in float32, both GELU tiers (rtol 1e-4, atol 1e-4, as
    tests/test_torch_models.py holds the kernel backbone), and the whole
    'mlp:0,1' backbone in bfloat16 against JAX convnext_features on that
    path (max |diff| within 2e-2 of max |ref|: bf16 roundings at the same
    points, sums in other orders);
  * the launch counts of one ensemble forward at full width, 224 px, on
    the meta device (the wrappers counted, not run) against the kernel
    calls the JAX package traces, for '', 'mlpfull', 'mlp', 'mlp:0,1' and
    int8_mlp='fc1', with the original and the updated VAE;
  * `MlpStage`'s forward equal to the path with folds of the call's own
    weights, its gradient against JAX `_apply_stage_mlp_bwd` (float32 1e-5,
    bfloat16 2e-2 relative L2: tests/test_torch_train_kernels.py's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core.pytree import cast_floats
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.models.genconvit import genconvit_apply, init_genconvit
from genconvit_tpu.ops import kernel_plan as jax_kernel_plan
from genconvit_tpu.ops.pallas import convnext_mlp as jax_mlp

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.convert import state_dict_from_jax, tree_from_state_dict
from genconvit_tpu_torch.models import convnext as pc
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_util import SMALL_DEPTHS, SMALL_DIMS, convnext_oracle, images

VALUES = ("", "0", "1", "stage", "mlpfull", "mlp", "mlp:0,1", "mlp:2", "mlp:3,1,0", "mlp:0")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


class _TpuJax:
    """jax as models/convnext.py of the JAX package sees it on one TPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"

    @staticmethod
    def device_count():
        return 1


def _jax_routes(pallas, monkeypatch):
    """What the JAX package's convnext_features runs on a bf16 input with
    the TPU as its backend: 'full' (the kernel backbone) or the sorted
    stages of _apply_stage_mlp_kernel."""
    calls = []
    monkeypatch.setattr(jax_convnext, "jax", _TpuJax())
    monkeypatch.setattr(jax_convnext, "_features_mlp_kernel",
                        lambda p, x: calls.append("full") or x[:, ::32, ::32, :1])
    monkeypatch.setattr(jax_convnext, "_apply_stage_mlp_kernel",
                        lambda blocks, x: calls.append(len(calls)) or x)
    monkeypatch.setattr(jax_convnext, "_stage_pallas_op", lambda blocks, x: x)
    monkeypatch.setattr(jax_convnext, "_block_pallas_op", lambda p, x: x)
    monkeypatch.setattr(jax_convnext, "_block_xla_folded", lambda p, x: x)
    params = jax.eval_shape(lambda: jax_convnext.init_convnext(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16), params)
    stages = []

    def apply_stage(blocks, x, si=-1, _orig=jax_convnext._apply_stage):
        before = len(calls)
        out = _orig(blocks, x, si)
        if len(calls) > before:
            stages.append(si)
        return out

    monkeypatch.setattr(jax_convnext, "_apply_stage", apply_stage)
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(pallas=pallas)):
        jax.eval_shape(lambda p, v: jax_convnext.convnext_features(p, v), params,
                       jax.ShapeDtypeStruct((2, 224, 224, 3), jnp.bfloat16))
    monkeypatch.undo()
    return "full" if "full" in calls else tuple(sorted(stages))


@pytest.mark.parametrize("pallas", VALUES)
def test_values_parse_as_jax_reads_them(pallas, monkeypatch):
    plan = KernelPlan(pallas=pallas)
    monkeypatch.setenv("GENCONVIT_PALLAS", pallas)
    monkeypatch.setenv("GENCONVIT_KERNEL_PLAN_ASSET", "0")
    monkeypatch.delenv("GENCONVIT_KERNEL_PLAN", raising=False)
    assert KernelPlan.from_env().pallas == jax_kernel_plan.KernelPlan.from_env().pallas == pallas
    route = _jax_routes(pallas, monkeypatch)
    if pallas.startswith("mlp") and pallas != "mlpfull":
        assert tuple(sorted(plan.mlp_stages())) == route
    else:
        assert plan.mlp_stages() is None
        assert route == ("full" if pallas in ("", "mlpfull") else ())


@pytest.mark.parametrize("bad", ["mlp:", "mlp:4", "mlpx", "mlp:0,,1", "mlp: 1", "stage2", "2"])
def test_values_outside_the_set_are_refused(bad):
    with pytest.raises(ValueError, match="pallas"):
        KernelPlan(pallas=bad)


def _backbone(seed=9):
    rng = np.random.default_rng(seed)
    tree = tree_from_state_dict(convnext_oracle(seed, rng).state_dict(), "convnext")
    m = pc.ConvNeXt(SMALL_DEPTHS, SMALL_DIMS, 10).eval()
    m.load_state_dict(state_dict_from_jax(tree, "convnext"), strict=True)
    return rng, tree, m.to(memory_format=torch.channels_last)


def _nhwc(t):
    return np.ascontiguousarray(t.detach().float().permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("tier", ["default", "hp"])
def test_stage_path_matches_apply_stage_mlp_kernel(tier):
    rng, tree, m = _backbone()
    m.prepare_kernels()
    for si, c in enumerate(SMALL_DIMS):
        h = 16 >> si
        x = torch.from_numpy(rng.standard_normal((2, c, h, h)).astype(np.float32))
        x = x.contiguous(memory_format=torch.channels_last)
        with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(gelu=tier)):
            ref = jax_convnext._apply_stage_mlp_kernel(tree["stages"][si]["blocks"],
                                                      jnp.asarray(_nhwc(x)))
        blocks = [blk.tensors() for blk in m.stages[si].blocks]
        with torch.no_grad():
            got = pc.stage_mlp(x, blocks, m._kernel_weights.blocks[si], tier, km.ln_mlp_residual)
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_mlp_backbone_matches_jax_in_bf16(monkeypatch):
    rng, tree, m = _backbone(10)
    m = m.to(torch.bfloat16)
    m.prepare_kernels(KernelPlan(pallas="mlp:0,1"))
    _, x, x_nhwc = images(rng)
    monkeypatch.setattr(jax_convnext, "jax", _TpuJax())
    with jax_kernel_plan.plan_scope(jax_kernel_plan.KernelPlan(pallas="mlp:0,1")):
        ref = jax_convnext.convnext_features(cast_floats(tree, jnp.bfloat16),
                                             jnp.asarray(x_nhwc, jnp.bfloat16))
    with torch.no_grad():
        got = m._features_mlp(x.to(torch.bfloat16), "default", frozenset({0, 1}))
    ref = np.asarray(ref, np.float32)
    err = np.abs(_nhwc(got) - ref).max() / np.abs(ref).max()
    assert err <= 2e-2, err


def _count_port(cfg, plan, monkeypatch):
    """Kernel calls of one bf16 ensemble forward on the meta device, the
    wrappers stubbed and the CUDA rule of backbone_path taken as met."""
    calls = {"k1": 0, "k4": 0, "k2": 0}

    def tail(name):
        def f(d, x, folded, post, gelu):
            calls[name] += 1
            return x
        return f

    def ln_rows(x, s, b):
        calls["k2"] += 1
        return x

    monkeypatch.setattr(pc, "ln_mlp_residual", tail("k1"))
    monkeypatch.setattr(pc, "ln_mlp_residual_int8", tail("k4"))
    monkeypatch.setattr(pc, "layer_norm_rows", ln_rows)
    real = pc.backbone_path
    monkeypatch.setattr(pc, "backbone_path", lambda x, p: real(_Cuda(x), p))
    with torch.device("meta"):
        model = GenConViT(cfg, "genconvit").to(torch.bfloat16)
        model.prepare_kernels(plan)
        x = torch.empty(2, 3, 224, 224, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
    with torch.no_grad():
        model(x, plan, sample=False)
    monkeypatch.undo()
    return calls


class _Cuda:
    """A tensor's dtype, claiming CUDA (backbone_path reads the two)."""

    def __init__(self, x):
        self.dtype, self.is_cuda = x.dtype, True


def _count_jax(variant, plan, monkeypatch):
    calls = {"k1": 0, "k4": 0, "k2": 0}

    def fused(dw, x, p, **kw):
        calls["k4" if plan.int8_mlp else "k1"] += 1
        return x

    def ln_rows(t, s, b, **kw):
        calls["k2"] += 1
        return t

    monkeypatch.setattr(jax_convnext, "jax", _TpuJax())
    monkeypatch.setattr(jax_mlp, "fused_ln_mlp_residual", fused)
    monkeypatch.setattr(jax_mlp, "layer_norm_rows", ln_rows)
    from genconvit_tpu.config import Config as JaxConfig

    jcfg = JaxConfig()
    jcfg.model.vae_variant = variant
    params = jax.eval_shape(lambda: init_genconvit(jax.random.PRNGKey(0), jcfg))
    params = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16), params)
    with jax_kernel_plan.plan_scope(plan):
        jax.eval_shape(lambda p, v: genconvit_apply(p, v, sample=False)[0], params,
                       jax.ShapeDtypeStruct((2, 224, 224, 3), jnp.bfloat16))
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("variant", ["original", "updated"])
@pytest.mark.parametrize("pallas,int8_mlp,want", [
    ("", "", {"k1": 54, "k4": 0, "k2": 3}),
    ("mlpfull", "", {"k1": 54, "k4": 0, "k2": 3}),
    ("mlp", "", {"k1": 54, "k4": 0, "k2": 0}),
    ("mlp:0,1", "", {"k1": 18, "k4": 0, "k2": 0}),
    ("mlp:0,1", "fc1", {"k1": 0, "k4": 18, "k2": 0}),
])
def test_launch_counts_match_the_jax_trace(variant, pallas, int8_mlp, want, monkeypatch):
    plan = KernelPlan(pallas=pallas, int8_mlp=int8_mlp)
    cfg = Config(model=ModelConfig(vae_variant=variant))
    got = _count_port(cfg, plan, monkeypatch)
    ref = _count_jax(variant, jax_kernel_plan.KernelPlan(pallas=pallas, int8_mlp=int8_mlp),
                     monkeypatch)
    assert got == ref
    if variant == "updated":   # the VAE's two backbone calls are one 2N call
        want = {k: v * 2 // 3 for k, v in want.items()}
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_stage_backward_matches_apply_stage_mlp_bwd(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    _, tree, m = _backbone(11)
    m = m.to(tdt)
    si = 1
    blocks = m.stages[si].blocks
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, SMALL_DIMS[si], 8, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, SMALL_DIMS[si], 8, 8)).astype(np.float32))
    x = x.to(tdt).contiguous(memory_format=torch.channels_last).requires_grad_()
    g = g.to(tdt).contiguous(memory_format=torch.channels_last)
    flat = [t for blk in blocks for t in blk.tensors()]
    out = pc.MlpStage.apply("default", (km.ln_mlp_residual, ""), x, *flat)
    with torch.no_grad():
        want = pc.stage_mlp(x, [b.tensors() for b in blocks],
                            [pc.fold_tail(b.tensors()) for b in blocks], "default",
                            km.ln_mlp_residual)
    assert torch.equal(out, want)
    out.backward(g)
    bl = cast_floats(jax.tree_util.tree_map(jnp.asarray, tree["stages"][si]["blocks"]), jdt)
    db, dx = jax.jit(jax_convnext._apply_stage_mlp_bwd)(
        (bl, jnp.asarray(_nhwc(x), jdt)), jnp.asarray(_nhwc(g), jdt))

    def rel(a, b):
        a = np.concatenate([np.asarray(v, np.float64).ravel() for v in jax.tree_util.tree_leaves(a)])
        b = np.concatenate([np.asarray(v, np.float64).ravel()
                            for v in jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                                lambda v: jnp.asarray(v, jnp.float32), b))])
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
             for k, p in m.named_parameters()}
    gtree = tree_from_state_dict(grads, "convnext")["stages"][si]["blocks"]
    assert rel(gtree, db) < TOL[dtype]
    assert rel(_nhwc(x.grad), dx) < TOL[dtype]
