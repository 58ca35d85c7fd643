"""The port's separable depthwise approximation (ops/dwsep.py, plan.dw_rank)
against the JAX package's on the CPU.

  * factors bit-equal to `factorize_dw_kernel`'s after the layout change
    ([C,1,7,7] against HWIO), energies too, on random and trained filters
    (tests/fixtures/trained_dw.npz);
  * `parse_rank_spec` and `required_block_rank` on the JAX package's cases
    and on every trained filter;
  * the features with factors against JAX `convnext_features` on an
    `add_dw_sep` tree, float32 (rtol 1e-4, atol 1e-5: the same graph up to
    summation order), and `add_dw_sep_`'s stats against `add_dw_sep`'s;
  * rank 7 reconstructing the exact depthwise conv (atol 2e-4, the JAX
    package's bound) on the plain path and through the kernel backbone's
    wiring;
  * the Predictor with rank 1 and 'auto:0.8' against the JAX Predictor on
    the same weights (stats equal, y equal, y_val within 1e-5), and its
    refusals with pallas '1' and 'stage'.
Small models: ConvNeXt depths (1,1,1,1), dims (8..64), 64 px."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.infer.engine import Predictor as JaxPredictor
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.ops import dwsep as jax_dwsep
from genconvit_tpu.ops.kernel_plan import KernelPlan as JaxPlan

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.convert import state_dict_from_jax, tree_from_state_dict
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.models import convnext as pc
from genconvit_tpu_torch.ops import cuda as kcuda
from genconvit_tpu_torch.ops import dwsep
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, SMALL_DEPTHS, SMALL_DIMS,
                                   convnext_oracle, ed_state_dict, images, jax_trees,
                                   small_backbone, vae_state_dict)

_ = small_backbone  # fixture
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trained_dw.npz")


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _trained():
    fx = np.load(FIXTURE)
    return [np.ascontiguousarray(fx[k].astype(np.float32).transpose(3, 2, 0, 1))
            for k in fx.files if k.endswith("kernel")]


@pytest.mark.parametrize("rank", [1, 2, 3, 7, 9])
def test_factors_are_bit_equal_to_jax(rank):
    rng = np.random.default_rng(rank)
    weights = [rng.standard_normal((16, 1, 7, 7)).astype(np.float32),
               torch.from_numpy(rng.standard_normal((24, 1, 7, 7)).astype(np.float32))
               .to(torch.bfloat16).float().numpy()] + _trained()[::9]
    for w in weights:
        kr, kc, e = dwsep.factorize_dw_kernel(w, rank)
        jr, jc, je = jax_dwsep.factorize_dw_kernel(_hwio(w), rank)
        r = min(rank, 7)
        assert kr.shape == (r, w.shape[0], 1, 1, 7) and kc.shape == (r, w.shape[0], 1, 7, 1)
        assert np.array_equal(kr, jr[:, 0, :, 0, :].transpose(0, 2, 1)[:, :, None, None, :])
        assert np.array_equal(kc, jc[:, :, 0, 0, :].transpose(0, 2, 1)[:, :, None, :, None])
        assert np.array_equal(e, je)


def test_parse_rank_spec_and_required_rank_match_jax():
    for spec in (0, 2, "3", "", "auto:0.9", "auto:0.85:2", "auto:1.0:7"):
        assert dwsep.parse_rank_spec(spec) == jax_dwsep.parse_rank_spec(spec)
    for bad in ("auto", "auto:1.5", "auto:0", "auto:0.9:0", "auto:a:b", "x"):
        with pytest.raises(ValueError):
            jax_dwsep.parse_rank_spec(bad)
        with pytest.raises(ValueError):
            dwsep.parse_rank_spec(bad)
        with pytest.raises(ValueError):
            KernelPlan(dw_rank=bad)
    rng = np.random.default_rng(0)
    sep = rng.standard_normal((4, 1, 7, 1)) * rng.standard_normal((4, 1, 1, 7))
    full = rng.standard_normal((4, 1, 7, 7))
    assert dwsep.required_block_rank(sep, 0.999) == 1
    assert dwsep.required_block_rank(full, 1.0) == 7
    for w in [sep, full] + _trained():
        for bar in (0.5, 0.8, 0.95, 1.0):
            assert (dwsep.required_block_rank(w, bar)
                    == jax_dwsep.required_block_rank(_hwio(np.asarray(w, np.float32)), bar))
    trained = _trained()
    assert len(trained) == 36
    e1 = np.concatenate([dwsep.factorize_dw_kernel(w, 1)[2] for w in trained])
    assert 0.25 < e1.mean() < 0.65    # tests/test_dwsep.py's bounds on the same filters
    assert all(dwsep.required_block_rank(w, 0.8) > 3 for w in trained)


def _backbone(seed=3):
    rng = np.random.default_rng(seed)
    tree = tree_from_state_dict(convnext_oracle(seed, rng).state_dict(), "convnext")
    m = pc.ConvNeXt(SMALL_DEPTHS, SMALL_DIMS, BACKBONE_CLASSES).eval()
    m.load_state_dict(state_dict_from_jax(tree, "convnext"), strict=True)
    return rng, tree, m.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("rank", [1, 2, "auto:0.5:3", "auto:0.9"])
def test_features_with_factors_match_jax(rank):
    rng, tree, m = _backbone()
    _, x, x_nhwc = images(rng)
    with torch.no_grad():
        exact = m.features(x)
    jtree, jst = jax_dwsep.add_dw_sep(tree, rank)
    st = dwsep.add_dw_sep_(m, rank)
    assert st["rank_hist"] == jst["rank_hist"]
    assert (st["blocks_sep"], st["blocks_exact"], st["count"]) == (
        jst["blocks_sep"], jst["blocks_exact"], jst["count"])
    np.testing.assert_allclose([st["energy_mean"], st["energy_min"]],
                               [jst["energy_mean"], jst["energy_min"]], rtol=1e-6)
    ref = jax_convnext.convnext_features(jtree, jnp.asarray(x_nhwc))
    with torch.no_grad():
        got = m.features(x)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    if st["blocks_sep"]:
        assert (got - exact).abs().max() > 1e-3 * exact.abs().max()


def test_rank7_reconstructs_the_exact_conv():
    rng, _, m = _backbone(4)
    _, x, _ = images(rng)
    m.prepare_kernels()
    with torch.no_grad():
        want_plain, want_kernels = m.features(x), m._features_kernels(x, "default")
    st = dwsep.add_dw_sep_(m, 7)
    assert st["rank_hist"] == {7: 4} and st["energy_min"] > 1 - 1e-6
    assert all(blk.dw_row.shape[0] == 7 for st_ in m.stages for blk in st_.blocks)
    kcuda.reset_launch_counts()
    with torch.no_grad():
        got_plain, got_kernels = m.features(x), m._features_kernels(x, "default")
    assert set(kcuda.launch_counts().values()) == {0}
    torch.testing.assert_close(got_plain, want_plain, rtol=0, atol=2e-4)
    torch.testing.assert_close(got_kernels, want_kernels, rtol=0, atol=2e-4)
    # the per-block conv itself, against the 7x7
    blk = m.stages[1].blocks[0]
    h = torch.randn(2, SMALL_DIMS[1], 8, 8).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        sep = blk.dw(h)
        torch.testing.assert_close(sep, pc.depthwise(h, blk.tensors()), rtol=0, atol=2e-4)
    assert sep.is_contiguous(memory_format=torch.channels_last)


@pytest.fixture
def small_weights(small_backbone):
    rng = np.random.default_rng(5)
    trees = jax_trees(ed_state_dict(5, rng), vae_state_dict(6, rng))
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG)
    return rng, trees, cfg


@pytest.mark.parametrize("rank", [1, "auto:0.8"])
def test_predictor_with_dw_rank_matches_the_jax_predictor(small_weights, rank):
    rng, trees, cfg = small_weights
    params = {b: state_dict_from_jax(trees[b], b) for b in ("ed", "vae")}
    pred = Predictor(cfg, device="cpu", params=params, deterministic_vae=True,
                     kernel_plan=KernelPlan(dw_rank=rank), backbone_classes=BACKBONE_CLASSES)
    jcfg = JaxConfig()
    jcfg.img_size = IMG
    jcfg.model.latent_dims = jcfg.derived_latent_dims()
    jpred = JaxPredictor(jcfg, params=trees, deterministic_vae=True, face_backend="fullframe",
                         kernel_plan=JaxPlan(dw_rank=rank))
    st, jst = pred.dw_sep_stats, jpred.dw_sep_stats
    assert st["rank_hist"] == jst["rank_hist"] and st["blocks_sep"] == jst["blocks_sep"]
    assert st["blocks_exact"] == jst["blocks_exact"]
    assert rank != 1 or st["blocks_exact"] == 0
    np.testing.assert_allclose([st["energy_mean"], st["energy_min"]],
                               [jst["energy_mean"], jst["energy_min"]], rtol=1e-6)
    frames = rng.integers(0, 256, (3, 4, IMG, IMG, 3), dtype=np.uint8)
    mask = np.ones((3, 4), np.float32)
    mask[2, 1:] = 0
    y, y_val = pred.predict_videos_batched(frames, mask)
    jy, jy_val = jpred.predict_videos_batched(frames, mask)
    np.testing.assert_array_equal(y, np.asarray(jy))
    np.testing.assert_allclose(y_val, np.asarray(jy_val), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pallas", ["1", "stage"])
def test_predictor_refuses_dw_rank_with_the_exact_kernels(small_weights, pallas):
    _, trees, cfg = small_weights
    params = {b: state_dict_from_jax(trees[b], b) for b in ("ed", "vae")}
    with pytest.raises(ValueError, match="not supported"):
        Predictor(cfg, device="cpu", params=params,
                  kernel_plan=KernelPlan(pallas=pallas, dw_rank=1),
                  backbone_classes=BACKBONE_CLASSES)
    # a module that holds factors refuses the packs of those kernels itself
    m = pc.ConvNeXt(SMALL_DEPTHS, SMALL_DIMS, BACKBONE_CLASSES)
    dwsep.add_dw_sep_(m, 1)
    with pytest.raises(ValueError, match="dw_rank"):
        m.prepare_kernels(KernelPlan(pallas=pallas))
