"""The port's YUV420 transfer path against the JAX package's on the CPU:
`yuv_matrix`/`yuv_affine` bit for bit; `yuv420_to_rgb` for every matrix
form (max|Δ| <= 1e-3 on the 0-255 scale); `normalize_yuv420` (<= 2e-5 in
float32, 1 bf16 ulp in bfloat16, the channels_last layout of
`normalize_batch`); `Predictor.forward_batched_yuv` against the JAX
package's normalize_yuv420 -> genconvit_apply -> aggregate_logits on the
small backbone of test_torch_util at 64 px (deterministic VAE: y equal,
y_val within 1e-5); `predict_videos_stream_yuv` against the per-batch
forward. A planted U/V swap fails the conversion check."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.data import preprocess as jax_pre
from genconvit_tpu.infer import aggregate as jax_agg
from genconvit_tpu.models.genconvit import genconvit_apply

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.data import preprocess
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, ed_state_dict, jax_trees,
                                   small_backbone, vae_state_dict)

_ = small_backbone  # fixture
FRAMES = 4
RGB_TOL = 1e-3       # 0-255 scale: the port's multiply-adds against XLA's einsum
NORM_TOL = 2e-5      # after normalization, float32
SAME_TOL = 1e-5
PAIRS = [(s, f) for s in ("bt601", "bt709") for f in (False, True)]


def _planes(rng, n, h=10, w=14):
    return (rng.integers(0, 256, (n, h, w), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8))


def _port_rgb(planes, matrix, full_range=False):
    return preprocess.yuv420_to_rgb(*(torch.from_numpy(p) for p in planes), matrix,
                                    full_range).numpy()


def _jax_rgb(planes, matrix, full_range=False):
    return np.asarray(jax_pre.yuv420_to_rgb(*(jnp.asarray(p) for p in planes),
                                            jnp.asarray(matrix), full_range))


@pytest.mark.parametrize("space,full", PAIRS)
def test_coefficients_equal_jax(space, full):
    np.testing.assert_array_equal(preprocess.yuv_matrix(space, full),
                                  jax_pre.yuv_matrix(space, full))
    a, b = preprocess.yuv_affine(space, full), jax_pre.yuv_affine(space, full)
    assert a.dtype == b.dtype and a.shape == b.shape == (3, 4)
    np.testing.assert_array_equal(a, b)


def _matrix_forms():
    rng = np.random.default_rng(7)
    mixed = np.stack([jax_pre.yuv_affine(*PAIRS[i % 4]) for i in range(4)])
    per_frame = np.stack([jax_pre.yuv_matrix("bt709", False)] * 4)
    per_frame[1:] += rng.normal(0, 0.05, per_frame[1:].shape).astype(np.float32)
    return {"3x3 limited": (jax_pre.yuv_matrix("bt601", False), False),
            "3x3 full": (jax_pre.yuv_matrix("bt709", True), True),
            "3x4": (jax_pre.yuv_affine("bt709", False), False),
            "N3x3": (per_frame, False),
            "N3x4 mixed": (mixed, False)}


@pytest.mark.parametrize("form", list(_matrix_forms()))
def test_yuv420_to_rgb_matches_jax(form):
    matrix, full = _matrix_forms()[form]
    planes = _planes(np.random.default_rng(1), 4)
    got = _port_rgb(planes, matrix, full)
    assert got.shape == (4, 10, 14, 3) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 255.0
    np.testing.assert_allclose(got, _jax_rgb(planes, matrix, full), rtol=0, atol=RGB_TOL)
    # the matrix may also come as a tensor on the planes' device
    np.testing.assert_array_equal(
        preprocess.yuv420_to_rgb(*(torch.from_numpy(p) for p in planes),
                                 torch.from_numpy(matrix), full).numpy(), got)


def test_odd_frame_size_crops_the_chroma():
    """Odd H and W: the 2x2-repeated chroma is cropped to [:H, :W]."""
    rng = np.random.default_rng(2)
    planes = (rng.integers(0, 256, (2, 9, 13), np.uint8),
              rng.integers(0, 256, (2, 5, 7), np.uint8),
              rng.integers(0, 256, (2, 5, 7), np.uint8))
    m = jax_pre.yuv_affine("bt601", False)
    np.testing.assert_allclose(_port_rgb(planes, m), _jax_rgb(planes, m), rtol=0, atol=RGB_TOL)


def test_planted_uv_swap_fails():
    planes = _planes(np.random.default_rng(3), 2)
    m = jax_pre.yuv_affine("bt601", False)
    want = _jax_rgb(planes, m)
    swapped = _port_rgb((planes[0], planes[2], planes[1]), m)
    assert np.abs(swapped - want).max() > 100 * RGB_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["3x3 limited", "N3x4 mixed"])
def test_normalize_yuv420_matches_jax(dtype, form):
    matrix, full = _matrix_forms()[form]
    planes = _planes(np.random.default_rng(4), 4, 16, 16)
    got = preprocess.normalize_yuv420(*(torch.from_numpy(p) for p in planes), matrix, dtype,
                                      full)
    assert got.shape == (4, 3, 16, 16) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jax_pre.normalize_yuv420(*(jnp.asarray(p) for p in planes),
                                               jnp.asarray(matrix), jnp.float32, full))
    got32 = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got32, want, rtol=0, atol=NORM_TOL)
    else:
        ref = torch.from_numpy(np.array(want)).to(torch.bfloat16).float().numpy()
        # one bf16 ulp at the larger magnitude: 2^(floor(log2|x|) - 7)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
        assert (np.abs(got32 - ref) <= ulp).all()


def test_gray_planes_normalize_like_rgb_128():
    """Y 126, U = V = 128 (limited range): 1.164 x 110 = 128.04, the gray
    RGB 128 within the JAX test's 5e-3 (tests/test_yuv.py:84)."""
    y = torch.full((2, 8, 8), 126, dtype=torch.uint8)
    c = torch.full((2, 4, 4), 128, dtype=torch.uint8)
    ref = preprocess.normalize_batch(torch.full((2, 8, 8, 3), 128, dtype=torch.uint8))
    for space in ("bt601", "bt709"):
        out = preprocess.normalize_yuv420(y, c, c, preprocess.yuv_matrix(space, False))
        assert out.stride() == ref.stride()
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=5e-3)


def test_normalize_yuv420_uses_no_matmul():
    """The colour math is elementwise: no matmul, einsum or cv2 (a TF32
    flag could round a matmul on the card)."""
    import inspect

    src = inspect.getsource(preprocess)
    body = src.split("def _upsample_chroma")[1].split("def pad_faces")[0]
    for word in ("einsum", "matmul", "@ ", "cv2", "bmm"):
        assert word not in body, word


@pytest.fixture
def setup(small_backbone):
    rng = np.random.default_rng(0)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG)
    params = {b: state_dict_from_jax(trees[b], b) for b in ("ed", "vae")}
    pred = Predictor(cfg, device="cpu", params=params, deterministic_vae=True,
                     kernel_plan=KernelPlan(), backbone_classes=BACKBONE_CLASSES)
    return rng, trees, pred


def _yuv_batch(rng, v):
    planes = [rng.integers(0, 256, (v, FRAMES, IMG, IMG), np.uint8)] + [
        rng.integers(0, 256, (v, FRAMES, IMG // 2, IMG // 2), np.uint8) for _ in range(2)]
    matrix = np.stack([jax_pre.yuv_affine(*PAIRS[i % 4]) for i in range(v)])
    mask = np.ones((v, FRAMES), np.float32)
    mask[1 % v, 2:] = 0
    return planes, matrix, mask


def _jax_yuv_verdicts(trees, planes, matrix, mask):
    """The JAX engine's _forward_fn_yuv (:875-917), transcribed."""
    v, f = planes[0].shape[:2]
    flat = [jnp.asarray(p.reshape((v * f,) + p.shape[2:])) for p in planes]
    x = jax_pre.normalize_yuv420(*flat, jnp.repeat(jnp.asarray(matrix), f, axis=0))
    logits, _ = genconvit_apply(trees, x, net="genconvit", sample=False)
    per_video = jnp.concatenate([logits[: v * f].reshape(v, f, 2),
                                 logits[v * f:].reshape(v, f, 2)], axis=1)
    full_mask = jnp.concatenate([jnp.asarray(mask)] * 2, axis=1)
    y, y_val = jax.vmap(jax_agg.aggregate_logits)(per_video, full_mask)
    return np.asarray(y), np.asarray(y_val)


def test_forward_batched_yuv_matches_jax(setup):
    rng, trees, pred = setup
    planes, matrix, mask = _yuv_batch(rng, 3)
    y_ref, v_ref = _jax_yuv_verdicts(trees, planes, matrix, mask)
    y, y_val = pred.forward_batched_yuv(*(torch.from_numpy(a) for a in planes),
                                        torch.from_numpy(matrix), torch.from_numpy(mask))
    np.testing.assert_array_equal(y.numpy(), y_ref)
    np.testing.assert_allclose(y_val.numpy(), v_ref, rtol=0, atol=SAME_TOL)
    # the same videos converted on the host and scored as RGB: the same
    # model input up to the uint8 rounding of the frames
    rgb = np.stack([preprocess.yuv420_to_rgb(
        *(torch.from_numpy(p[i]) for p in planes), matrix[i]).round().to(torch.uint8).numpy()
        for i in range(3)])
    y2, v2 = pred.predict_videos_batched(rgb, mask)
    np.testing.assert_allclose(v2, y_val.numpy(), rtol=0, atol=2e-2)


def test_predict_videos_stream_yuv_equals_forward_per_batch(setup):
    rng, _, pred = setup
    batches = [_yuv_batch(rng, v) for v in (2, 3, 1)]
    got = pred.predict_videos_stream_yuv(iter((tuple(p), m, k) for p, m, k in batches))
    assert len(got) == 3
    for (gy, gv), (planes, matrix, mask) in zip(got, batches, strict=True):
        wy, wv = pred.forward_batched_yuv(*(torch.from_numpy(a) for a in planes),
                                          torch.from_numpy(matrix), torch.from_numpy(mask))
        assert gy.dtype == np.int64 and gv.dtype == np.float32
        np.testing.assert_array_equal(gy, wy.numpy())
        np.testing.assert_array_equal(gv, wv.numpy())
    # one [3,4] matrix for the whole batch
    planes, matrix, mask = batches[0]
    (gy, gv), = pred.predict_videos_stream_yuv([(tuple(planes), matrix[0], mask)])
    wy, wv = pred.forward_batched_yuv(*(torch.from_numpy(a) for a in planes),
                                      torch.from_numpy(np.stack([matrix[0]] * 2)),
                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(gv, wv.numpy())
    assert pred.predict_videos_stream_yuv([]) == []
