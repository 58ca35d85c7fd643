"""The port's Predictor against the JAX scoring path in float32 on the CPU:
normalize -> genconvit_apply -> per-video masked aggregation, on the same
weights and a batch with masked frames (y exact, y_val within 1e-5), plus
the preprocessing and aggregation helpers."""

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
from genconvit_tpu_torch.infer import aggregate
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, ed_state_dict,
                                   jax_trees, small_backbone, vae_state_dict)

_ = small_backbone  # fixture
FRAMES = 4


@pytest.fixture
def setup(small_backbone):
    rng = np.random.default_rng(0)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG)
    params = {b: state_dict_from_jax(trees[b], b) for b in ("ed", "vae")}
    pred = Predictor(cfg, device="cpu", params=params, deterministic_vae=True,
                     kernel_plan=KernelPlan(), backbone_classes=BACKBONE_CLASSES)
    return rng, trees, pred


def _jax_verdicts(trees, frames, mask):
    v, f = frames.shape[:2]
    x = jax_pre.normalize_batch(jnp.asarray(frames.reshape((v * f,) + frames.shape[2:])))
    logits, _ = genconvit_apply(trees, x, net="genconvit", sample=False)
    per_video = jnp.concatenate([logits[: v * f].reshape(v, f, 2),
                                 logits[v * f:].reshape(v, f, 2)], axis=1)
    full_mask = jnp.concatenate([jnp.asarray(mask)] * 2, axis=1)
    y, y_val = jax.vmap(jax_agg.aggregate_logits)(per_video, full_mask)
    return np.asarray(y), np.asarray(y_val)


def test_predict_videos_batched_matches_jax(setup):
    rng, trees, pred = setup
    frames = rng.integers(0, 256, (3, FRAMES, IMG, IMG, 3), dtype=np.uint8)
    mask = np.ones((3, FRAMES), np.float32)
    mask[1, 2:] = 0
    mask[2, 1:] = 0
    y_ref, v_ref = _jax_verdicts(trees, frames, mask)
    y, y_val = pred.predict_videos_batched(frames, mask)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(y_val, v_ref, rtol=0, atol=1e-5)


def test_predict_faces(setup):
    rng, _, pred = setup
    assert pred.predict_faces(np.zeros((0, IMG, IMG, 3), np.uint8), FRAMES) \
        == aggregate.DEFAULT_VERDICT == (0, 0.5)
    faces = rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    batch, mask = preprocess.pad_faces(faces, FRAMES, IMG)
    y, y_val = pred.predict_videos_batched(batch[None], mask[None])
    assert pred.predict_faces(faces, FRAMES) == (int(y[0]), float(y_val[0]))


def test_random_init_predictor_runs(small_backbone):
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG)
    pred = Predictor(cfg, device="cpu", seed=3)
    frames = np.random.default_rng(1).integers(0, 256, (2, 2, IMG, IMG, 3), dtype=np.uint8)
    y, y_val = pred.predict_videos_batched(frames, np.ones((2, 2), np.float32))
    assert y.shape == y_val.shape == (2,)
    assert np.isin(y, (0, 1)).all() and ((0 <= y_val) & (y_val <= 1)).all()
    assert pred.dtype == torch.float32
    assert set(pred.state_dicts()) == {"ed", "vae"}


def test_normalize_and_pad_match_jax():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = preprocess.normalize_batch(torch.from_numpy(frames))
    assert got.shape == (2, 3, 8, 8)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jax_pre.normalize_batch(jnp.asarray(frames))),
                               rtol=1e-6, atol=1e-6)
    many = np.concatenate([frames] * 3)
    for k in (0, 2, 5):  # none, fewer than F, more than F faces
        for a, b in zip(preprocess.pad_faces(many[:k], 4, 8),
                        jax_pre.pad_faces(many[:k], 4, 8)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(preprocess.IMAGENET_MEAN, jax_pre.IMAGENET_MEAN)
    np.testing.assert_array_equal(preprocess.IMAGENET_STD, jax_pre.IMAGENET_STD)


def test_aggregate_matches_jax():
    rng = np.random.default_rng(3)
    logits = (2 * rng.standard_normal((5, 6, 2))).astype(np.float32)
    mask = (rng.random((5, 6)) > 0.4).astype(np.float32)
    mask[0] = 0  # a video with no valid frame
    logits[1, :, 1] = logits[1, :, 0]  # tied class means
    y_ref, v_ref = jax.vmap(jax_agg.aggregate_logits)(jnp.asarray(logits), jnp.asarray(mask))
    y, y_val = aggregate.aggregate_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    np.testing.assert_allclose(y_val.numpy(), np.asarray(v_ref), rtol=1e-6, atol=1e-7)
    for p in (0, 1):
        assert aggregate.real_or_fake(p) == jax_agg.real_or_fake(p)
