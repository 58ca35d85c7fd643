"""The port's resizes and face crops against the JAX package's on the CPU:
the weight matrices equal (the same numpy), `resize_area` and
`crop_resize_batch` within 1e-5 of the JAX functions, and after
`round_to_u8` within 1 LSB of cv2.resize(INTER_AREA) (cv2 rounds its own
fixed-point or float sums), on the JAX package's own box set
(tests/test_ops.py:238-280) and on boxes that up- and downscale and touch
the frame's edges; `crop_faces` keeps quirk B7's budget."""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genconvit_tpu.data import faces as jax_faces
from genconvit_tpu.ops import resize as jax_resize

from genconvit_tpu_torch.data.faces import crop_faces
from genconvit_tpu_torch.ops import resize

TOL = 1e-5   # of the 0-255 range: float32 products on the same weights, summed in another order


def _frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("in_hw,out_hw", [((120, 160), (48, 48)), ((48, 40), (64, 64)),
                                          ((100, 30), (64, 64)), ((256, 256), (128, 128)),
                                          ((1080, 1920), (128, 128)), ((37, 300), (37, 64))])
def test_resize_area_matches_jax_and_cv2(in_hw, out_hw):
    x = _frames(0, 2, *in_hw)
    got = resize.resize_area(torch.from_numpy(x), out_hw)
    want = np.asarray(jax_resize.resize_area(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * 255)
    u8 = resize.round_to_u8(got).numpy()
    for i in range(len(x)):
        ref = cv2.resize(x[i], (out_hw[1], out_hw[0]), interpolation=cv2.INTER_AREA)
        assert np.abs(u8[i].astype(int) - ref).max() <= 1


@pytest.mark.parametrize("in_size,out_size", [(120, 48), (48, 64), (1080, 128), (7, 3)])
def test_weight_matrices_equal_jax(in_size, out_size):
    for method, port in (("area", resize._area_weights),
                         ("bilinear_torch", resize._bilinear_torch_weights)):
        np.testing.assert_array_equal(port(in_size, out_size),
                                      jax_resize.resize_weight_matrix(in_size, out_size, method))
    for lo, hi in ((0, in_size), (1, in_size - 1), (in_size // 3, in_size // 3 + 5)):
        for fb in (False, True):
            np.testing.assert_array_equal(
                resize.crop_resize_weights(in_size, lo, hi, out_size, fb),
                jax_resize.crop_resize_weights(in_size, lo, hi, out_size, fb))


# the JAX package's box sets (tests/test_ops.py:238-280), frame edges, a
# 1-pixel crop and a crop whose one axis up- and the other downscales
_BOXES = [(10, 150, 110, 30), (0, 160, 120, 0), (10, 60, 58, 12), (0, 40, 30, 0),
          (20, 150, 100, 30), (119, 160, 120, 159), (0, 160, 20, 0), (60, 10, 120, 0)]


@pytest.mark.parametrize("out", [48, 64])
def test_crop_resize_batch_matches_jax_and_cv2(out):
    frames = _frames(1, len(_BOXES), 120, 160)
    pairs = [resize.crop_resize_weights_pair(120, 160, bx, out) for bx in _BOXES]
    for bx, (wh, ww) in zip(_BOXES, pairs):
        jwh, jww = jax_resize.crop_resize_weights_pair(120, 160, bx, out)
        np.testing.assert_array_equal(wh, jwh)
        np.testing.assert_array_equal(ww, jww)
    wh = np.stack([p[0] for p in pairs])
    ww = np.stack([p[1] for p in pairs])
    got = resize.crop_resize_batch(torch.from_numpy(frames), torch.from_numpy(wh),
                                   torch.from_numpy(ww))
    want = np.asarray(jax_resize.crop_resize_batch(jnp.asarray(frames), jnp.asarray(wh),
                                                   jnp.asarray(ww)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * 255)
    u8 = resize.round_to_u8(got).numpy().astype(int)
    for i, (t, r, b, lf) in enumerate(_BOXES):
        ref = cv2.resize(frames[i, t:b, lf:r], (out, out), interpolation=cv2.INTER_AREA)
        assert np.abs(u8[i] - ref).max() <= 1, _BOXES[i]


def test_round_to_u8_saturates_and_rounds_half_even():
    x = torch.tensor([-3.0, 0.5, 1.5, 2.5, 254.5, 255.4, 300.0])
    assert resize.round_to_u8(x).tolist() == [0, 0, 2, 2, 254, 255, 255]


def test_crop_faces_matches_jax_within_one_lsb():
    """Two faces a frame, boxes past the frame's edges (clipped as numpy
    slices clip them), an empty and a reversed box (no slot), up- and
    downscaling crops; the budget ends mid-frame (quirk B7)."""
    frames = _frames(2, 5, 90, 130)
    boxes = [[(0, 130, 90, 0), (10, 70, 50, 20)],
             [(-5, 40, 30, 10), (30, 30, 30, 10)],
             [(50, 140, 120, 60), (40, 20, 80, 60)],
             [(5, 125, 85, 5), (0, 64, 64, 0), (20, 100, 70, 40)],
             [(0, 10, 10, 0)]]
    for budget in (0, 3, 6, 20):
        got = crop_faces(frames, boxes, budget, img_size=64, device="cpu")
        want = jax_faces.crop_faces(frames, boxes, budget, img_size=64)
        assert got.dtype == torch.uint8 and got.shape == want.shape, budget
        if len(want):
            assert np.abs(got.numpy().astype(int) - want).max() <= 1, budget


def test_crop_faces_takes_a_device_tensor_and_zero_boxes():
    frames = _frames(3, 2, 32, 32)
    x = torch.from_numpy(frames)
    a = crop_faces(x, [[(0, 32, 32, 0)], []], 4, img_size=16)
    b = crop_faces(frames, [[(0, 32, 32, 0)], []], 4, img_size=16, device="cpu")
    assert torch.equal(a, b) and a.shape == (1, 16, 16, 3)
    assert crop_faces(x, [[], []], 4, img_size=16).shape == (0, 16, 16, 3)
