"""The port's cv2 host ops (genconvit_tpu_torch/data/imgops.py) against cv2
itself on seeded inputs: the YCrCb conversion over all 2^24 RGB colours,
inRange, the morphology, the largest component (ties too), the resizes
bit-equal on uint8, and warpAffine under _paste's rotation and shear draws
within 0.02 on a 0-255 float32 face (measured max|diff| 9.6e-04 over the
draws below)."""

import cv2
import numpy as np
import pytest

from genconvit_tpu_torch.data import imgops

from tests.test_torch_util import seeded_faces

SKIN_LO, SKIN_HI = (0, 133, 77), (255, 180, 127)
WARP_TOL = 0.02


@pytest.fixture(scope="module")
def every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    return rgb.reshape(4096, 4096, 3)


def test_ycrcb_is_cv2s_on_every_colour(every_colour):
    want = cv2.cvtColor(every_colour, cv2.COLOR_RGB2YCrCb)
    np.testing.assert_array_equal(imgops.rgb_to_ycrcb_u8(every_colour), want)


def test_in_range_is_cv2s(every_colour):
    ycrcb = cv2.cvtColor(every_colour, cv2.COLOR_RGB2YCrCb)
    want = cv2.inRange(ycrcb, SKIN_LO, SKIN_HI)
    got = imgops.in_range(ycrcb, SKIN_LO, SKIN_HI)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert 0 < (want > 0).mean() < 1


def _masks(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(20, 160, 2))
        m = ((rng.random((h, w)) < rng.uniform(0.2, 0.7)) * 255).astype(np.uint8)
        m = cv2.GaussianBlur(m, (5, 5), 0)
        yield ((m > 128) * 255).astype(np.uint8)


def _cv2_largest(mask):
    n, _, st, _ = cv2.connectedComponentsWithStats(mask)
    if n < 2:
        return None
    b = int(np.argmax(st[1:, cv2.CC_STAT_AREA])) + 1
    return tuple(int(st[b, k]) for k in (cv2.CC_STAT_AREA, cv2.CC_STAT_LEFT, cv2.CC_STAT_TOP,
                                           cv2.CC_STAT_WIDTH, cv2.CC_STAT_HEIGHT))


def test_morphology_and_largest_component_are_cv2s():
    for mask in _masks(0, 30):
        opened = imgops.morph_open(mask, 5)
        np.testing.assert_array_equal(
            opened, cv2.morphologyEx(mask, cv2.MORPH_OPEN, np.ones((5, 5), np.uint8)))
        closed = imgops.morph_close(opened, 9)
        np.testing.assert_array_equal(
            closed, cv2.morphologyEx(opened, cv2.MORPH_CLOSE, np.ones((9, 9), np.uint8)))
        for m in (mask, closed):
            assert imgops.largest_component(m) == _cv2_largest(m)
    assert imgops.largest_component(np.zeros((8, 8), np.uint8)) is None


def test_equal_areas_break_as_cv2s_labels():
    """cv2 labels by 2 x 2 blocks, so a blob whose first pixel comes later in
    raster order can still win: here B starts on row 0, A on row 1 of the
    same row pair, left of B."""
    m = np.zeros((20, 20), np.uint8)
    m[1:3, 0:2] = 255
    m[0:2, 10:12] = 255
    assert imgops.largest_component(m) == _cv2_largest(m) == (4, 0, 1, 2, 2)
    rng = np.random.default_rng(1)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(20, 300, 2))
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(2, 12))):
            y, x = int(rng.integers(0, h - 3)), int(rng.integers(0, w - 3))
            m[y:y + 2, x:x + 2] = 255
        assert imgops.largest_component(m) == _cv2_largest(m)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resizes_are_cv2s(dtype):
    """INTER_AREA (integer factors, area tables, upscale taps on both axes
    when either upscales) and INTER_LINEAR: uint8 bit-equal, float32 within
    float rounding."""
    rng = np.random.default_rng(2)
    shapes = [((79, 140), (91, 101)), ((256, 256), (128, 128)), ((384, 384), (128, 128)),
              ((360, 640), (128, 128)), ((77, 77), (128, 128)), ((32, 32), (128, 128)),
              ((129, 131), (128, 128))]
    shapes += [((int(a), int(b)), (int(c), int(d)))
               for a, b, c, d in rng.integers(16, 300, (12, 4))]
    tol = 0 if dtype == np.uint8 else 1e-4
    for (h, w), dsize in shapes:
        img = (rng.random((h, w, 3)) * 255).astype(dtype)
        for mode, fn in ((cv2.INTER_AREA, imgops.resize_area),
                         (cv2.INTER_LINEAR, imgops.resize_linear)):
            want = cv2.resize(img, dsize, interpolation=mode)
            got = fn(img, dsize)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.abs(got.astype(np.float64) - want).max() <= tol, ((h, w), dsize, mode)


def test_warp_affine_under_pastes_draws():
    rng = np.random.default_rng(3)
    worst = 0.0
    for face in seeded_faces(4, 6):
        sh, sw = (int(v) for v in rng.integers(36, 108, 2))
        face = cv2.resize(face.astype(np.float32), (sw, sh), interpolation=cv2.INTER_AREA)
        alpha = np.clip(rng.random((sh, sw)) * 1.5, 0, 1).astype(np.float32)
        ang, shear = rng.uniform(-22, 22), rng.uniform(-0.35, 0.35)
        m = cv2.getRotationMatrix2D((sw / 2, sh / 2), ang, 1.0)
        np.testing.assert_allclose(imgops.rotation_matrix_2d((sw / 2, sh / 2), ang, 1.0), m,
                                   rtol=0, atol=1e-12)
        m[0, 1] += shear
        m[0, 2] -= shear * sh / 2
        want = cv2.warpAffine(face, m, (sw, sh), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT)
        got = imgops.warp_affine_linear(face, m, (sw, sh), border="reflect")
        worst = max(worst, float(np.abs(got - want).max()))
        want_a = cv2.warpAffine(alpha, m, (sw, sh), flags=cv2.INTER_LINEAR)
        got_a = imgops.warp_affine_linear(alpha, m, (sw, sh))
        assert np.abs(got_a - want_a).max() <= 1e-4
    assert worst <= WARP_TOL
