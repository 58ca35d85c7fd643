"""The detector's synthetic data (genconvit_tpu_torch/data/facedet_synth.py)
against the JAX module, function by function, from the same Generator
state over seeded faces and frames: after every call both generators'
states are equal (checked explicitly), boxes are exactly equal, uint8
images within 2 in every pixel (over this file's draws at most 1, in
0.025% of synth_dataset's pixels: where the float32 face's resize and warp
round differently from cv2's and the blend truncates at an integer). The
skin detector's boxes equal the JAX detector's, without cv2."""

import os

import cv2
import numpy as np
import pytest

from genconvit_tpu.data import facedet_synth as J
from genconvit_tpu.data.faces import SkinDetector as JaxSkinDetector

from genconvit_tpu_torch.data import facedet_synth as P
from genconvit_tpu_torch.data.faces import SkinDetector

from tests.test_torch_util import seeded_faces, seeded_frames

PIXEL_TOL = 2
DIFF_SHARE = 1e-3   # the share of pixels that may differ at all


@pytest.fixture(scope="module")
def media():
    return seeded_faces(1, 8), seeded_frames(2, 9)


def _pair(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _same_state(r1, r2):
    assert r1.bit_generator.state == r2.bit_generator.state


class Pixels:
    """Counts the pixels compared and those that differ."""

    def __init__(self):
        self.n = self.diff = 0

    def check(self, a, b):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        d = np.abs(a.astype(np.int32) - b)
        assert d.max() <= PIXEL_TOL
        self.n += d.size
        self.diff += int((d > 0).sum())

    def share(self):
        return self.diff / max(self.n, 1)


def test_patch_shuffle_and_feather_alpha(media):
    _, frames = media
    r1, r2 = _pair(0)
    for f in frames:
        np.testing.assert_array_equal(J._patch_shuffle(f.copy(), r1), P._patch_shuffle(f.copy(), r2))
        _same_state(r1, r2)
    for h, w, m in ((40, 60, 3), (7, 5, 2), (90, 90, 1)):
        np.testing.assert_array_equal(J._feather_alpha(h, w, m), P._feather_alpha(h, w, m))


def test_intact_crop_and_background(media):
    _, frames = media
    px = Pixels()
    r1, r2 = _pair(1)
    vetoed = 0
    for _ in range(40):
        a, b = J._intact_crop(r1, frames), P._intact_crop(r2, frames)
        _same_state(r1, r2)
        assert (a is None) == (b is None)
        vetoed += a is None
        if a is not None:
            px.check(a, b)
    assert 0 < vetoed < 40   # the skin veto goes both ways on these frames
    assert P._intact_crop(r2, []) is None
    for fr in (frames, []):
        r1, r2 = _pair(2)
        for _ in range(40):
            px.check(J._background(r1, fr), P._background(r2, fr))
            _same_state(r1, r2)
    assert px.share() <= DIFF_SHARE


def test_paste_and_composite(media):
    faces, frames = media
    px = Pixels()
    r1, r2 = _pair(3)
    for k in range(60):
        c1 = np.full((P.INPUT, P.INPUT, 3), 90, np.uint8)
        c2 = c1.copy()
        assert J._paste(c1, faces[k % len(faces)], r1) == P._paste(c2, faces[k % len(faces)], r2)
        _same_state(r1, r2)
        px.check(c1, c2)
    r1, r2 = _pair(4)
    for _ in range(40):
        (a, ba), (b, bb) = J.composite_sample(faces, frames, r1), P.composite_sample(faces, frames, r2)
        _same_state(r1, r2)
        assert ba == bb
        px.check(a, b)
    assert px.share() <= DIFF_SHARE


def test_weak_labels_and_skin_detector(media):
    _, frames = media
    px = Pixels()
    r1, r2 = _pair(5)
    labelled = 0
    for _ in range(20):
        a, b = J.weak_label_sample(frames, r1), P.weak_label_sample(frames, r2)
        _same_state(r1, r2)
        assert (a is None) == (b is None)
        if a is not None:
            labelled += 1
            assert a[1] == b[1]
            px.check(a[0], b[0])
    assert 0 < labelled < 20
    # the detector alone: seeded frames, noise, and two equal-area blobs
    # (one starting a row later in the same row pair, left of the other)
    rng = np.random.default_rng(6)
    extra = [rng.integers(0, 256, (120, 160, 3), np.uint8)]
    two = np.full((100, 140, 3), (40, 60, 150), np.uint8)
    two[21:41, 30:50] = (205, 150, 125)
    two[20:40, 80:100] = (205, 150, 125)
    extra.append(two)
    for f in list(frames) + extra:
        want = JaxSkinDetector().detect(f[None])
        assert SkinDetector().detect(f[None]) == want
    # the left blob wins the tie (cv2's 2x2-block order), though the right
    # one's first pixel comes first in raster order
    assert SkinDetector().detect(two[None]) == [[(18, 52, 43, 27)]]
    assert px.share() <= DIFF_SHARE


def test_synth_dataset(media):
    """synth_dataset(..., n=64, seed=0): the generator's own Generator state
    after every sample, the boxes, the images."""
    faces, frames = media
    px = Pixels()
    g1, g2 = J.synth_dataset(faces, frames, 64, seed=0), P.synth_dataset(faces, frames, 64, seed=0)
    n = 0
    for (a, ba), (b, bb) in zip(g1, g2):
        _same_state(g1.gi_frame.f_locals["rng"], g2.gi_frame.f_locals["rng"])
        assert ba == bb
        px.check(a, b)
        n += 1
    assert n == 64 and next(g2, None) is None
    assert px.diff > 0 and px.share() <= DIFF_SHARE


def test_loaders(tmp_path, media):
    faces, _ = media
    for i, face in enumerate(faces[:5]):
        d = tmp_path / ("train", "valid", "test")[i % 3] / ("fake", "real")[i % 2]
        d.mkdir(parents=True, exist_ok=True)
        assert cv2.imwrite(str(d / f"{i}.png"), face[..., ::-1])
    for splits in (("train", "valid"), ("test",)):
        want = J.load_face_crops(str(tmp_path), splits)
        got = P.load_face_crops(str(tmp_path), splits)
        assert len(got) == len(want) > 0
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
    vids = tmp_path / "videos"
    vids.mkdir()
    rng = np.random.default_rng(7)
    for v in range(2):
        w = cv2.VideoWriter(str(vids / f"v{v}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10, (96, 64))
        for _ in range(12):
            w.write(rng.integers(0, 256, (64, 96, 3), np.uint8))
        w.release()
    (vids / "notes.txt").write_text("not a video")
    want = J.load_video_frames(str(vids), per_video=4)
    got = P.load_video_frames(str(vids), per_video=4)
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert os.listdir(vids)
