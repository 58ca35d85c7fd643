"""The face detector of the port against the JAX package's on the CPU, with
the committed weights (genconvit_tpu/assets/facedet.gcv): FaceDet + decode
against facedet_apply within 1e-4 (float32), nms exactly on the same inputs,
detect_batch, the device detector's window pyramid and merge exactly, its
window crops within 1 LSB of cv2, and detect_many against JaxFaceDetector's
at 1920x1080, 640x360 and 100x80 (width x height; and 360x640) (the same
box count per frame, corners within 2 px: the windows may differ from
cv2's by 1 LSB)."""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core.checkpoint import load_checkpoint as jax_load
from genconvit_tpu.data import faces as jax_faces
from genconvit_tpu.models import facedet as jax_facedet

from genconvit_tpu_torch.core.checkpoint import load_checkpoint
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.data import faces
from genconvit_tpu_torch.models import facedet

ASSET = os.path.join(os.path.dirname(__file__), "..", "genconvit_tpu", "assets", "facedet.gcv")
FWD_TOL = 1e-4
BOX_PX = 2


@pytest.fixture(scope="module")
def nets():
    model = facedet.FaceDet()
    model.load_state_dict(state_dict_from_jax(load_checkpoint(ASSET)["params"], "facedet"),
                          strict=True)
    return model.eval(), jax_load(ASSET)["params"]


def _windows(seed, n):
    """Seeded 128 x 128 windows: noise, and smooth images with bright
    ellipses (on which the detector scores higher)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (n, 128, 128, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:128, :128]
    for i in range(0, n, 2):
        img = cv2.resize(rng.integers(0, 256, (8, 8, 3), np.uint8), (128, 128))
        cy, cx, ry, rx = rng.uniform(30, 98), rng.uniform(30, 98), *rng.uniform(12, 40, 2)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img[inside] = rng.integers(150, 230, 3)
        out[i] = img
    return out


def test_anchor_centers_equal():
    np.testing.assert_array_equal(facedet.anchor_centers(), jax_facedet.anchor_centers())


def test_forward_and_decode_match_facedet_apply(nets):
    model, params = nets
    x = _windows(0, 24).astype(np.float32) / 127.5 - 1.0
    with torch.no_grad():
        s, b = facedet.decode(model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    js, jb = jax_facedet.facedet_apply(params, jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("flag", [True, False])
def test_forward_runs_without_tf32_and_restores_the_flag(nets, flag, monkeypatch):
    """cuDNN's TF32 flag is process-wide and on by default: the detector's
    forward turns it off for its own convolutions and puts it back."""
    model, _ = nets
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
    inside = []
    hook = model.stem.register_forward_hook(
        lambda *_: inside.append(torch.backends.cudnn.allow_tf32))
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, 128, 128))
    finally:
        hook.remove()
    assert inside == [False]
    assert torch.backends.cudnn.allow_tf32 is flag


@pytest.mark.parametrize("score_thresh", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("max_out", [1, 4])
def test_nms_equals_jax(score_thresh, max_out):
    """The same (probabilities, boxes) into both: equal outputs, ties and
    -inf slots included."""
    rng = np.random.default_rng(1)
    n, a = 12, 896
    probs = rng.random((n, a)).astype(np.float32) ** 4
    probs[0, :40] = 0.25                       # ties across the top-32 cut
    probs[1] = 0.0                             # nothing above any threshold
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (n, a, 2)),
                            rng.uniform(0.05, 0.5, (n, a, 2))], -1).astype(np.float32)
    boxes[2, :, :2] = 0.5                      # heavy overlaps
    want_s, want_b = jax.vmap(lambda s, b: jax_facedet.nms(
        s, b, max_out=max_out, score_thresh=score_thresh))(jnp.asarray(probs),
                                                           jnp.asarray(boxes))
    got_s, got_b = facedet.nms(torch.from_numpy(probs), torch.from_numpy(boxes),
                               max_out=max_out, score_thresh=score_thresh)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_detect_batch_matches_jax(nets):
    model, params = nets
    x = _windows(2, 32)
    with torch.no_grad():
        s, b = facedet.detect_batch(model, torch.from_numpy(x), score_thresh=0.05)
    js, jb = jax_facedet.detect_batch(params, jnp.asarray(x), score_thresh=0.05)
    js, jb = np.asarray(js), np.asarray(jb)
    valid = np.isfinite(js)
    assert valid.sum() >= 8   # not vacuous
    np.testing.assert_array_equal(np.isfinite(s.numpy()), valid)
    np.testing.assert_allclose(s.numpy()[valid], js[valid], rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=FWD_TOL)


@pytest.fixture(scope="module")
def detectors():
    jd = jax_faces.JaxFaceDetector(ASSET, score_thresh=0.05)
    pd = faces.DeviceFaceDetector(ASSET, score_thresh=0.05, device="cpu")
    return jd, pd


@pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280), (640, 360), (360, 640),
                                (256, 256), (257, 300), (100, 80), (20, 10)])
def test_windows_equal_jax(detectors, hw):
    jd, pd = detectors
    assert pd._windows(*hw) == jd._windows(*hw)


def test_merge_equals_jax(detectors):
    jd, pd = detectors
    rng = np.random.default_rng(3)
    for trial in range(30):
        n = int(rng.integers(0, 25))
        t = rng.integers(0, 400, n)
        lf = rng.integers(0, 400, n)
        h = rng.integers(5, 200, n)
        w = rng.integers(5, 200, n)
        cands = [(float(s), (int(a), int(b + c), int(a + d), int(b)))
                 for s, a, b, c, d in zip(rng.random(n), t, lf, w, h)]
        for fuse in (True, False):
            jd.fuse = pd.fuse = fuse
            assert pd._merge(list(cands)) == jd._merge(list(cands))
    jd.fuse = pd.fuse = True


@pytest.mark.parametrize("hw", [(1080, 1920), (360, 640), (80, 100), (640, 360), (256, 256)])
def test_window_crops_within_one_lsb_of_cv2(detectors, hw):
    _, pd = detectors
    frames = _frames(4, 2, hw)
    wins = pd._windows(*hw)
    crops = pd.window_crops(torch.from_numpy(frames), wins).numpy().reshape(
        2, len(wins), 128, 128, 3).astype(int)
    for fi in range(2):
        for wi, (top, left, side) in enumerate(wins):
            src = frames[fi] if side < 0 else frames[fi, top: top + side, left: left + side]
            ref = cv2.resize(src, (128, 128), interpolation=cv2.INTER_AREA)
            assert np.abs(crops[fi, wi] - ref).max() <= 1, (hw, wins[wi])


def _frames(seed, n, hw):
    """Smooth frames with bright ellipses of several sizes."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        img = cv2.resize(rng.integers(0, 256, (9, 16, 3), np.uint8), (w, h))
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            r = rng.uniform(0.08, 0.3) * min(h, w)
            img[((yy - cy) / r) ** 2 + ((xx - cx) / (0.8 * r)) ** 2 < 1] = rng.integers(140, 230, 3)
        out[i] = img
    return out


@pytest.mark.parametrize("hw", [(1080, 1920), (360, 640), (80, 100), (640, 360)])
def test_detect_many_matches_jax(detectors, hw):
    jd, pd = detectors
    frames_list = [_frames(5, 2, hw), _frames(6, 1, hw)]
    want = jd.detect_many(frames_list)
    got = pd.detect_many(frames_list)
    n_boxes = 0
    for gv, wv in zip(got, want):
        assert len(gv) == len(wv)
        for gf, wf in zip(gv, wv):
            assert len(gf) == len(wf), (hw, gf, wf)
            n_boxes += len(wf)
            for gb, wb in zip(gf, wf):
                assert max(abs(a - b) for a, b in zip(gb, wb)) <= BOX_PX, (hw, gb, wb)
    assert n_boxes >= 3   # not vacuous
