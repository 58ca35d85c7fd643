"""The detector's training tools (genconvit_tpu_torch/tools/train_facedet.py,
train_facedet_synth.py) on the CPU: train_facedet_synth end to end over a
temporary reference directory of seeded faces (cv2.imwrite) and two short
videos, the `.gcv` it writes read by both packages' loaders, its evaluate
against the JAX tool's on the same weights (mean IoU within 1e-3, detection
rate within 1/n), its default output outside genconvit_tpu/, the JAX tool's
message on an empty --ref, and train_facedet on a two-image --ann file."""

import hashlib
import importlib.util
import json
import pathlib

import cv2
import jax
import numpy as np
import pytest
import torch

from genconvit_tpu.core import checkpoint as jax_ckpt

from genconvit_tpu_torch.core import checkpoint as port_ckpt
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.facedet import FaceDet
from genconvit_tpu_torch.tools import train_facedet, train_facedet_synth

from tests.test_torch_util import seeded_faces, seeded_frames

ROOT = pathlib.Path(__file__).resolve().parents[1]
ASSET = ROOT / "genconvit_tpu" / "assets" / "facedet.gcv"
IOU_TOL = 1e-3
EVAL_N = 64


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: training and evaluate's many small ops slow down
    when the test workers' thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest() if path.exists() else None


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = tmp_path_factory.mktemp("reference")
    for i, face in enumerate(seeded_faces(11, 9)):
        d = ref / "sample_train_data" / ("train", "valid", "test")[i % 3] / ("fake", "real")[i % 2]
        d.mkdir(parents=True, exist_ok=True)
        assert cv2.imwrite(str(d / f"{i}.png"), face[..., ::-1])
    vids = ref / "sample_prediction_data"
    vids.mkdir()
    for v, frame in enumerate(seeded_frames(12, 2)):
        h, w = frame.shape[:2]
        wr = cv2.VideoWriter(str(vids / f"v{v}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
        for _ in range(8):
            wr.write(frame[..., ::-1])
        wr.release()
    return ref


def _read_both(path):
    jp, pp = jax_ckpt.load_checkpoint(str(path)), port_ckpt.load_checkpoint(str(path))
    assert jp["extra"]["kind"] == pp["extra"]["kind"] == "facedet"
    model = FaceDet()
    model.load_state_dict(state_dict_from_jax(pp["params"], "facedet"), strict=True)
    jax_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp["params"]), "facedet")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(jax_sd[k], v, rtol=0, atol=0)
    return jp, pp, model


def test_train_facedet_synth_end_to_end(reference, tmp_path):
    asset = _sha(ASSET)
    out = tmp_path / "det.gcv"
    train_facedet_synth.main(["--ref", str(reference), "--out", str(out), "--n", "64",
                              "--epochs", "1", "--batch", "16", "--device", "cpu"])
    jp, pp, model = _read_both(out)
    assert 0.0 <= pp["extra"]["heldout_mean_iou"] <= 1.0
    assert jp["extra"]["heldout_det_rate_at_05"] == pp["extra"]["heldout_det_rate_at_05"]
    assert _sha(ASSET) == asset

    # evaluate against the JAX tool's on the same weights
    faces = train_facedet_synth.load_face_crops(str(reference / "sample_train_data"), ("test",))
    frames = train_facedet_synth.load_video_frames(str(reference / "sample_prediction_data"))
    assert faces and frames
    jax_eval = _jax_tool("train_facedet_synth").evaluate
    # the tool's weights (one epoch: few detections pass the threshold) and
    # the committed detector's (read only)
    committed = FaceDet()
    committed.load_state_dict(
        state_dict_from_jax(port_ckpt.load_checkpoint(str(ASSET))["params"], "facedet"))
    for params, m in ((jp["params"], model),
                      (jax_ckpt.load_checkpoint(str(ASSET))["params"], committed)):
        want = jax_eval(params, faces, frames, n=EVAL_N)
        got = train_facedet_synth.evaluate(m, faces, frames, n=EVAL_N)
        assert abs(got[0] - want[0]) <= IOU_TOL
        assert abs(got[1] - want[1]) <= 1.0 / EVAL_N
    assert got[0] > 0.3 and got[1] > 0.2   # it finds these faces (0.5655 / 0.7344)


def test_defaults_and_refusals(tmp_path):
    args = train_facedet_synth.parser().parse_args(["--ref", str(tmp_path)])
    out = (ROOT / args.out).resolve()
    assert (ROOT / "genconvit_tpu") not in out.parents
    assert args.device == "cuda"
    with pytest.raises(SystemExit, match="no face crops found under --ref"):
        train_facedet_synth.main(["--ref", str(tmp_path), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            train_facedet_synth.main(["--ref", str(tmp_path)])


def test_train_facedet_on_an_annotation_file(tmp_path):
    faces = seeded_faces(13, 2)
    ann = {}
    for i, face in enumerate(faces):
        assert cv2.imwrite(str(tmp_path / f"f{i}.png"), face[..., ::-1])
        ann[f"f{i}.png"] = [[0.5, 0.5, 0.8, 0.7]]
    ann["missing.png"] = [[0.5, 0.5, 0.5, 0.5]]
    (tmp_path / "boxes.json").write_text(json.dumps(ann))
    imgs = list(train_facedet.dataset(ann, str(tmp_path), 128))
    assert len(imgs) == 2 and imgs[0][0].shape == (128, 128, 3)
    np.testing.assert_array_equal(
        imgs[1][0], cv2.resize(faces[1], (128, 128), interpolation=cv2.INTER_AREA))
    out = tmp_path / "w" / "facedet.gcv"
    train_facedet.main(["--ann", str(tmp_path / "boxes.json"), "--root", str(tmp_path),
                        "--out", str(out), "--epochs", "1", "--batch", "2", "--device", "cpu"])
    _read_both(out)
