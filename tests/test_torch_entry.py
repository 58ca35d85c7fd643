"""The port's remaining entry points against the repository's on the CPU:
`Predictor.predict_videos_stream` against the JAX engine's (deterministic
VAE, float32: y equal, y_val within 1e-5) and against the port's own
per-batch path (equal, ragged batches too); `python -m
genconvit_tpu_torch.prediction_v2` against the root `prediction_v2.py` on
the same videos (the same result JSON keys, labels and metrics block,
verdicts within 2e-3: the face crops may differ from cv2's by 1 LSB);
evaluate's scoring function against a JAX transcription of
`evaluate.py:53-71` with `genconvit_apply(..., sample=False)` (within
1e-5), and its report against sklearn's. Both Predictors load the same
`.gcv` weights (the small backbone of test_torch_util, 64 px)."""

import functools
import json
import os
import sys

import numpy as np
import pytest

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.infer import engine as jax_engine

from genconvit_tpu_torch import evaluate, prediction_v2
from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.infer import engine
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_torch_drivers import _write_video
from tests.test_torch_util import (IMG, small_backbone_registered, write_gcv_weights,
                                   write_small_config)

FRAMES = 4
SAME_TOL = 1e-5
YVAL_TOL = 2e-3
LABEL_MARGIN = 1e-2
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry")
    write_gcv_weights(root / "weights", seed=2)
    vdir = root / "videos"
    vdir.mkdir()
    for i, name in enumerate(("fake_a.mp4", "real_b.mp4", "FAKE_c.mp4", "d.mp4", "e_fake.mp4")):
        _write_video(str(vdir / name), seed=30 + i)
    (vdir / "broken_fake.mp4").write_bytes(b"not a video at all" * 8)
    with small_backbone_registered() as backbone:
        yield {"root": root, "weights": str(root / "weights"), "videos": str(vdir),
               "backbone": backbone, "config": write_small_config(root / "config.yaml")}


def _port(corpus, net="genconvit"):
    cfg = Config(model=ModelConfig(backbone=corpus["backbone"]), img_size=IMG,
                 weight_dir=corpus["weights"])
    return engine.Predictor(cfg, net=net, device="cpu", face_backend="center",
                            deterministic_vae=True, kernel_plan=KernelPlan())


def _jax(corpus, net="genconvit"):
    cfg = JaxConfig()
    cfg.img_size = IMG
    cfg.model.latent_dims = cfg.derived_latent_dims()
    cfg.weight_dir = corpus["weights"]
    return jax_engine.Predictor(cfg, net=net, face_backend="center", deterministic_vae=True)


@pytest.fixture(scope="module")
def pair(corpus):
    return _port(corpus), _jax(corpus)


def _batches(seed, shapes):
    """Seeded ([V,F,S,S,3] uint8, [V,F]) batches; every video keeps at
    least one frame, some lose the rest."""
    rng = np.random.default_rng(seed)
    out = []
    for v in shapes:
        faces = rng.integers(0, 256, (v, FRAMES, IMG, IMG, 3), np.uint8)
        mask = (rng.random((v, FRAMES)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
        out.append((faces, mask))
    return out


def test_predict_videos_stream_matches_jax(pair):
    pp, jp = pair
    batches = _batches(0, (2, 2, 2))
    got = pp.predict_videos_stream(iter(batches))
    want = jp.predict_videos_stream(iter(batches))
    assert len(got) == len(want) == 3
    for (gy, gv), (wy, wv) in zip(got, want):
        assert gy.dtype == np.int64 and gv.dtype == np.float32
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=SAME_TOL)


def test_predict_videos_stream_equals_the_batched_path(pair):
    """Ragged batches (the JAX stream stacks, so needs one V) and a
    generator; each equals predict_videos_batched on its batch, and an
    empty stream gives nothing."""
    pp = pair[0]
    batches = _batches(1, (3, 1, 2))
    got = pp.predict_videos_stream(b for b in batches)
    for (gy, gv), (faces, mask) in zip(got, batches, strict=True):
        wy, wv = pp.predict_videos_batched(faces, mask)
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gv, wv)
    assert pp.predict_videos_stream([]) == []


def _deterministic(monkeypatch, module, **extra):
    """The module's Predictor with deterministic_vae=True: the two packages
    draw the VAE's eps from different generators."""
    monkeypatch.setattr(module, "Predictor", functools.partial(module.Predictor,
                                                               deterministic_vae=True, **extra))


def test_prediction_v2_matches_root_cli(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("GENCONVIT_CONFIG", corpus["config"])
    common = ["--p", corpus["videos"], "--f", str(FRAMES), "--face-backend", "center",
              "--weights-dir", corpus["weights"], "--workers", "2", "--arch-type", "v2"]
    _deterministic(monkeypatch, prediction_v2, kernel_plan=KernelPlan())
    out_port = prediction_v2.main(common + ["--result-dir", str(tmp_path / "port"),
                                            "--device", "cpu"])
    import prediction_v2 as root_cli

    _deterministic(monkeypatch, root_cli)
    monkeypatch.setattr(sys, "argv", ["prediction_v2.py"] + common
                        + ["--result-dir", str(tmp_path / "jax")])
    root_cli.main()
    (out_jax,) = [os.path.join(tmp_path / "jax", f) for f in os.listdir(tmp_path / "jax")]
    stem = [os.path.basename(p).rsplit("_", 6)[0] for p in (out_port, out_jax)]
    assert stem == ["prediction_other_genconvit_v2"] * 2
    with open(out_port) as f:
        got = json.load(f)
    with open(out_jax) as f:
        want = json.load(f)
    assert set(got) == set(want) == {"video", "metrics", "metadata"}
    assert set(got["video"]) == set(want["video"])
    assert set(got["metadata"]) == set(want["metadata"])
    assert got["metadata"]["framework"] == "genconvit_tpu_torch"
    for k in ("dataset", "network", "num_frames", "arch_type", "model_size"):
        assert got["metadata"][k] == want["metadata"][k], k
    assert set(got["metadata"]["stage_timers"]) >= {"decode", "detect", "crop",
                                                    "device_forward"}
    names = got["video"]["name"]
    assert names == want["video"]["name"] and len(names) == 6
    assert got["video"]["correct_label"] == want["video"]["correct_label"] == [
        "FAKE" if "fake" in n.lower() else "REAL" for n in names]
    decisive = 0
    for i, name in enumerate(names):
        assert abs(got["video"]["pred"][i] - want["video"]["pred"][i]) <= YVAL_TOL, name
        if abs(want["video"]["pred"][i] - 0.5) > LABEL_MARGIN:
            decisive += 1
            assert got["video"]["pred_label"][i] == want["video"]["pred_label"][i], name
    assert decisive >= 3
    assert got["video"]["pred_label"] == want["video"]["pred_label"]
    assert got["metrics"] == want["metrics"]
    assert set(got["metrics"]) == {"accuracy", "precision", "recall", "f1"}


def test_prediction_v2_refuses_yuv420_and_needs_the_gpu(corpus, monkeypatch):
    monkeypatch.setenv("GENCONVIT_CONFIG", corpus["config"])
    with pytest.raises(NotImplementedError, match="yuv420"):
        prediction_v2.main(["--p", corpus["videos"], "--transfer-format", "yuv420"])
    with pytest.raises(SystemExit):
        prediction_v2.main(["--p", os.path.join(corpus["videos"], "missing")])
    monkeypatch.setattr(engine.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prediction_v2.main(["--p", corpus["videos"], "--weights-dir", corpus["weights"]])


def _jax_scores(jp, images, net):
    """evaluate.py:53-63 of the repository, transcribed, with the VAE's
    mean in place of its sample."""
    import jax
    import jax.numpy as jnp

    from genconvit_tpu.data.preprocess import normalize_batch
    from genconvit_tpu.models.genconvit import genconvit_apply

    @jax.jit
    def forward(params, images_u8, rng):
        x = normalize_batch(images_u8, jnp.float32)
        logits, _ = genconvit_apply(params, x, net=net, rng=rng, sample=False)
        if net == "genconvit":  # average the two branch blocks
            n = x.shape[0]
            logits = (logits[:n] + logits[n:]) / 2
        return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

    return np.asarray(forward(jp.params, jnp.asarray(images), jax.random.PRNGKey(0)))[:, 1]


@pytest.mark.parametrize("net", ["ed", "vae", "genconvit"])
def test_evaluate_scores_match_the_jax_transcription(corpus, pair, net):
    pp = pair[0] if net == "genconvit" else _port(corpus, net)
    jp = pair[1]   # its params hold both branches; genconvit_apply picks by net
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (10, IMG, IMG, 3), np.uint8)
    labels = rng.integers(0, 2, 10)
    batches = [(images[:4], labels[:4]), (images[4:], labels[4:])]
    y_true, y_prob = evaluate.score_batches(pp, batches)
    np.testing.assert_array_equal(y_true, labels)
    assert y_prob.dtype == np.float64 and y_prob.shape == (10,)
    np.testing.assert_allclose(y_prob, _jax_scores(jp, images, net), rtol=0, atol=PROB_TOL)
    assert np.ptp(y_prob) > 1e-3   # the images are told apart


def test_evaluate_main_reports_as_sklearn(corpus, tmp_path, monkeypatch, capsys):
    """evaluate.main over a tmp ImageFolder on the CPU: the classification
    report, confusion matrix and ROC-AUC equal sklearn's on the scores it
    returns, and the figure is written; without CUDA it raises."""
    import cv2
    from sklearn.metrics import classification_report, confusion_matrix, roc_auc_score

    monkeypatch.setenv("GENCONVIT_CONFIG", corpus["config"])
    rng = np.random.default_rng(6)
    for cls in ("fake", "real"):
        d = tmp_path / "data" / "test" / cls
        d.mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(d / f"{i}.png"), rng.integers(0, 256, (IMG, IMG + 16, 3), np.uint8))
    out = evaluate.main(["--data", str(tmp_path / "data"), "--net", "ed", "--weights-dir",
                         corpus["weights"], "--batch-size", "4", "--out-dir",
                         str(tmp_path / "eval"), "--device", "cpu"])
    printed = capsys.readouterr().out
    y_true, y_prob = out["y_true"], out["y_prob"]
    np.testing.assert_array_equal(y_true, [0] * 5 + [1] * 5)
    y_pred = (y_prob >= 0.5).astype(int)
    want = classification_report(y_true, y_pred, labels=[0, 1], target_names=["fake", "real"],
                                 zero_division=0)
    if np.any(y_true == y_pred):   # else sklearn 1.9 prints its supports as floats
        assert out["report"] == want
    assert out["report"] in printed
    np.testing.assert_array_equal(out["confusion"], confusion_matrix(y_true, y_pred,
                                                                     labels=[0, 1]))
    assert abs(out["roc_auc"] - roc_auc_score(y_true, y_prob)) <= 1e-12
    assert f"ROC-AUC: {out['roc_auc']:.4f}" in printed
    assert os.path.getsize(out["figure"]) > 1000
    monkeypatch.setattr(engine.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--data", str(tmp_path / "data"), "--weights-dir", corpus["weights"]])
