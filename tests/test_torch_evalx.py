"""The port's offline evaluation against the JAX package's and sklearn's on
the CPU: `infer/result.compute_metrics`, `evalx/metrics` (numpy only)
against the JAX `evalx/metrics.py` (which calls sklearn) and sklearn's
roc_curve, classification_report and confusion_matrix, on seeded results
with tied scores, one class only and empty files; the plots and the two
analysis scripts; `data/folder` and `data/augment` against the JAX ones on
a tmp ImageFolder. Scores are compared exactly (the same float64
arithmetic); ROC-AUC within 1e-12 (the trapezoid sums in another order)."""

import json
import os
import sys
import warnings

import numpy as np
import pytest

from genconvit_tpu.data import augment as jax_augment
from genconvit_tpu.data import folder as jax_folder
from genconvit_tpu.evalx import metrics as jax_metrics
from genconvit_tpu.infer import result as jax_result

from genconvit_tpu_torch.data import augment, folder
from genconvit_tpu_torch.evalx import metrics, plots
from genconvit_tpu_torch.infer import result

AUC_TOL = 1e-12


@pytest.fixture(autouse=True)
def _quiet_sklearn():
    with warnings.catch_warnings():   # sklearn's UndefinedMetricWarning on one class
        warnings.simplefilter("ignore")
        yield


def _label_vectors(seed):
    """Seeded (y_true, y_pred): mixed, every one-class combination, one sample."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    mixed = (rng.integers(0, 2, n).tolist(), rng.integers(0, 2, n).tolist())
    return [mixed, ([0] * n, [0] * n), ([1] * n, [1] * n), ([0] * n, [1] * n),
            ([1] * n, [0] * n), ([0] * n, mixed[1]), (mixed[0], [1] * n), ([1], [1])]


@pytest.mark.parametrize("seed", range(4))
def test_compute_metrics_matches_sklearn(seed):
    from sklearn.metrics import accuracy_score, f1_score, precision_score, recall_score

    for y_true, y_pred in _label_vectors(seed):
        got = result.compute_metrics(y_true, y_pred)
        assert got == jax_result.compute_metrics(y_true, y_pred)
        assert got == {"accuracy": accuracy_score(y_true, y_pred),
                       "precision": precision_score(y_true, y_pred, zero_division=0),
                       "recall": recall_score(y_true, y_pred, zero_division=0),
                       "f1": f1_score(y_true, y_pred, zero_division=0)}


def test_compute_metrics_empty_and_without_sklearn(monkeypatch):
    assert result.compute_metrics([], []) == jax_result.compute_metrics([], []) == {}
    monkeypatch.setitem(sys.modules, "sklearn", None)   # an import of it would raise
    monkeypatch.setitem(sys.modules, "sklearn.metrics", None)
    assert result.compute_metrics([1, 0, 1], [1, 1, 1])["precision"] == pytest.approx(2 / 3)
    assert result.attach_metrics({}, [0, 1], [0, 1])["metrics"]["f1"] == 1.0


def _result(rng, n, kind="mixed", decimals=2):
    """A result JSON: scores rounded to `decimals` so that many tie;
    'one' has only FAKE ground truth, 'empty' no video; an 'unknown' row
    that result_vectors must exclude."""
    labels = {"mixed": ["FAKE" if rng.random() < 0.5 else "REAL" for _ in range(n)],
              "one": ["FAKE"] * n, "empty": []}[kind]
    preds = [round(float(np.clip(rng.normal(0.7 if l == "FAKE" else 0.3, 0.25), 0, 1)),
                   decimals) for l in labels]
    video = {"name": [f"v{i}.mp4" for i in range(len(labels))], "pred": preds,
             "klass": ["x"] * len(labels),
             "pred_label": ["FAKE" if p >= 0.5 else "REAL" for p in preds],
             "correct_label": labels}
    if kind == "mixed":
        for k, v in (("name", "u.mp4"), ("pred", 0.9), ("klass", "x"), ("pred_label", "FAKE"),
                     ("correct_label", "unknown")):
            video[k].append(v)
    return {"video": video}


def _same_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "roc_auc":
            assert abs(got[k] - v) <= AUC_TOL, (k, got[k], v)
        elif isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("kind,n,decimals", [("mixed", 40, 1), ("mixed", 17, 2), ("mixed", 3, 0),
                                             ("one", 12, 2), ("empty", 0, 2)])
def test_result_metrics_and_roc_points_match_jax(kind, n, decimals):
    rng = np.random.default_rng(n + decimals)
    res = _result(rng, n, kind, decimals)
    _same_metrics(metrics.result_metrics(res), jax_metrics.result_metrics(res))
    for a, b in zip(metrics.result_vectors(res), jax_metrics.result_vectors(res)):
        np.testing.assert_array_equal(a, b)
    if kind == "empty":
        for roc in (metrics.roc_points, jax_metrics.roc_points):
            with pytest.raises(ValueError):
                roc(res)
        return
    fpr, tpr, auc = metrics.roc_points(res)
    jfpr, jtpr, jauc = jax_metrics.roc_points(res)
    np.testing.assert_array_equal(fpr, jfpr)
    np.testing.assert_array_equal(tpr, jtpr)
    assert (np.isnan(auc) and np.isnan(jauc)) if kind == "one" else abs(auc - jauc) <= AUC_TOL


def test_summarize_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i, kind in enumerate(("mixed", "one", "empty")):
        p = tmp_path / f"r{i}.json"
        p.write_text(json.dumps(_result(rng, 21, kind)))
        paths.append(str(p))
    got, want = metrics.summarize(paths), jax_metrics.summarize(paths)
    assert list(got) == list(want) == paths
    for p in paths:
        _same_metrics(got[p], want[p])


@pytest.mark.parametrize("seed", range(6))
def test_roc_curve_and_auc_match_sklearn_with_ties(seed):
    from sklearn.metrics import roc_auc_score, roc_curve

    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    y = rng.integers(0, 2, n)
    if seed == 5:
        y[:] = 0   # one class: fpr or tpr NaN, the AUC NaN
    scores = np.round(rng.random(n), seed % 3)   # 0-2 decimals: many ties
    for got, want in zip(metrics.roc_curve(y, scores), roc_curve(y, scores)):
        np.testing.assert_array_equal(got, want)
    got, want = metrics.roc_auc_score(y, scores), roc_auc_score(y, scores)
    assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= AUC_TOL


@pytest.mark.parametrize("k,labels", [(2, None), (3, None), (2, [0, 1]), (3, [0, 1])])
def test_classification_report_and_confusion_matrix_match_sklearn(k, labels):
    """The text byte for byte; sklearn 1.9 prints its supports as floats
    when no sample is right (an internal dtype switch), so those draws are
    compared by their numbers."""
    from sklearn.metrics import (classification_report, confusion_matrix,
                                 precision_recall_fscore_support)

    rng = np.random.default_rng(k * 10 + (labels is None))
    compared = 0
    for _ in range(40):
        n = int(rng.integers(1, 30))
        y_true, y_pred = rng.integers(0, k, n), rng.integers(0, k, n)
        names = [f"class_{c}" for c in (labels if labels is not None else range(k))]
        kw = {} if labels is None else {"labels": labels}
        try:
            want = classification_report(y_true, y_pred, target_names=names, zero_division=0, **kw)
        except ValueError:   # fewer classes present than names, no labels given
            with pytest.raises(ValueError):
                metrics.classification_report(y_true, y_pred, target_names=names, **kw)
            continue
        got = metrics.classification_report(y_true, y_pred, target_names=names, **kw)
        if np.any(y_true == y_pred):
            assert got == want
            compared += 1
        lab = labels if labels is not None else np.unique(np.r_[y_true, y_pred])
        for a, b in zip(metrics.precision_recall_f1(y_true, y_pred, lab),
                        precision_recall_fscore_support(y_true, y_pred, labels=lab,
                                                        zero_division=0)):
            np.testing.assert_array_equal(a, b)
        if labels is None or np.isin(y_true, labels).any():   # else sklearn refuses
            np.testing.assert_array_equal(metrics.confusion_matrix(y_true, y_pred, labels),
                                          confusion_matrix(y_true, y_pred, labels=labels))
    assert compared >= 10


def _write_fixture(tmp_path, name, n=20):
    rng = np.random.default_rng(sum(map(ord, name)))
    res = _result(rng, n)
    p = str(tmp_path / f"{name}.json")
    with open(p, "w") as f:
        json.dump(res, f)
    return p


def test_plots_write_their_files(tmp_path):
    a, b = _write_fixture(tmp_path, "run_a"), _write_fixture(tmp_path, "run_b")
    roc = plots.plot_roc([a, b], str(tmp_path / "roc.png"))
    assert os.path.getsize(roc) > 1000
    artifacts = plots.plot_metrics_comparison([a, b], str(tmp_path / "cmp"))
    for key in ("bar_chart", "confusion", "csv", "report"):
        assert os.path.isfile(artifacts[key])
    from genconvit_tpu.evalx.plots import plot_metrics_comparison as jax_comparison

    want = jax_comparison([a, b], str(tmp_path / "cmp_jax"))
    for key in ("csv", "report"):
        with open(artifacts[key]) as f, open(want[key]) as g:
            assert f.read() == g.read(), key
    cm = plots.plot_confusion_matrix(np.array([[3, 1], [0, 4]]), ["fake", "real"],
                                     str(tmp_path / "cm.png"))
    assert os.path.getsize(cm) > 1000


def test_analysis_scripts_print_what_the_root_scripts_print(tmp_path, monkeypatch, capsys):
    from genconvit_tpu_torch import plot_comparison as port_cmp
    from genconvit_tpu_torch import result_all as port_all

    (tmp_path / "result").mkdir()
    paths = [_write_fixture(tmp_path / "result", n) for n in ("data_a", "prediction_b")]
    monkeypatch.chdir(tmp_path)
    import plot_comparison as root_cmp
    import result_all as root_all

    port_all.main([])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["result_all.py"])
    root_all.main()
    assert got == capsys.readouterr().out
    assert "roc_auc" in got and os.path.isfile(tmp_path / "result" / "roc_all.png")
    # a file without ground truth: skipped by the metrics, then the ROC plot
    # stops on it, in both scripts
    (tmp_path / "result" / "data_bad.json").write_text(json.dumps({"video": {}}))
    with pytest.raises(KeyError):
        port_all.main([])
    got = capsys.readouterr().out
    with pytest.raises(KeyError):
        root_all.main()
    assert got == capsys.readouterr().out and "data_bad.json: skipped" in got
    artifacts = port_cmp.main(paths + ["--out-dir", str(tmp_path / "cmp")])
    assert sorted(artifacts) == ["bar_chart", "confusion", "csv", "report"]
    monkeypatch.setattr(sys, "argv", ["plot_comparison.py"] + paths + ["--out-dir",
                                                                       str(tmp_path / "cmp2")])
    root_cmp.main()
    for key in ("csv", "report"):
        with open(artifacts[key]) as f, open(tmp_path / "cmp2" / os.path.basename(artifacts[key])) as g:
            assert f.read() == g.read()


@pytest.fixture
def image_folder(tmp_path):
    """{train,valid,test}/{fake,real}/ with PNGs of mixed sizes (resized on
    load) and a stray non-image file."""
    import cv2

    rng = np.random.default_rng(7)
    for split, n in (("train", 5), ("valid", 2), ("test", 3)):
        for cls in ("real", "fake"):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                hw = (48, 48) if i % 3 == 0 else (80, 64) if i % 3 == 1 else (32, 40)
                cv2.imwrite(str(d / f"{i:02d}.png"), rng.integers(0, 256, hw + (3,), np.uint8))
            (d / "notes.txt").write_text("not an image")
    return tmp_path


@pytest.mark.parametrize("split,augment_on", [("train", True), ("test", False)])
def test_folder_dataset_matches_jax(image_folder, split, augment_on):
    d = str(image_folder / split)
    assert folder.scan_image_folder(d) == jax_folder.scan_image_folder(d)
    got = folder.FolderDataset(d, 48, augment=augment_on, seed=3)
    want = jax_folder.FolderDataset(d, 48, augment=augment_on, seed=3)
    assert got.classes == want.classes == ["fake", "real"]
    for kw in ({"shuffle": True, "epoch": 1}, {"drop_last": True}):
        pairs = list(zip(got.batches(4, **kw), want.batches(4, **kw), strict=True))
        assert pairs
        for (gi, gl), (wi, wl) in pairs:
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
            assert gi.dtype == np.uint8 and gl.dtype == np.int32


def test_load_image_and_load_data_match_jax(image_folder):
    path = str(image_folder / "train" / "fake" / "01.png")
    np.testing.assert_array_equal(folder.load_image(path, 48), jax_folder.load_image(path, 48))
    np.testing.assert_array_equal(folder.load_image(path), jax_folder.load_image(path))
    with pytest.raises(IOError):
        folder.load_image(str(image_folder / "train" / "fake" / "notes.txt"))
    got, sizes = folder.load_data(str(image_folder), batch_size=4, img_size=48, seed=1)
    want, jsizes = jax_folder.load_data(str(image_folder), batch_size=4, img_size=48, seed=1)
    assert sizes == jsizes == {"train": 10, "valid": 4, "test": 6}
    assert got["train"].augment and not got["test"].augment


@pytest.mark.parametrize("seed", range(3))
def test_strong_aug_matches_jax(seed):
    img = np.random.default_rng(seed).integers(0, 256, (40, 40, 3), np.uint8)
    for k in range(12):
        got = augment.strong_aug(img, np.random.default_rng([seed, k]))
        want = jax_augment.strong_aug(img, np.random.default_rng([seed, k]))
        np.testing.assert_array_equal(got, want)
