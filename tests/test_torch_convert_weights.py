"""The port's weight converter CLI and A/B runner against the repository's
on the CPU: `python -m genconvit_tpu_torch.convert_weights` writes the same
`.gcv` bytes as the root `convert_weights.py` for seeded reference-keyed
`.pth` files (ed, vae, vae_updated, SwiGLU heads; bare, nested under
'state_dict' and float16; with and without --no-dead), which both packages'
`load_params` read and the port's modules load strict; `preflight_manifest`
gives the JAX reports on the parity runbook's manifests, and the CLI its
exit codes; the two repairs (`--no-dead --strict` and `--expect-init` pass a
published layout, built from shapes alone at the published size) beside the
JAX behaviour they depart from; `python -m genconvit_tpu_torch.run_benchmark`
over the small corpus of test_torch_entry. Small models: ConvNeXt depths
(1,1,1,1), dims (8..64), 64 px."""

import functools
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from genconvit_tpu.config import load_config as jax_load_config
from genconvit_tpu.core import checkpoint as jax_ckpt
from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.models.genconvit import init_genconvit

from genconvit_tpu_torch import convert_weights, prediction_v2, run_benchmark
from genconvit_tpu_torch.core import checkpoint as ckpt
from genconvit_tpu_torch.core import convert
from genconvit_tpu_torch.core.convert import state_dict_from_jax, tree_from_state_dict
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.vae import GenConViTVAE
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

from tests.test_parity_runbook import REPO, ref_shim
from tests.test_torch_checkpoint import _assert_same_tree, _dead_groups
from tests.test_torch_entry import corpus
from tests.test_torch_util import (BACKBONE_CLASSES, IMG, ed_state_dict, small_backbone,
                                   vae_state_dict)
from tests.test_torch_vae_updated import oracle as updated_oracle
from tests.torch_oracles import SwinOracle

_ = (small_backbone, ref_shim, corpus)  # fixtures
FRAMES = "4"


def _reference(model: str) -> dict:
    """A seeded reference-keyed state dict with every dead group, timm's
    Swin buffers among them (a copy of the dict: the tensors are shared)."""
    return dict(_built_reference(model))


@functools.lru_cache(maxsize=None)
def _built_reference(model: str) -> dict:
    rng = np.random.default_rng(5)
    torch.manual_seed(5)
    family = "ed" if model.startswith("ed") else "vae"
    sd = (updated_oracle(0)[1] if model == "vae_updated"
          else ed_state_dict(0, rng) if family == "ed" else vae_state_dict(0, rng))
    if model.endswith("swiglu"):
        nf = 2 * BACKBONE_CLASSES
        sd["fc.weight"], sd["fc.bias"] = torch.randn(nf // 2, nf), torch.randn(nf // 2)
    sd.update(_dead_groups(family, rng))
    sd["embedder.layers.0.blocks.1.attn.relative_position_index"] = torch.zeros(
        16, 16, dtype=torch.long)
    sd["embedder.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    return sd


def _root_cli(monkeypatch, args):
    import convert_weights as root

    monkeypatch.setattr(sys, "argv", ["convert_weights.py"] + args)
    root.main()


def _load_strict(sd, meta, backbone):
    """The port's module of the file's branch spec (built on the meta
    device: only keys and shapes are checked) loads sd strict."""
    with torch.device("meta"):
        if "variant" not in meta:
            m = GenConViTED(backbone, backbone_classes=BACKBONE_CLASSES,
                            head_act=meta["head_act"])
        else:
            m = GenConViTVAE(backbone, IMG, backbone_classes=BACKBONE_CLASSES,
                             head_act=meta["head_act"], variant=meta["variant"])
    m.load_state_dict(sd, strict=True, assign=True)


def _jax_gcv(path, obj, pth, which, dead):
    """What the root CLI writes (convert_weights.py:79-93 there), through
    the JAX package's functions: the root CLI itself cannot take an updated
    VAE (see test_root_cli_needs_which)."""
    sd = jax_convert.unwrap_state_dict(obj)
    epoch = obj.get("epoch", 0) if isinstance(obj, dict) else 0
    min_loss = obj.get("min_loss", 0.0) if isinstance(obj, dict) else 0.0
    jax_ckpt.save_checkpoint(path, jax_convert.convert_checkpoint(sd, which=which,
                                                                  carry_dead_params=dead),
                             epoch=int(epoch), min_loss=float(min_loss),
                             extra={"source": os.path.basename(pth), "branch": which})


@pytest.mark.parametrize("dead", [True, False], ids=["carry", "no_dead"])
@pytest.mark.parametrize("model,form", [(m, f) for m in ("ed", "vae", "vae_updated")
                                        for f in ("bare", "state_dict", "fp16")]
                         + [("ed_swiglu", "bare"), ("vae_swiglu", "bare")])
def test_gcv_equals_the_root_cli(model, form, dead, small_backbone, tmp_path, monkeypatch,
                                 capsys):
    """The port's CLI (branch detected) against the root CLI given the
    branch (--which: without it the root CLI fails) or, for the updated VAE,
    against the root CLI's payload written by the JAX package."""
    ref = _reference(model)
    if form == "fp16":
        ref = {k: v.half() if v.is_floating_point() else v for k, v in ref.items()}
    obj = {"epoch": 3, "state_dict": ref, "min_loss": 0.25} if form == "state_dict" else ref
    pth = str(tmp_path / f"{model}.pth")
    torch.save(obj, pth)
    flags = [] if dead else ["--no-dead"]
    ours, theirs = str(tmp_path / "ours.gcv"), str(tmp_path / "theirs.gcv")
    assert convert_weights.main([pth, "--out", ours] + flags) == ours
    out_ours = capsys.readouterr().out
    branch = "vae_updated" if model == "vae_updated" else model.split("_")[0]
    if branch == "vae_updated":
        _jax_gcv(theirs, obj, pth, branch, dead)
    else:
        _root_cli(monkeypatch, [pth, "--which", branch, "--out", theirs] + flags)
        assert out_ours.replace(ours, "OUT") == capsys.readouterr().out.replace(theirs, "OUT")
    assert f"{pth} [{branch}] -> {ours}  (" in out_ours
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    family = model.split("_")[0]
    got, meta = ckpt.load_params(ours, family)
    want = state_dict_from_jax(jax_ckpt.load_params(ours, family)[0], family)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert meta["head_act"] == ("swiglu" if model.endswith("swiglu") else "default")
    _load_strict(got, meta, small_backbone)
    payload = ckpt.load_checkpoint(ours)
    assert payload["extra"] == {"source": f"{model}.pth", "branch": branch}
    assert ("embedder" in payload["params"]) == dead


def test_root_cli_needs_which(tmp_path, monkeypatch, capsys):
    """The root CLI converts only with --which: its --expect-init branch
    imports detect_branch inside main, which makes the name local, so the
    conversion's `args.which or detect_branch(sd)` raises UnboundLocalError.
    It reads an updated VAE under --which vae as the original and fails,
    so it cannot convert one at all. The port detects the branch, and its
    --which vae takes the updated VAE as auto-detection does."""
    for model in ("ed", "vae_updated"):
        pth = str(tmp_path / f"{model}.pth")
        torch.save(_reference(model), pth)
        with pytest.raises(UnboundLocalError, match="detect_branch"):
            _root_cli(monkeypatch, [pth, "--out", str(tmp_path / "x.gcv")])
    with pytest.raises(KeyError, match="decoder.features.2.weight"):
        _root_cli(monkeypatch, [pth, "--which", "vae", "--out", str(tmp_path / "x.gcv")])
    a, b = str(tmp_path / "a.gcv"), str(tmp_path / "b.gcv")
    convert_weights.main([pth, "--which", "vae", "--out", a, "--strict"])
    convert_weights.main([pth, "--out", b])
    assert capsys.readouterr().out.count("[vae_updated]") == 2
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_swin_tree_inverts_the_bridge():
    sd = SwinOracle().state_dict()
    tree = tree_from_state_dict(sd, "swin")
    _assert_same_tree(tree, jax_convert.convert_swin(sd))
    back = state_dict_from_jax(tree, "swin")
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _runbook_manifests(ref_shim, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import record_reference_torch as rrt
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    out = tmp_path / "parity"
    out.mkdir()
    rrt.record_manifests(ref_shim, str(out))
    return {w: json.loads((out / f"manifest_{w}.json").read_text()) for w in ("ed", "vae")}


@pytest.mark.parametrize("case", ["clean_ed", "clean_vae", "renamed", "extra", "shape_drift",
                                  "shape_clean"])
def test_preflight_reports_equal_jax(case, ref_shim, tmp_path):
    """tests/test_parity_runbook.py:164-222's manifests: the same report,
    key for key."""
    manifests = _runbook_manifests(ref_shim, tmp_path)
    manifest, kw = manifests["ed"], {"which": "ed"}
    if case == "clean_vae":
        manifest, kw = manifests["vae"], {}
    elif case == "clean_ed":
        kw = {}
    elif case == "renamed":
        manifest = dict(manifest)
        manifest["fc.linear.weight"] = manifest.pop("fc.weight")
    elif case == "extra":
        manifest = dict(manifest, **{"backbone.novel_branch.weight": {"shape": [4, 4],
                                                                      "dtype": "float32"}})
    elif case.startswith("shape"):
        kw["expected"] = jax_convert.convert_checkpoint(
            jax_convert.state_dict_from_manifest(manifest), which="ed")
        if case == "shape_drift":
            manifest = dict(manifest, **{"fc.weight": {"shape": [7, 3], "dtype": "float32"}})
    got, want = convert.preflight_manifest(manifest, **kw), jax_convert.preflight_manifest(
        manifest, **kw)
    assert got == want
    assert got["ok"] == case.startswith(("clean", "shape_clean"))
    if case == "renamed":
        assert "fc.linear.weight" in got["suggestions"]["fc.weight"]
    if case == "extra":
        assert got["unused"] == ["backbone.novel_branch.weight"]
    if case == "shape_drift":
        assert got["shape_mismatches"] == ["fc/kernel: checkpoint (3, 7) vs expected (20, 5)"]


def test_preflight_cli_exit_codes(ref_shim, tmp_path, capsys):
    """test_preflight_cli's two runs: 0 and PREFLIGHT OK on the clean VAE
    manifest, 1 on the one whose encoder.mu was renamed; the printed report
    is preflight_manifest's."""
    manifests = _runbook_manifests(ref_shim, tmp_path)
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(manifests["vae"]))
    drifted = dict(manifests["vae"])
    drifted["encoder.mystery.weight"] = drifted.pop("encoder.mu.weight")
    bad = tmp_path / "drifted.json"
    bad.write_text(json.dumps(drifted))
    capsys.readouterr()
    for path, code in ((clean, 0), (bad, 1)):
        with pytest.raises(SystemExit) as e:
            convert_weights.main(["--preflight", str(path)])
        assert e.value.code == code
        out = capsys.readouterr().out
        assert ("PREFLIGHT OK" in out) == (code == 0)
        report = json.loads(out[:out.rindex("}") + 1])
        assert report == jax_convert.preflight_manifest(json.loads(path.read_text()))


def _no_numpy(self, *a, **k):
    raise AssertionError("a leaf was materialized")


@pytest.mark.parametrize("branch", ["ed", "vae", "vae_updated"])
def test_no_dead_strict_passes_the_published_layout(branch, small_backbone, tmp_path,
                                                    monkeypatch, capsys):
    """Repair 1. The JAX converter's strict mode refuses the dead groups that
    --no-dead drops: on the published layout (a manifest of the published
    size, built from shapes alone) every dead key but timm's buffers is
    'not consumed', and convert_checkpoint(strict=True) raises on a seeded
    checkpoint. The port counts them as read: the preflight passes, on meta
    leaves only, and `--no-dead --strict` writes the tree the JAX converter
    gives without strict."""
    family = "ed" if branch == "ed" else "vae"
    layout = convert_weights.published_layout(branch)
    manifest = convert.manifest_from_state_dict(layout)
    dead = sorted(k for k in layout if convert._DEAD[family].match(k)
                  and not convert._EXPECTED_UNCONSUMED.match(k))
    jax_report = jax_convert.preflight_manifest(manifest, carry_dead_params=False)
    assert not jax_report["ok"] and jax_report["unused"] == dead and len(dead) > 100
    monkeypatch.setattr(torch.Tensor, "numpy", _no_numpy)
    report = convert.preflight_manifest(manifest, carry_dead_params=False)
    tree = convert.tree_from_reference(convert.state_dict_from_manifest(manifest),
                                       carry_dead_params=False, strict=True)
    monkeypatch.undo()
    assert report["ok"] and report["branch"] == branch and report["keys"] == len(layout)
    leaves = list(_leaves(tree))
    assert len(leaves) > 100 and all(leaf.is_meta for leaf in leaves)
    model = "vae_updated" if branch == "vae_updated" else family
    ref = _reference(model)
    with pytest.raises(ValueError, match="not consumed"):
        jax_convert.convert_checkpoint(ref, carry_dead_params=False, strict=True)
    pth = str(tmp_path / "ref.pth")
    torch.save(ref, pth)
    out = convert_weights.main([pth, "--no-dead", "--strict"])
    capsys.readouterr()
    _assert_same_tree(ckpt.load_checkpoint(out)["params"],
                      jax_ckpt._to_numpy(jax_convert.convert_checkpoint(
                          ref, carry_dead_params=False)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("branch", ["ed", "vae"])
def test_expect_init_passes_the_published_layout(branch, tmp_path, monkeypatch, capsys):
    """Repair 2. The root CLI's `--preflight M --expect-init` fails on the
    published layout either way: carrying, its init tree (load_config's
    carry_dead_params=False) has no dead groups; with --no-dead, strict
    accounting refuses them. The port's passes both, against its own
    modules on the meta device, whose tree equals the JAX init tree's
    shapes with and without the dead groups."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GENCONVIT_CONFIG", raising=False)
    path = tmp_path / "published.json"
    path.write_text(json.dumps(convert.manifest_from_state_dict(
        convert_weights.published_layout(branch))))
    for flags, why in (([], "shape/structure mismatch"), (["--no-dead"], "not consumed")):
        with pytest.raises(SystemExit) as e:
            _root_cli(monkeypatch, ["--preflight", str(path), "--expect-init"] + flags)
        assert e.value.code == 1
        out = capsys.readouterr().out
        report = json.loads(out)
        assert why in report["error"]
        if not flags:   # the JAX init tree is the port's without the dead groups
            assert report["shape_mismatches"] and all(
                "not in the expected tree" in m and m.startswith(
                    ("embedder/", "hybrid_proj/", "fc3/", "encoder/fc1/", "encoder/fc2/"))
                for m in report["shape_mismatches"])
        with pytest.raises(SystemExit) as e:
            convert_weights.main(["--preflight", str(path), "--expect-init"] + flags)
        assert e.value.code == 0
        assert f"PREFLIGHT OK: the converter consumes all" in capsys.readouterr().out
    cfg = jax_load_config()
    cfg.model.carry_dead_params = True
    want = jax.eval_shape(lambda k: init_genconvit(k, cfg, branch), jax.random.PRNGKey(0))
    assert convert._leaf_shapes(convert_weights.expected_tree(branch)) == \
        convert._leaf_shapes(want[branch])


def _deterministic(monkeypatch):
    monkeypatch.setattr(prediction_v2, "Predictor", functools.partial(
        prediction_v2.Predictor, deterministic_vae=True, kernel_plan=KernelPlan()))


def test_run_benchmark_runs_both_and_compares(corpus, tmp_path, monkeypatch, capsys):
    """Both result JSONs, whose video blocks equal prediction_v2.main's on
    the same argv, the comparison's CSV and text summary (matplotlib is
    needed there alone), the three banners in order."""
    monkeypatch.setenv("GENCONVIT_CONFIG", corpus["config"])
    _deterministic(monkeypatch)
    flags = ["--device", "cpu", "--face-backend", "center", "--weights-dir", corpus["weights"],
             "--workers", "2"]
    out_dir = str(tmp_path / "bench")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if have_mpl:
        got = run_benchmark.main([corpus["videos"], FRAMES, out_dir] + flags)
    else:
        with pytest.raises(ImportError):
            run_benchmark.main([corpus["videos"], FRAMES, out_dir] + flags)
    out = capsys.readouterr().out
    banners = [line for line in out.splitlines() if line.startswith("== ")]
    assert banners == ["== run 1: original ==", "== run 2: v2 ==", "== comparison =="]
    results = sorted(p for p in os.listdir(out_dir) if p.startswith("prediction_"))
    assert [p.rsplit("_", 6)[0] for p in results] == ["prediction_other_genconvit_original",
                                                      "prediction_other_genconvit_v2"]
    ref = prediction_v2.main(["--p", corpus["videos"], "--f", FRAMES, "--result-dir",
                              str(tmp_path / "ref")] + flags)
    with open(ref) as f:
        want = json.load(f)["video"]
    assert len(want["name"]) == 6
    for name in results:   # arch v2 runs the original graph (B12)
        with open(os.path.join(out_dir, name)) as f:
            assert json.load(f)["video"] == want
    if have_mpl:
        assert got["runs"] == {a: os.path.join(out_dir, n) for a, n in zip(("original", "v2"),
                                                                          results)}
        for key in ("csv", "bar_chart", "confusion"):
            assert os.path.isfile(got["artifacts"][key])
        with open(got["artifacts"]["csv"]) as f:
            rows = f.read().splitlines()
        assert len(rows) == 3 and rows[0].startswith("run,accuracy")
        assert os.path.isfile(os.path.join(out_dir, "summary_report.txt"))


def test_run_benchmark_fails_on_a_missing_directory(tmp_path):
    with pytest.raises(SystemExit) as e:
        run_benchmark.main([str(tmp_path / "missing"), "2", str(tmp_path / "out"), "--device",
                            "cpu"])
    assert e.value.code not in (0, None)
