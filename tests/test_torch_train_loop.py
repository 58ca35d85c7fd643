"""The port's training loop, optimizer, checkpoints and CLI against the JAX
package's on the CPU.

  * make_optimizer / set_lr / step_lr against optax (make_optimizer of the
    JAX package) over three steps with a changing lr: a parameter with a
    gradient, one without (torch gives it None; optax a zero that still
    decays), and a BatchNorm statistic (a buffer in torch, masked from the
    decay in optax): within 1e-6 relative;
  * opt_state_tree's layout equals flax's to_state_dict(tx.init(params))
    (keys, shapes, dtypes), after steps too;
  * train_model(-m ed) end to end against the JAX package's, both resumed
    from one JAX-written training checkpoint (the small oracle ED, 64 px,
    an ImageFolder of 8/4/4 images a class): history within 1e-4
    (accuracies equal), parameters within 1e-3 relative (Adam's
    sign-like first steps, see test_torch_train.py), epochs and the .pkl;
    then each package resumes from the other's checkpoint for one more
    epoch and the two agree as closely;
  * `python -m genconvit_tpu_torch.train` trains, saves and resumes with
    --device cpu, and raises without CUDA and for an unknown --vae-variant
    (tests/test_torch_vae_updated.py trains the updated one).
The detector's train step is tests/test_torch_facedet_train.py's."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.core import checkpoint as jax_ckpt
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.train import loop as jax_loop
from genconvit_tpu.train import optim as jax_optim

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core import checkpoint as ckpt
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.train import loop, optim
from genconvit_tpu_torch.train.__main__ import main as cli_main

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, SMALL_DEPTHS, SMALL_DIMS, SMALL_NAME,  # noqa: F401
                                   small_backbone,
                                   ed_state_dict, jax_trees, vae_state_dict, write_small_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- optimizer


def test_optimizer_and_schedule_match_optax():
    rng = np.random.default_rng(0)
    w0, z0 = rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    m0 = rng.standard_normal(2).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    lrs = [1e-2, 1e-2, 1e-3]
    params = {"a": {"kernel": jnp.asarray(w0)}, "var": {"kernel": jnp.asarray(z0)},
              "vae": {"encoder": {"bns": [{"mean": jnp.asarray(m0)}]}}}
    tx = jax_optim.make_optimizer(lrs[0], 1e-2)
    state = tx.init(params)
    for g, lr in zip(grads, lrs):
        state = jax_optim.set_lr(state, lr)
        gt = {"a": {"kernel": jnp.asarray(g)}, "var": {"kernel": jnp.zeros(5)},
              "vae": {"encoder": {"bns": [{"mean": jnp.zeros(2)}]}}}
        upd, state = tx.update(gt, state, params)
        params = optax.apply_updates(params, upd)

    def run(fill: bool):
        a, z = torch.nn.Parameter(torch.from_numpy(w0.copy())), torch.nn.Parameter(torch.from_numpy(z0.copy()))
        opt = optim.make_optimizer([a, z], lrs[0], 1e-2)
        for g, lr in zip(grads, lrs):
            optim.set_lr(opt, lr)
            opt.zero_grad(set_to_none=False)
            a.grad = torch.from_numpy(g.copy())
            if fill:
                optim.fill_missing_grads(opt)
            opt.step()
        return a.detach().numpy(), z.detach().numpy()

    a, z = run(fill=True)
    np.testing.assert_allclose(a, np.asarray(params["a"]["kernel"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(z, np.asarray(params["var"]["kernel"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(params["vae"]["encoder"]["bns"][0]["mean"]), m0)
    assert np.abs(z - z0).min() > 1e-3       # the zero-gradient leaf moved by its decay
    _, z_unfilled = run(fill=False)          # torch's Adam alone skips it
    np.testing.assert_array_equal(z_unfilled, z0)
    sched, want = optim.step_lr(1e-4), jax_optim.step_lr(1e-4)
    assert [sched(e) for e in range(46)] == [want(e) for e in range(46)]


def _small_cfg():
    return Config(model=ModelConfig(backbone=SMALL_NAME, latent_dims=256 * (IMG // 32) ** 2),
                  img_size=IMG)


def test_opt_state_layout_is_flaxs(small_backbone):
    rng = np.random.default_rng(1)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    model = GenConViT(_small_cfg(), "genconvit", BACKBONE_CLASSES)
    for b, m in loop.branches(model).items():
        m.load_state_dict(state_dict_from_jax(trees[b], b))
    opt = optim.make_optimizer(model.parameters(), 1e-4, 1e-4)
    tx = jax_optim.make_optimizer(1e-4, 1e-4)
    want = serialization.to_state_dict(tx.init(jax.tree_util.tree_map(jnp.asarray, trees)))

    def signature(t):
        return jax.tree_util.tree_structure(t), [(np.shape(x), np.asarray(x).dtype)
                                                 for x in jax.tree_util.tree_leaves(t)]

    assert signature(ckpt.opt_state_tree(opt, loop.branches(model))) == signature(want)
    step = loop.make_train_step(model, "genconvit", opt)
    x = torch.from_numpy(rng.integers(0, 256, (2, IMG, IMG, 3), np.uint8))
    step(x, torch.tensor([0, 1]), torch.zeros(2, 256 * (IMG // 32) ** 2))
    got = ckpt.opt_state_tree(opt, loop.branches(model))
    assert signature(got) == signature(want)
    assert int(got["count"]) == int(got["inner_state"]["1"]["count"]) == 1
    # the BatchNorm statistics' moments stay zero, as optax's do
    assert not np.any(got["inner_state"]["1"]["mu"]["vae"]["encoder"]["bns"]["0"]["mean"])


# ---------------------------------------------------------------- train_model


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("trainfolder")
    rng = np.random.default_rng(0)
    for split, n in [("train", 8), ("valid", 4), ("test", 4)]:
        for cls in ["fake", "real"]:
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                cv2.imwrite(str(d / f"{i}.jpg"), rng.integers(0, 255, (IMG, IMG, 3), np.uint8))
    return str(root)


@pytest.fixture
def both_small(small_backbone, monkeypatch):
    """The small backbone under one name in both packages."""
    monkeypatch.setitem(jax_convnext.CONVNEXT_CFGS, SMALL_NAME,
                        dict(depths=SMALL_DEPTHS, dims=SMALL_DIMS))
    jcfg = JaxConfig()
    jcfg.img_size = IMG
    jcfg.model.latent_dims = jcfg.derived_latent_dims()
    jcfg.model.backbone = SMALL_NAME
    return jcfg, _small_cfg()


def _jax_train(data_dir, jcfg, wdir, pretrained):
    return jax_loop.train_model(data_dir, "ed", 1, pretrained=pretrained, test_model=True,
                                batch_size=4, config=jcfg, weight_dir=str(wdir), seed=1,
                                log_every=100, data_parallel=False)


def _port_train(data_dir, cfg, wdir, pretrained):
    return loop.train_model(data_dir, "ed", 1, pretrained=pretrained, test_model=True,
                            batch_size=4, config=cfg, weight_dir=str(wdir), seed=1,
                            log_every=100, device="cpu")


def _check_runs(got, want):
    """Two summaries and their checkpoints: the same history, epoch,
    parameters and Adam state."""
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-4)
    for k in ("train_acc", "valid_acc"):
        assert got["history"][k] == want["history"][k]
    assert got["test_accuracy"] == want["test_accuracy"]
    pg, pw = ckpt.load_checkpoint(got["checkpoint"]), jax_ckpt.load_checkpoint(want["checkpoint"])
    assert pg["epoch"] == pw["epoch"]
    assert _rel(_flat(pg["params"]), _flat(pw["params"])) < 1e-3
    sg, sw = pg["opt_state"]["inner_state"]["1"], pw["opt_state"]["inner_state"]["1"]
    assert int(sg["count"]) == int(sw["count"])
    for k in ("mu", "nu"):
        assert _rel(_flat(sg[k]), _flat(sw[k])) < 1e-3, k
    with open(got["checkpoint"][:-4] + ".pkl", "rb") as f:
        hist = pickle.load(f)
    assert hist[0] == got["history"]["train_loss"] and hist[3] == got["history"]["valid_acc"]


def test_train_model_matches_jax_and_resumes_across(tmp_path, data_dir, both_small):
    jcfg, cfg = both_small
    rng = np.random.default_rng(2)
    tree = {"ed": jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))["ed"]}
    tx = jax_optim.make_optimizer(1e-4, 1e-4)
    start = str(tmp_path / "start.gcv")
    jax_ckpt.save_checkpoint(start, tree, epoch=3, min_loss=5.0,
                             opt_state=tx.init(jax.tree_util.tree_map(jnp.asarray, tree)))
    want = _jax_train(data_dir, jcfg, tmp_path / "jax", start)
    got = _port_train(data_dir, cfg, tmp_path / "port", start)
    _check_runs(got, want)
    assert ckpt.load_checkpoint(got["checkpoint"])["epoch"] == 3 + 1 + 1
    # across: each package resumes from the other's checkpoint
    want2 = _jax_train(data_dir, jcfg, tmp_path / "jax2", got["checkpoint"])
    got2 = _port_train(data_dir, cfg, tmp_path / "port2", want["checkpoint"])
    _check_runs(got2, want2)


# ---------------------------------------------------------------- CLI


def test_cli_trains_saves_and_resumes_on_the_cpu(tmp_path, data_dir, small_backbone,
                                                 monkeypatch):
    monkeypatch.setenv("GENCONVIT_CONFIG", write_small_config(tmp_path / "config.yaml"))
    wdir = tmp_path / "w"
    args = ["-d", data_dir, "-m", "vae", "-e", "1", "-b", "8", "--weight-dir", str(wdir),
            "--device", "cpu"]
    first = cli_main(args)
    payload = ckpt.load_checkpoint(first["checkpoint"])
    assert payload["epoch"] == 2 and set(payload["params"]) == {"vae"}
    assert int(payload["opt_state"]["inner_state"]["1"]["count"]) == 2   # 16 images, batch 8
    second = cli_main(args + ["-p", first["checkpoint"], "--bf16"])
    payload2 = ckpt.load_checkpoint(second["checkpoint"])
    assert payload2["epoch"] == 2 + 1 + 1      # the reference's start + epochs + 1
    assert int(payload2["opt_state"]["inner_state"]["1"]["count"]) == 4
    assert len(second["history"]["train_loss"]) == 1


def test_cli_refuses_without_cuda_and_the_updated_vae(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    cases = {"no CUDA device": ["-d", str(tmp_path)],
             "invalid choice: 'bogus'": ["-d", str(tmp_path), "--vae-variant", "bogus",
                                         "--device", "cpu"]}
    for msg, argv in cases.items():
        proc = subprocess.run([sys.executable, "-m", "genconvit_tpu_torch.train", *argv],
                              cwd=str(tmp_path), env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0 and msg in proc.stderr, proc.stderr[-2000:]
