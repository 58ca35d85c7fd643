"""The port's checkpoint I/O and configuration against the JAX package's:
the msgpack reader against flax's `load_checkpoint` bit for bit on files the
JAX save_checkpoint writes (chunked arrays too, with flax's MAX_CHUNK_SIZE
made small), the port's writer read back by flax (byte for byte the file
flax writes for numpy trees), `load_params` against `state_dict_from_jax`,
reference-keyed `.pth` dicts loading strict, and `load_config`/`apply_size`
against the JAX package's on YAML files written here."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

from genconvit_tpu import config as jax_config
from genconvit_tpu.core import checkpoint as jax_ckpt
from genconvit_tpu.core import convert as jax_convert

from genconvit_tpu_torch import config as port_config
from genconvit_tpu_torch.core import checkpoint as ckpt
from genconvit_tpu_torch.core.convert import (state_dict_from_jax, state_dict_from_reference,
                                              tree_from_state_dict)
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.vae import GenConViTVAE

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, ed_state_dict, jax_trees,
                                   small_backbone, vae_state_dict)
from tests.torch_oracles import SwinOracle

_ = small_backbone  # fixture
ASSET = os.path.join(os.path.dirname(__file__), "..", "genconvit_tpu", "assets", "facedet.gcv")


def _as_numpy(leaf):
    """A leaf of either reader as comparable numpy (bfloat16 as uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        return (leaf.view(torch.uint16) if leaf.dtype == torch.bfloat16 else leaf).numpy(), \
            "bfloat16" if leaf.dtype == torch.bfloat16 else leaf.numpy().dtype.name
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want, "dtype"):
        g, gname = _as_numpy(got)
        w, wname = _as_numpy(want)
        assert gname == wname and g.shape == w.shape, (path, gname, wname)
        np.testing.assert_array_equal(g, w, err_msg=path)
        assert isinstance(got, (np.ndarray, torch.Tensor)) == isinstance(want, np.ndarray), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _trees(rng):
    return {
        "bf16": {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16)},
        "f32": rng.standard_normal((3, 4, 2)).astype(np.float32),
        "int8": rng.integers(-128, 128, (9,), dtype=np.int8),
        "nested": [[rng.standard_normal(3).astype(np.float32), {"b": np.arange(4)}],
                   np.zeros((0, 2), np.float32)],
        "scalar": np.float32(2.5),
        "f64": rng.standard_normal(300),
    }


@pytest.mark.parametrize("case", ["arrays", "opt_state_none", "extra", "chunked"])
def test_reader_matches_flax(case, tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    params = _trees(rng)
    kw = {}
    if case == "opt_state_none":
        params = {"only": params["f32"]}
    elif case == "extra":
        kw = dict(epoch=7, min_loss=0.125, opt_state={"mu": params["f32"], "count": np.int32(3)},
                  extra={"kind": "x" * 40, "n": None, "flag": True, "big": 70000,
                         "neg": -200000, "frac": 0.3, "z": 1 + 2j, "list": [1, -2, 3]})
    elif case == "chunked":
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        params["f32_big"] = rng.standard_normal((9, 7)).astype(np.float32)   # 252 bytes
        params["bf16_big"] = jnp.asarray(rng.standard_normal((41,)), jnp.bfloat16)
    path = str(tmp_path / "c.gcv")
    jax_ckpt.save_checkpoint(path, params, **kw)
    if case == "chunked":
        assert b"__msgpack_chunked_array__" in open(path, "rb").read()
    _assert_same_tree(ckpt.load_checkpoint(path), jax_ckpt.load_checkpoint(path))


def test_reader_reads_the_committed_detector(tmp_path):
    _assert_same_tree(ckpt.load_checkpoint(ASSET), jax_ckpt.load_checkpoint(ASSET))


def test_reader_refuses_bad_files(tmp_path):
    p = tmp_path / "x.gcv"
    jax_ckpt.save_checkpoint(str(p), {"a": np.zeros(3, np.float32)})
    blob = p.read_bytes()
    p.write_bytes(blob[:-5])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.load_checkpoint(str(p))
    p.write_bytes(blob + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        ckpt.load_checkpoint(str(p))
    p.write_bytes(serialization.msgpack_serialize({"format": "other", "params": {}}))
    with pytest.raises(ValueError, match="not a genconvit_tpu checkpoint"):
        ckpt.load_checkpoint(str(p))


@pytest.mark.parametrize("chunk", [None, 64])
def test_writer_is_read_by_flax(chunk, tmp_path, monkeypatch):
    """The port's save_checkpoint: the same bytes as the JAX package's for a
    numpy tree, and flax restores it (torch bf16 leaves included)."""
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(1)
    params = _trees(rng)
    extra = {"note": "n", "v": [1, 2], "s": np.float32(0.5)}
    ours, theirs = str(tmp_path / "ours.gcv"), str(tmp_path / "theirs.gcv")
    jax_ckpt.save_checkpoint(theirs, params, epoch=3, min_loss=1.5, extra=extra)
    ckpt.save_checkpoint(ours, jax_ckpt._to_numpy(params), epoch=3, min_loss=1.5, extra=extra)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    torch_params = jax_ckpt._to_numpy(params)
    torch_params["bf16"] = {"w": torch.from_numpy(
        np.asarray(params["bf16"]["w"]).view(np.uint16).copy()).view(torch.bfloat16)}
    torch_params["f32"] = torch.from_numpy(params["f32"])
    ckpt.save_checkpoint(ours, torch_params, epoch=3, min_loss=1.5, extra=extra)
    _assert_same_tree(jax_ckpt.load_checkpoint(ours), jax_ckpt.load_checkpoint(theirs))


@pytest.mark.parametrize("branch", ["ed", "vae"])
@pytest.mark.parametrize("nested", [True, False])
def test_load_params_equals_state_dict_from_jax(branch, nested, tmp_path):
    rng = np.random.default_rng(2)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    path = str(tmp_path / f"{branch}.gcv")
    jax_ckpt.save_checkpoint(path, {branch: trees[branch]} if nested else trees[branch],
                             epoch=4)
    sd, meta = ckpt.load_params(path, branch)
    want = state_dict_from_jax(jax_ckpt.load_params(path, branch)[0], branch)
    assert list(sd) == list(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(), err_msg=k)
    assert meta["source"] == "native" and meta["epoch"] == 4


@pytest.mark.parametrize("branch", ["ed", "vae"])
def test_tree_from_state_dict_inverts_the_bridge(branch):
    rng = np.random.default_rng(3)
    sd = ed_state_dict(0, rng) if branch == "ed" else vae_state_dict(0, rng)
    want = (jax_convert.convert_ed(sd) if branch == "ed"
            else jax_convert.convert_vae(sd, carry_dead_params=False))
    _assert_same_tree(tree_from_state_dict(sd, branch), want)


def _dead_groups(branch, rng):
    """The reference checkpoints' dead groups: the Swin embedder (the
    SwinOracle's keys), the HybridEmbed copy under the backbone's
    patch_embed, and for the VAE encoder.fc1/fc2 and fc3."""
    swin = {f"embedder.{k}": v for k, v in SwinOracle().state_dict().items()}
    bb = "backbone" if branch == "ed" else "convnext_backbone"
    dead = dict(swin)
    dead.update({f"{bb}.patch_embed.backbone.{k[len('embedder.'):]}": v
                 for k, v in swin.items()})
    dead[f"{bb}.patch_embed.proj.weight"] = torch.randn(768, BACKBONE_CLASSES, 1, 1)
    dead[f"{bb}.patch_embed.proj.bias"] = torch.randn(768)
    if branch == "vae":
        dead["encoder.fc1.weight"] = torch.randn(256, 128 * (IMG // 16) ** 2)
        dead["encoder.fc1.bias"] = torch.randn(256)
        dead["encoder.fc2.weight"] = torch.randn(128, 256)
        dead["encoder.fc2.bias"] = torch.randn(128)
        dead["fc3.weight"] = torch.randn(5, 10)
        dead["fc3.bias"] = torch.randn(5)
    return dead


@pytest.mark.parametrize("branch", ["ed", "vae"])
@pytest.mark.parametrize("form", ["bare", "state_dict", "fp16"])
def test_reference_pth_loads_strict(branch, form, small_backbone, tmp_path):
    rng = np.random.default_rng(4)
    sd = ed_state_dict(0, rng) if branch == "ed" else vae_state_dict(0, rng)
    ref = dict(sd, **_dead_groups(branch, rng))
    if form == "fp16":
        ref = {k: v.half() if v.is_floating_point() else v for k, v in ref.items()}
    obj = {"epoch": 3, "state_dict": ref, "min_loss": 0.1} if form == "state_dict" else ref
    path = str(tmp_path / f"{branch}.pth")
    torch.save(obj, path)
    got, meta = ckpt.load_params(path, branch)
    assert meta["source"] == "torch"
    module = (GenConViTED(small_backbone, backbone_classes=BACKBONE_CLASSES) if branch == "ed"
              else GenConViTVAE(small_backbone, img_size=IMG, backbone_classes=BACKBONE_CLASSES))
    module.load_state_dict(got, strict=True)
    want = (jax_convert.convert_checkpoint(obj, which=branch, carry_dead_params=False))
    for k, v in state_dict_from_jax(want, branch).items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert set(got) == set(sd)


def test_resolve_weight_order(tmp_path):
    for ext in (".pth", ".gcv"):
        (tmp_path / f"w{ext}").write_bytes(b"")
    for name in ("w", "missing"):
        assert ckpt.resolve_weight(str(tmp_path), name) == jax_ckpt.resolve_weight(
            str(tmp_path), name)
    assert ckpt.resolve_weight(str(tmp_path), "w").endswith(".gcv")


_YAMLS = {
    "reference": ("model:\n  backbone: convnext_tiny\n  embedder: swin_tiny_patch4_window7_224\n"
                  "  latent_dims: 12544\n\nbatch_size: 32\nepoch: 1\nlearning_rate: 0.0001\n"
                  "weight_decay: 0.0001\nnum_classes: 2\nimg_size: 224\nmin_val_loss: 10000\n"),
    "overrides": ("# a comment\nmodel:\n  backbone: 'convnext_large'   # trailing\n"
                  "  latent_dims: 1024\nimg_size: 64\nface_backend: \"center\"\n"
                  "compute_dtype: bfloat16\nweight_dir: /w/x\nunknown: 1e-4\n"),
    "empty": "# nothing\n",
}


@pytest.mark.parametrize("name", sorted(_YAMLS))
@pytest.mark.parametrize("size", [None, "tiny", "large", "base"])
def test_load_config_matches_jax(name, size, tmp_path, monkeypatch):
    p = tmp_path / "c.yaml"
    p.write_text(_YAMLS[name])
    monkeypatch.delenv("GENCONVIT_CONFIG", raising=False)
    got, want = port_config.load_config(str(p)), jax_config.load_config(str(p))
    if size:
        port_config.apply_size(got, size)
        jax_config.apply_size(want, size)
    g, w = got.to_dict(), want.to_dict()
    assert g["model"] == {k: w["model"][k] for k in g["model"]}
    assert {k: v for k, v in g.items() if k != "model"} == {k: w[k] for k in g if k != "model"}


def test_load_config_search_order(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GENCONVIT_CONFIG", raising=False)
    assert port_config.load_config() == port_config.Config()
    (tmp_path / "config.yaml").write_text("img_size: 96\n")
    (tmp_path / "model").mkdir()
    (tmp_path / "model" / "config.yaml").write_text("img_size: 128\n")
    env = tmp_path / "env.yaml"
    env.write_text("img_size: 160\n")
    assert port_config.load_config().img_size == jax_config.load_config().img_size == 128
    monkeypatch.setenv("GENCONVIT_CONFIG", str(env))
    assert port_config.load_config().img_size == jax_config.load_config().img_size == 160


def test_config_refuses_what_is_not_ported():
    cfg = port_config.Config.from_dict({"model": {"vae_variant": "updated"}})
    assert cfg.model.vae_variant == jax_config.Config.from_dict(
        {"model": {"vae_variant": "updated"}}).model.vae_variant == "updated"
    with pytest.raises(ValueError, match="vae_variant"):
        port_config.Config.from_dict({"model": {"vae_variant": "bogus"}})
    with pytest.raises(ValueError):
        port_config.parse_yaml("model:\n  - a\n")
    with pytest.raises(ValueError, match="escape"):
        port_config.parse_yaml('weight_dir: "a\\tb"\n')
