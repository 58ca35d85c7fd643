"""model_summary and the tree sizes (genconvit_tpu_torch/utils/summary.py,
core/pytree.py) against the JAX package's: the same string for the same
tree, and for a module holding the same weights the same TOTAL count and
bytes (ed, vae and genconvit at a small backbone, 64 px). The JAX trees
come from the JAX package's converter on seeded oracle weights (its init
compiles for half a minute on the CPU); jax_trees builds them."""

import numpy as np
import pytest
import torch

from genconvit_tpu.core import pytree as jax_pytree
from genconvit_tpu.utils.summary import model_summary as jax_summary

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core import pytree
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.utils.summary import model_summary

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, SMALL_DEPTHS, SMALL_DIMS,
                                   ed_state_dict, jax_trees, small_backbone,
                                   vae_state_dict)

_ = small_backbone  # fixture


def _jax_trees(seed=0):
    rng = np.random.default_rng(seed)
    return jax_trees(ed_state_dict(seed, rng), vae_state_dict(seed, rng))


def _map(fn, tree):
    """tree with fn on every leaf, dicts in their own order (jax's tree_map
    sorts their keys, and the summary lists them in order)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _np_tree(tree):
    return _map(np.asarray, tree)


def _torch_tree(tree):
    return _map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("max_depth", [1, 2, 3])
def test_tree_summary_is_the_jax_string(max_depth):
    jtree = _jax_trees()
    want = jax_summary(jtree, max_depth)
    assert "TOTAL" in want and "vae" in want
    assert model_summary(_np_tree(jtree), max_depth) == want
    assert model_summary(_torch_tree(jtree), max_depth) == want


def test_tree_sizes_of_mixed_leaves():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float16), None,
                  {"c": np.arange(7, dtype=np.int64)}],
            "d": rng.standard_normal((2, 2)).astype(np.float64)}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": [torch.from_numpy(tree["b"][0]), None, {"c": torch.from_numpy(tree["b"][2]["c"])}],
             "d": torch.from_numpy(tree["d"])}
    for t in (tree, ttree):
        assert pytree.param_count(t) == jax_pytree.param_count(tree) == 12 + 5 + 7 + 4
        assert pytree.tree_bytes(t) == jax_pytree.tree_bytes(tree) == 48 + 10 + 56 + 32
    assert model_summary(ttree) == jax_summary(tree)


def _total(summary: str):
    line = summary.splitlines()[-1].split()
    assert line[0] == "TOTAL" and line[-1] == "MB"
    return int(line[1].replace(",", "")), float(line[2])


@pytest.mark.parametrize("net", ["ed", "vae", "genconvit"])
def test_module_total_is_the_jax_trees(net, small_backbone):
    jtree = _jax_trees(1)
    if net != "genconvit":
        jtree = {net: jtree[net]}
    module = GenConViT(Config(model=ModelConfig(backbone=small_backbone), img_size=IMG), net,
                       BACKBONE_CLASSES)
    for branch in module.branches():
        which = "ed" if branch is getattr(module, "ed", None) else "vae"
        branch.load_state_dict(state_dict_from_jax(jtree[which], which), strict=True)
    got = model_summary(module)
    want = jax_summary(jtree if net == "genconvit" else jtree[net])
    assert _total(got) == _total(want)
    n = pytree.param_count(jtree)
    assert _total(got)[0] == n == jax_pytree.param_count(jtree)
    # BatchNorm's running statistics are in the JAX tree ('mean', 'var'),
    # its integer batch count is not
    bn = [m for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert (n - sum(p.numel() for p in module.parameters())
            == sum(2 * m.num_features for m in bn))
    assert bool(bn) == (net != "ed")
    assert got.splitlines()[0].split()[0].startswith("ed/" if net != "vae" else "vae/")


def test_module_summary_walks_children_and_own_weights():
    from genconvit_tpu_torch.models.convnext import ConvNeXt

    m = ConvNeXt(SMALL_DEPTHS, SMALL_DIMS, num_classes=10)
    s = model_summary(m, max_depth=3)
    paths = [ln.split()[0] for ln in s.splitlines()]
    assert "stages/0/blocks" in paths and "head/fc/weight" in paths
    block = model_summary(m.stages[0].blocks[0], max_depth=1).splitlines()
    assert [ln.split()[0] for ln in block] == ["gamma", "conv_dw", "norm", "mlp", "TOTAL"]
    assert _total(s)[0] == sum(p.numel() for p in m.parameters())
