"""The port's train step (genconvit_tpu_torch/train/loop.py) against the JAX
package's make_train_step on the CPU: 'ed', 'vae' and 'genconvit', float32
and bfloat16 mixed precision, the KL term on and off (each net's
float32 and bfloat16 cases take the two settings between them), three
steps from the same weights, batch and eps (eps drawn from JAX's key as
vae_encode draws it). Small models: ConvNeXt depths (1,1,1,1), dims
(8..64), 64 px, layer scale U(0.1, 1), seeded BatchNorm statistics.

Compared after each step: loss and accuracy; after the first, each
branch's gradient (read off Adam's first moment, mu = 0.1 (g + wd p)); after
the third, each branch's parameter change, the BatchNorm running
statistics written back, Adam's moments and count. Float32: the same graph
up to float32 summation order (loss 1e-5 relative; gradients 1e-5 relative
L2; moments and parameter changes 1e-3, since Adam's first steps move a
parameter by about lr * sign(g), which float32 noise can flip where g is
noise itself, as for the encoder convolutions' biases in front of a
BatchNorm; running means 2e-4 absolute, the same cause through those
biases; variances 1e-5). Bfloat16: the port's error against its own
float32 step (same eps) must be at most twice the JAX bfloat16 step's,
plus 1e-3, for every quantity, and the loss within 1e-2 of JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.train.loop import make_train_step as jax_train_step
from genconvit_tpu.train.optim import make_optimizer as jax_optimizer

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.checkpoint import _list_form, opt_state_tree
from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.train import loop, optim

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, ed_state_dict, jax_trees,
                                   small_backbone_registered, vae_state_dict)

LR, WD = 1e-4, 1e-4
N, STEPS = 4, 3
LATENT = 256 * (IMG // 32) ** 2
CASES = [("ed", "float32", False), ("ed", "bfloat16", False),
         ("vae", "float32", False), ("vae", "bfloat16", True)]
# the ensemble's cases are tests/test_torch_train_joint.py's (one file a
# worker: the two halves run side by side)
JOINT_CASES = [("genconvit", "float32", True), ("genconvit", "bfloat16", False)]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    imgs = rng.integers(0, 256, (N, IMG, IMG, 3), np.uint8)
    labels = np.array([0, 1, 1, 0], np.int32)
    return trees, imgs, labels


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _bn(tree):
    bns = tree["vae"]["encoder"]["bns"] if "vae" in tree else []
    return (np.concatenate([np.asarray(b["mean"], np.float64) for b in bns] or [np.zeros(0)]),
            np.concatenate([np.asarray(b["var"], np.float64) for b in bns] or [np.zeros(0)]))


def _record(params, mu1, mu, nu, count, p0, losses, accs):
    """Per branch: gradient of step 1, parameter change, moments; BN stats."""
    out = {"loss": np.array(losses), "acc": np.array(accs), "count": count,
           "bn": _bn(params)}
    for b in p0:
        out[b] = {"grad": _flat(mu1[b]) / (1 - optim.BETAS[0]) - WD * _flat(p0[b]),
                  "dparam": _flat(params[b]) - _flat(p0[b]),
                  "mu": _flat(mu[b]), "nu": _flat(nu[b])}
    return out


def _jax_run(params, imgs, labels, net, dtype, use_kl, keys):
    jdt = getattr(jnp, dtype)
    tx = jax_optimizer(LR, WD)
    state = tx.init(params)
    step = jax_train_step(net, tx, use_kl, dtype=jdt, donate=False)
    p0 = jax.tree_util.tree_map(np.asarray, params)
    losses, accs, mu1 = [], [], None
    for k in keys:
        params, state, loss, acc = step(params, state, jnp.asarray(imgs), jnp.asarray(labels), k)
        losses.append(float(loss))
        accs.append(float(acc))
        if mu1 is None:
            mu1 = jax.tree_util.tree_map(np.array, state.inner_state[1].mu)
    adam = state.inner_state[1]
    return _record(params, mu1, adam.mu, adam.nu, int(adam.count), p0, losses, accs)


def _port_run(trees, imgs, labels, net, dtype, use_kl, eps):
    with small_backbone_registered() as name:
        cfg = Config(model=ModelConfig(backbone=name, latent_dims=LATENT), img_size=IMG)
        model = GenConViT(cfg, net, BACKBONE_CLASSES)
    for b, m in loop.branches(model).items():
        m.load_state_dict(state_dict_from_jax(trees[b], b))
    model = model.to(memory_format=torch.channels_last)
    opt = optim.make_optimizer(model.parameters(), LR, WD)
    step = loop.make_train_step(model, net, opt, use_kl, getattr(torch, dtype))
    p0 = jax.tree_util.tree_map(np.array, loop.params_tree(model))   # copies, not views
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels.astype(np.int64))
    losses, accs, mu1 = [], [], None
    for e in eps:
        loss, acc = step(x, y, e)
        losses.append(float(loss))
        accs.append(float(acc))
        if mu1 is None:
            mu1 = _list_form(opt_state_tree(opt, loop.branches(model))["inner_state"]["1"]["mu"])
            mu1 = jax.tree_util.tree_map(np.array, mu1)
    adam = _list_form(opt_state_tree(opt, loop.branches(model))["inner_state"]["1"])
    return _record(loop.params_tree(model), mu1, adam["mu"], adam["nu"], int(adam["count"]),
                   p0, losses, accs)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("net,dtype,use_kl", CASES)
def test_train_step_matches_jax(setup, net, dtype, use_kl):
    check_step(setup, net, dtype, use_kl)


def check_step(setup, net, dtype, use_kl):
    trees, imgs, labels = setup
    params = {b: jax.tree_util.tree_map(jnp.asarray, trees[b])
              for b in ("ed", "vae") if net in (b, "genconvit")}
    keys = list(jax.random.split(jax.random.PRNGKey(3), STEPS))
    eps = [None] * STEPS
    if net != "ed":
        eps = [torch.from_numpy(np.array(jax.random.normal(k, (N, LATENT), getattr(jnp, dtype)),
                                         np.float32)).to(getattr(torch, dtype)) for k in keys]
    want = _jax_run(params, imgs, labels, net, dtype, use_kl, keys)
    got = _port_run(trees, imgs, labels, net, dtype, use_kl, eps)
    assert got["count"] == want["count"] == STEPS
    branches = [b for b in ("ed", "vae") if b in params]
    if dtype == "float32":
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["acc"], want["acc"])
        for b in branches:
            assert _rel(got[b]["grad"], want[b]["grad"]) < 1e-5, b
            for k in ("dparam", "mu", "nu"):
                assert _rel(got[b][k], want[b][k]) < 1e-3, (b, k)
        np.testing.assert_allclose(got["bn"][0], want["bn"][0], atol=2e-4)
        np.testing.assert_allclose(got["bn"][1], want["bn"][1], rtol=1e-5)
        return
    # bfloat16: the port's float32 step on the same eps is the yardstick
    ref = _port_run(trees, imgs, labels, net, "float32", use_kl,
                    [None if e is None else e.float() for e in eps])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-2)
    for b in branches:
        for k in ("grad", "dparam", "mu", "nu"):
            mine, theirs = _rel(got[b][k], ref[b][k]), _rel(want[b][k], ref[b][k])
            assert mine <= 2 * theirs + 1e-3, (b, k, mine, theirs)
    for i in range(2):
        mine, theirs = _rel(got["bn"][i], ref["bn"][i]), _rel(want["bn"][i], ref["bn"][i])
        assert mine <= 2 * theirs + 1e-3, ("bn", i, mine, theirs)
