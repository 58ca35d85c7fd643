"""The port's data-parallel training step (train/loop.py with a group, the
BatchNorms' global statistics in ops/norm.py) on the CPU: four gloo ranks
spawned once for the module (tests/torch_parallel_ranks.py `dp_rank`), two
steps against the JAX package's genconvit step with the batch sharded over
four of the conftest's virtual devices, from the same weights, batch and
eps (eps from JAX's key, as tests/test_torch_train.py draws it), within
that file's float32 bounds (loss 1e-5 relative; gradients 1e-5 relative
L2; moments and parameter change 1e-3; running means 2e-4 absolute;
variances 1e-5). The step against the port's one-process step, the planted
fault and the resume are tests/test_torch_parallel_step.py's, `train_model`
over two ranks tests/test_torch_parallel_fit.py's (one file a worker: the
JAX compile here runs beside the others)."""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from genconvit_tpu.parallel.mesh import make_mesh as jax_mesh
from genconvit_tpu.parallel.mesh import shard_batch as jax_shard_batch
from genconvit_tpu.parallel.mesh import shard_params as jax_shard_params
from genconvit_tpu.train.loop import make_train_step as jax_train_step
from genconvit_tpu.train.optim import make_optimizer as jax_optimizer

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.parallel.dryrun import Ranks

from tests import torch_parallel_ranks as ranks
from tests.test_torch_train import _record, _rel
from tests.test_torch_util import IMG, ed_state_dict, jax_trees, vae_state_dict

WORLD = 4
N, STEPS = 8, 2
LATENT = ranks.LATENT


def _eps(key, n):
    return np.array(jax.random.normal(key, (n, LATENT), jnp.float32), np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's record, each rank's results of dp_rank)."""
    tmp = tmp_path_factory.mktemp("parallel_train")
    rng = np.random.default_rng(0)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    imgs = rng.integers(0, 256, (N, IMG, IMG, 3), np.uint8)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    keys = list(jax.random.split(jax.random.PRNGKey(3), STEPS))
    d = {"sds": {b: {k: v.numpy() for k, v in state_dict_from_jax(trees[b], b).items()}
                 for b in trees},
         "batch8": [(imgs, labels, _eps(k, N)) for k in keys]}
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(d))
    steps = Ranks(ranks.dp_rank, WORLD, str(inputs))

    # the JAX step with the batch sharded over four devices, meanwhile
    mesh = jax_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    params = jax_shard_params({b: jax.tree_util.tree_map(jnp.asarray, trees[b])
                               for b in ("ed", "vae")}, mesh)
    tx = jax_optimizer(ranks.LR, ranks.WD)
    # the state replicated as the step returns it: one compile for both steps
    state = jax_shard_params(tx.init(params), mesh)
    step = jax_train_step("genconvit", tx, False, donate=False)
    p0 = jax.tree_util.tree_map(np.asarray, params)
    x, y = jax_shard_batch(imgs, mesh), jax_shard_batch(labels, mesh)
    losses, accs, mu1 = [], [], None
    for k in keys:
        params, state, loss, acc = step(params, state, x, y, k)
        losses.append(float(loss))
        accs.append(float(acc))
        if mu1 is None:
            mu1 = jax.tree_util.tree_map(np.array, state.inner_state[1].mu)
    adam = state.inner_state[1]
    want = _record(params, mu1, adam.mu, adam.nu, int(adam.count), p0, losses, accs)
    return want, steps.join(timeout=300)


def _port(rec):
    first, last = rec["first"], rec["last"]
    return _record(last["params"], first["mu"], last["mu"], last["nu"], last["count"],
                   rec["p0"], rec["loss"], rec["acc"])


def _misses(got, want):
    """The float32 bounds of tests/test_torch_train.py that `got` misses."""
    out = []
    if got["count"] != want["count"]:
        out.append("count")
    if not np.allclose(got["loss"], want["loss"], rtol=1e-5, atol=0):
        out.append("loss")
    if not np.array_equal(got["acc"], want["acc"]):
        out.append("acc")
    for b in ("ed", "vae"):
        if not _rel(got[b]["grad"], want[b]["grad"]) < 1e-5:
            out.append(f"{b} grad")
        out += [f"{b} {k}" for k in ("dparam", "mu", "nu")
                if not _rel(got[b][k], want[b][k]) < 1e-3]
    if not np.allclose(got["bn"][0], want["bn"][0], rtol=0, atol=2e-4):
        out.append("running mean")
    if not np.allclose(got["bn"][1], want["bn"][1], rtol=1e-5, atol=0):
        out.append("running var")
    return out


def test_dp_step_matches_the_jax_sharded_step(runs):
    want, got = runs
    assert _misses(_port(got[0]), want) == []


def test_parameters_bit_equal_across_ranks(runs):
    _, got = runs
    assert len({r["digest"] for r in got}) == 1
    for r in got:
        assert r["loss"] == got[0]["loss"]


def test_recompute_sees_the_forward_statistics(runs):
    """Each step runs the VAE encoder's four BatchNorms forward and again in
    the recompute: the same global statistics, bit for bit."""
    _, got = runs
    seen = got[0]["bn_calls"]
    assert len(seen) == STEPS * 8
    for s in range(STEPS):
        for j in range(4):
            np.testing.assert_array_equal(seen[8 * s + j], seen[8 * s + 4 + j])
