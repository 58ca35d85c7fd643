"""The port's data-parallel training step against its own one-process step
on the same global batch, on the CPU: four gloo ranks spawned once for the
module (tests/torch_parallel_ranks.py `train_rank`; the one-process runs on
ranks 1 and 2 beside the others), small models as in
tests/test_torch_parallel_train.py, which holds the same step against the
JAX package's sharded one. Bounds: tests/test_torch_train.py's float32
ones. Checked: two steps on 8 rows, one on 5 rows split 2/1/1/1, the
global BatchNorm statistics (the one-process running statistics within
1e-6), a planted fault (each rank's own BatchNorm statistics) that must
miss the bounds, and a `.gcv` save, restore and step with the loss within
rtol 1e-6."""

import pickle

import numpy as np
import pytest

from genconvit_tpu_torch.core.convert import state_dict_from_jax
from genconvit_tpu_torch.parallel.dryrun import Ranks

from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel_train import _misses, _port
from tests.test_torch_util import IMG, ed_state_dict, jax_trees, vae_state_dict

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results of train_rank."""
    tmp = tmp_path_factory.mktemp("parallel_step")
    rng = np.random.default_rng(0)
    trees = jax_trees(ed_state_dict(0, rng), vae_state_dict(1, rng))
    imgs = rng.integers(0, 256, (8, IMG, IMG, 3), np.uint8)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    eps = rng.standard_normal((3, 8, ranks.LATENT), np.float32)
    d = {"sds": {b: {k: v.numpy() for k, v in state_dict_from_jax(trees[b], b).items()}
                 for b in trees},
         "batch8": [(imgs, labels, eps[0]), (imgs, labels, eps[1])],
         "batch5": [(imgs[:5], labels[:5], eps[2, :5])]}
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(d))
    return Ranks(ranks.train_rank, WORLD, str(inputs), str(tmp)).join(timeout=300)


def test_dp_step_matches_the_one_process_step(runs):
    dp, one = _port(runs[0]["dp"]), _port(runs[1]["one8"])
    assert _misses(dp, one) == []
    # the global batch's statistics: the one-process run's running ones
    np.testing.assert_allclose(dp["bn"][0], one["bn"][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(dp["bn"][1], one["bn"][1], rtol=1e-6, atol=0)


def test_uneven_batch_matches_the_one_process_step(runs):
    assert [r["rows5"] for r in runs] == [2, 1, 1, 1]
    assert _misses(_port(runs[0]["uneven"]), _port(runs[2]["one5"])) == []


def test_per_rank_batchnorm_statistics_are_caught(runs):
    """A planted fault: each rank normalizes with its own rows' statistics."""
    assert _misses(_port(runs[0]["planted"]), _port(runs[1]["one8"])) != []


def test_resume_from_gcv(runs):
    for r in runs:
        cont, restored = r["resume"]
        np.testing.assert_allclose(restored, cont, rtol=1e-6)
