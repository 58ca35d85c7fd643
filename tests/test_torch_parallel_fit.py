"""The port's `train_model` data-parallel over two spawned gloo ranks
(tests/torch_parallel_ranks.py `train_model_rank`) against `train_model` in
this process, on a tiny ImageFolder at 64 px with the small backbone: the
same history within 1e-5 (the last training batch of 3 split 2/1,
validation's 3 split 2/1), the same test accuracy, bit-equal parameters on
both ranks, only the first rank writing the best and final checkpoints and
the history, and each rank reading only its rows. Also the data loading
that makes the last possible: `FolderDataset.batches` with a part yields
each rank's rows of the whole batch, augmented alike (`skip_aug` draws what
`strong_aug` draws)."""

import os
import pickle

import numpy as np
import pytest
import torch

from genconvit_tpu_torch.data import augment, folder
from genconvit_tpu_torch.models import convnext
from genconvit_tpu_torch.parallel.dryrun import Ranks
from genconvit_tpu_torch.parallel.mesh import shard_rows
from genconvit_tpu_torch.train import loop

from tests import torch_parallel_ranks as ranks

SPLITS = {"train": (4, 3), "valid": (2, 1), "test": (1, 1)}   # fake, real: batches 4+3, 3, 2
RANKS = 2


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    import cv2

    rng = np.random.default_rng(0)
    folder_dir = tmp_path_factory.mktemp("parallel_fit") / "folder"
    for split, counts in SPLITS.items():
        for cls, n in zip(("fake", "real"), counts):
            (folder_dir / split / cls).mkdir(parents=True)
            for i in range(n):
                cv2.imwrite(str(folder_dir / split / cls / f"{i}.jpg"),
                            rng.integers(0, 255, (ranks.IMG, ranks.IMG, 3), np.uint8))
    return folder_dir


@pytest.fixture(scope="module")
def fits(image_folder):
    """(each rank's results of train_model_rank, the one-process summary,
    the ranks' and the one process's weight directories)."""
    wdir = image_folder.parent / "w"
    spawned = Ranks(ranks.train_model_rank, RANKS, str(image_folder), str(wdir / "dp"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:   # the ranks register it themselves
            mp.setitem(convnext.CONVNEXT_CFGS, ranks.SMALL_NAME,
                       dict(depths=ranks.SMALL_DEPTHS, dims=ranks.SMALL_DIMS))
            one = loop.train_model(str(image_folder), weight_dir=str(wdir / "one"),
                                   **ranks.fit_kwargs())
    finally:
        torch.set_num_threads(threads)
    return spawned.join(timeout=300), one, wdir


def test_train_model_over_two_ranks_matches_one_process(fits):
    (dp0, dp1), one, _ = fits
    for r in (dp0, dp1):
        for k in ("train_loss", "train_acc", "valid_loss", "valid_acc"):
            np.testing.assert_allclose(r["history"][k], one["history"][k], rtol=1e-5, atol=1e-5)
        assert r["test"] == one["test_accuracy"]
        assert r["checkpoint"] == dp0["checkpoint"]
    assert dp0["digest"] == dp1["digest"]


def test_only_the_first_rank_writes(fits):
    """The best and the final checkpoint and the history, once."""
    (dp0, dp1), _, wdir = fits
    final = os.path.basename(dp0["checkpoint"])
    assert dp0["saves"] == ["genconvit_genconvit_best.gcv", final]
    assert dp1["saves"] == []
    assert sorted(os.listdir(wdir / "dp")) == sorted(
        ["genconvit_genconvit_best.gcv", final, final[:-4] + ".pkl"])
    with open(dp0["checkpoint"][:-4] + ".pkl", "rb") as f:
        assert pickle.load(f)[0] == dp0["history"]["train_loss"]


def test_each_rank_reads_only_its_rows(fits, image_folder):
    """Every image of every split read once over the two ranks (train
    batches 4+3, valid 3, test 2: 2+2+2+1 and 2+1+1+1), none twice."""
    (dp0, dp1), _, _ = fits
    assert len(dp0["reads"]) == 7 and len(dp1["reads"]) == 5
    assert not set(dp0["reads"]) & set(dp1["reads"])
    assert sorted(dp0["reads"] + dp1["reads"]) == sorted(
        os.path.join(d, f) for d, _, fs in os.walk(image_folder) for f in fs)


class _Group:
    """shard_rows' view of one rank of a process group."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


@pytest.mark.parametrize("world", [2, 3, 4])
def test_batches_part_is_the_whole_batch_rows(image_folder, world, monkeypatch):
    """Each rank's part of every batch (augmented, shuffled, the last one
    partial) equals its rows of the one-process batch."""
    monkeypatch.setattr("torch.distributed.get_world_size", lambda g: g.size)
    monkeypatch.setattr("torch.distributed.get_rank", lambda g: g.rank)
    ds = folder.FolderDataset(str(image_folder / "train"), ranks.IMG, augment=True, seed=5)
    whole = list(ds.batches(4, shuffle=True, epoch=1))
    for rank in range(world):
        g = _Group(rank, world)
        got = list(ds.batches(4, shuffle=True, epoch=1,
                              part=lambda n: shard_rows(n, g)))
        assert len(got) == len(whole)
        for (gi, gl), (wi, wl) in zip(got, whole):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gi, wi[shard_rows(len(wl), g)])
            assert gi.dtype == np.uint8 and gi.shape[1:] == (ranks.IMG, ranks.IMG, 3)


@pytest.mark.parametrize("hw", [(40, 40), (48, 32)])
def test_skip_aug_draws_what_strong_aug_draws(hw):
    """Over seeds that take every branch (rotations and transposes of a
    non-square image included), the generator ends where strong_aug
    leaves it."""
    img = np.random.default_rng(0).integers(0, 256, hw + (3,), np.uint8)
    for seed in range(64):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        augment.strong_aug(img, a)
        augment.skip_aug(img.shape, b)
        assert a.random() == b.random(), seed
