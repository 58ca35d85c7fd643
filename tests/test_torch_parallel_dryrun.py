"""The port's dry run (`python -m genconvit_tpu_torch.parallel.dryrun N`) runs
on the card unless asked: without CUDA the default raises before any rank
starts, and `--device cpu` hands the CPU to every rank. Its mesh follows
the JAX package's rule, and `dryrun_multichip(..., small=True)` runs it on
the CPU at the test size (four ranks on a 2x2 mesh, about 10 s). The full-size run (convnext_tiny in
every rank) is the card's and the CLI's: `chip_smoke.py`'s phases 16 and 17
drive the same functions on the card, and tests/test_torch_parallel*.py
hold them against JAX at a small size."""

import pytest
import torch

from genconvit_tpu_torch.parallel import dryrun


class _Spawned:
    def __init__(self, fn, n, *args):
        self.calls.append((fn, n, args[1:]))

    def join(self):
        return []


@pytest.fixture
def spawned(monkeypatch):
    calls = []
    monkeypatch.setattr(dryrun, "Ranks", type("Ranks", (_Spawned,), {"calls": calls}))
    return calls


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch, spawned):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    assert spawned == []


def test_dryrun_device_cpu_reaches_every_rank(spawned):
    dryrun.main(["3", "--device", "cpu"])
    assert spawned == [(dryrun._dryrun_rank, 3, ("cpu", False))]


def test_mesh_rule_is_the_jax_packages():
    """model = 2 where N is even (__graft_entry__.py:88-90)."""
    assert [dryrun.mesh_shape(n) for n in (1, 2, 3, 4, 8)] == [
        (1, 1), (1, 2), (3, 1), (2, 2), (4, 2)]


def test_dryrun_2x2_on_the_cpu():
    """The dry run of 4 ranks on the CPU at the test size: a 2x2 mesh, each
    through the DP+TP step, the sharded resume, predict_sharded with tensor
    parallelism and the long video, each returning the lines it checked."""
    lines = dryrun.dryrun_multichip(4, "cpu", small=True)
    assert len(lines) == 4
    for r in lines:
        assert len(r) == 4
        assert r[0].startswith("dryrun_multichip(4): mesh {'data': 2, 'model': 2} tp=True loss=")
        assert "sharded ckpt resume parity ok" in r[1]
        assert "sharded eval parity ok (V=5 videos, mesh 2x2, tp=True" in r[2]
        assert "long-video frame-sharding parity ok (F=7 frames" in r[3]
