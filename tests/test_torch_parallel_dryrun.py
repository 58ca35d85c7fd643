"""The port's data-parallel dry run (`python -m genconvit_tpu_torch.parallel.
dryrun N`) runs on the card unless asked: without CUDA the default raises
before any rank starts, and `--device cpu` hands the CPU to every rank.
The run itself (convnext_tiny in every rank) is the card's and the CLI's:
`chip_smoke.py`'s phase 16 drives the same functions on the card, and
tests/test_torch_parallel*.py hold them against JAX at a small size."""

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
    assert spawned == [(dryrun._dryrun_rank, 3, ("cpu",))]
