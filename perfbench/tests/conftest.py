"""Shared fixtures of the benchmark's tests: cells cut to a size the CPU
runs in seconds (the port's plain float32 path), and the repository root on
sys.path."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TEST_BACKBONE = "convnext_bench_test"
TEST_SIZES = dict(backbone=TEST_BACKBONE, dims=[8, 16, 32, 64], depths=[1, 1, 2, 1],
                  img_size=64, latent_dims=1024, backbone_classes=16, dtype="float32")


def shrink(cell: dict) -> dict:
    """The cell at the test size: widths and depths cut, 64 px, float32."""
    cell = copy.deepcopy(cell)
    cell["config"].update(TEST_SIZES)
    mix = cell["traffic"]
    for key, small in (("pool_batches", 3), ("uploads", 6), ("batch", 4)):
        if key in mix:
            mix[key] = small
    mix["trace_seconds"] = 0.5
    return cell


@pytest.fixture
def small_cell(monkeypatch):
    """load(name) -> the cell at the test size, its backbone registered with
    the port for this test."""
    from genconvit_tpu_torch.models import convnext

    monkeypatch.setitem(convnext.CONVNEXT_CFGS, TEST_BACKBONE,
                        dict(depths=tuple(TEST_SIZES["depths"]), dims=tuple(TEST_SIZES["dims"])))
    from perfbench.core import registry

    return lambda name: shrink(registry.cell(name))


@pytest.fixture
def cuda():
    """The card, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
