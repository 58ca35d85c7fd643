"""The generator is reproducible from the seed and gives every seed the same
work; the operation and byte counters agree with hand counts and with
torch's own FLOP counter at a small shape."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core import registry
from perfbench.core import traffic as tg
from perfbench.metrics import _flops
from perfbench.reference import model as ref
from perfbench.reference.init import make_state_dicts
from perfbench.tests.conftest import TEST_SIZES

CPU = torch.device("cpu")


def _cfg():
    cfg = registry.load("configs", "genconvit_tiny")
    cfg.update(TEST_SIZES)
    return cfg


def test_score_pool_reproducible():
    mix = dict(registry.load("traffic", "score_v8"), pool_batches=2)
    cfg = _cfg()
    a, b = tg.score_pool(mix, cfg, 2**31 + 5, CPU), tg.score_pool(mix, cfg, 2**31 + 5, CPU)
    c = tg.score_pool(mix, cfg, 6, CPU)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert not np.array_equal(a[0][0], c[0][0])
    # the same number of frames off for every seed, none a video's whole stack
    for pool in (a, c):
        masks = np.stack([m for _, m in pool])
        assert int((masks == 0).sum()) == int(round(0.1 * masks.size))
        assert (masks.sum(-1) >= 1).all()


def test_serve_schedule_same_work_every_seed():
    mix = registry.load("traffic", "serve_poisson")
    cfg = _cfg()
    d1, f1, w1 = tg.serve_schedule(mix, cfg, 100.0, 10.0, 1)
    d1b, f1b, w1b = tg.serve_schedule(mix, cfg, 100.0, 10.0, 1)
    d2, f2, w2 = tg.serve_schedule(mix, cfg, 100.0, 10.0, 2**33 + 1)
    assert np.array_equal(d1, d1b) and np.array_equal(f1, f1b) and np.array_equal(w1, w1b)
    assert len(d1) == len(d2) == 1000
    assert not np.array_equal(d1, d2)
    assert sorted(f1) == sorted(f2)
    assert (f1 == 15).mean() == 0.8 and f1.min() >= 1
    assert abs(d1[-1] - 10.0) < 0.1
    # the same count in every second's block of arrivals
    for d in (d1, d2):
        assert abs(d[100] - d[0] - 1.0) < 0.1 and abs(d[600] - d[500] - 1.0) < 0.1


def test_exponential_gaps_are_one_set():
    g1, g2 = tg.exponential_gaps(500, 50.0, 3), tg.exponential_gaps(500, 50.0, 4)
    assert np.array_equal(np.sort(g1), np.sort(g2)) and not np.array_equal(g1, g2)
    assert np.array_equal(np.sort(g1[:50]), np.sort(g2[:50]))
    assert abs(g1.mean() - 1 / 50.0) < 1e-3


def test_on_off_arrivals():
    """burst_on_s / burst_off_s: the same mean rate, no arrival in an off
    phase, the same gaps for every seed."""
    mix = dict(registry.load("traffic", "serve_poisson"), burst_on_s=0.5, burst_off_s=1.5)
    cfg = _cfg()
    d1, f1, _ = tg.serve_schedule(mix, cfg, 100.0, 10.0, 1)
    d2, f2, _ = tg.serve_schedule(mix, cfg, 100.0, 10.0, 2**33 + 1)
    assert len(d1) == len(d2) == 1000 and sorted(f1) == sorted(f2)
    for d in (d1, d2):
        assert (np.mod(d, 2.0) < 0.5).all()
        assert 8.0 < d[-1] <= 8.5    # the last of five 2 s periods' on phases
    for d in (d1, d2):   # the off phases taken out: 2.5 s of Poisson at 400 a second
        on = d - np.floor(d / 2.0) * 1.5
        assert (np.diff(on) >= 0).all() and 2.4 < on[-1] < 2.5
    plain = tg.serve_schedule(registry.load("traffic", "serve_poisson"), cfg, 100.0, 10.0, 1)[0]
    assert np.array_equal(tg.arrivals(1000, 100.0, 1), plain)


def test_train_pool_reproducible():
    mix = dict(registry.load("traffic", "train_b32"), pool_batches=2, batch=4)
    a, b = tg.train_pool(mix, _cfg(), 9, CPU), tg.train_pool(mix, _cfg(), 9, CPU)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert (a[1].sum(1) == 2).all()


def test_derive_takes_large_seeds():
    assert tg.derive(2**31 + 3, "x") != tg.derive(3, "x")
    assert 0 <= tg.derive(2**40, "weights") < 2**63


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def test_flops_match_torch_counter():
    cfg = _cfg()
    sds = {b: {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
           for b, sd in make_state_dicts(cfg, 1, CPU).items()}
    x = torch.randn(2, 3, cfg["img_size"], cfg["img_size"])
    assert _counted(lambda: ref.ed_logits(sds["ed"], x, cfg)) == _flops.ed(cfg, 2)
    eps = torch.randn(2, cfg["latent_dims"])
    assert _counted(lambda: ref.vae_logits(sds["vae"], x, cfg, eps)) == _flops.vae(cfg, 2)
    half = torch.randn(3, 3, 32, 32)
    assert _counted(lambda: ref.convnext(sds["ed"], "backbone.", half, cfg["depths"])) == \
        _flops.convnext(cfg, 3, 32)


def test_flops_by_hand():
    cfg = dict(_cfg(), dims=[8, 16, 32, 64], depths=[1, 1, 1, 1], img_size=64,
               backbone_classes=16)
    # stem 4x4/4: 16x16 out; blocks: dw 7x7 and two 4x products; downsample 2x2/2
    n = 1
    hand = 2 * 16 * 16 * 8 * 3 * 16
    for s, (c, h) in enumerate(zip((8, 16, 32, 64), (16, 8, 4, 2))):
        if s:
            hand += 2 * h * h * c * (c // 2) * 4
        hand += 2 * h * h * c * 49 + 2 * (2 * h * h * c * 4 * c)
    hand += 2 * 64 * 16
    assert _flops.convnext(cfg, n, 64) == hand
    # one K1 launch: 16 R C^2 operations; bytes 3 R C 2 + 4 C^2 2 + vectors
    t, what = _flops.k1_bound_s(rows=120 * 56 * 56, c=96, post=False)
    ops = 16 * 120 * 56 * 56 * 96 * 96 / 989e12
    nbytes = (3 * 120 * 56 * 56 * 96 * 2 + 2 * 96 * 384 * 2 + 4 * (2 * 384 + 2 * 96)) / 3.35e12
    assert t == max(ops, nbytes) and what == ("bytes" if nbytes >= ops else "operations")
    launches = _flops.k1_launches(registry.load("configs", "genconvit_tiny"), 120)
    assert len(launches) == 54 and launches[0] == (240 * 56 * 56, 96, False)
    assert launches[2] == (240 * 56 * 56, 96, True) and launches[-1] == (120 * 3 * 3, 768, False)


def test_published_sizes():
    """convnext_tiny at 224 px is 4.47 G multiply-adds an image (timm's count)."""
    cfg = registry.load("configs", "genconvit_tiny")
    macs = (_flops.convnext(cfg, 1, 224)) / 2
    assert 4.4e9 < macs < 4.55e9
    large = registry.load("configs", "genconvit_large")
    assert 34.0e9 < _flops.convnext(large, 1, 224) / 2 < 34.6e9
