"""GenConViT's ED branch on a Swin backbone (the port's `GenConViT(net="ed")`
with config.model.backbone a SWIN_CFGS name) on the CPU, against the
benchmark's plain reference (`perfbench/reference/swin.py`, float32, its
weights from `perfbench/reference/init_swin.py`): the backbone's features
and the ED's per-video means; the Swin's K1/K2 wiring (the plain versions
of the kernels, which the wrappers run on CPU tensors) against the plain
graph; K1's and K2's plain versions at Swin's eps 1e-5 against
F.layer_norm-based math, on rows whose variance is near 1e-5, where 1e-6
reads otherwise; the refusals (the VAE on a Swin, training, ConvNeXt-only
plans, tensor parallelism); the converter's Swin ED; the benchmark's new
cell, its files, its driver at the test size and `_flops_swin` against a
hand count; the ordered route's 64-bit generation.

The small Swin: embed 32, depths (2, 2, 2, 1), heads (1, 2, 4, 8), window 4,
128 px (grids 32, 16, 8, 4: shifted blocks in the first three stages, none
in the last, whose grid is the window, as swin_large's is at 224 px), 16
backbone classes."""

import copy
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core import convert
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.models import swin as port_swin
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.ops.act import gelu_rational_f32
from genconvit_tpu_torch.ops.cuda import convnext_mlp as km
from genconvit_tpu_torch.ops.collective import ModelAxis
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.parallel.mesh import split_module
from genconvit_tpu_torch.train import loop

from perfbench.core import registry
from perfbench.metrics import _flops_swin
from perfbench.reference import swin as ref
from perfbench.reference.init_swin import make_state_dicts

NAME = "swin_ed_test"
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 1), num_heads=(1, 2, 4, 8), window=4)
PX = 128
CLASSES = 16
EXACT = KernelPlan(gelu="exact")   # the reference's erf GELU
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(frames=3):
    """The benchmark configuration cut to the small Swin."""
    cfg = copy.deepcopy(registry.load("configs", "genconvit_ed_swin_large"))
    cfg.update(backbone=NAME, embed_dim=SMALL["embed_dim"], depths=list(SMALL["depths"]),
               num_heads=list(SMALL["num_heads"]), window_size=SMALL["window"], img_size=PX,
               num_frames=frames, backbone_classes=CLASSES, dtype="float32")
    return cfg


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(port_swin.SWIN_CFGS, NAME, SMALL)
    return _cfg()


def _config():
    return Config(img_size=PX, model=ModelConfig(backbone=NAME))


def _model(sd):
    m = GenConViT(_config(), "ed", CLASSES)
    m.ed.load_state_dict(sd, strict=True)
    return m.eval()


def _frames(seed, v, f):
    g = np.random.default_rng(seed)
    frames = g.integers(0, 256, (v, f, PX, PX, 3), dtype=np.uint8)
    mask = np.ones((v, f), np.float32)
    mask[0, 1:] = 0.0
    return frames, mask


def test_ed_on_swin_matches_the_reference(small):
    sd = make_state_dicts(small, 3, "cpu")["ed"]
    model = _model(sd)
    frames, mask = _frames(0, 2, 3)
    x = ref.normalize(torch.from_numpy(frames).reshape(-1, PX, PX, 3))
    with torch.no_grad():
        got = model.ed.backbone.features(x, EXACT)
        want = ref.swin_features(sd, "backbone.", x, small)
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(model(x, EXACT), ref.ed_logits(sd, x, small), **TOL)
    pred = Predictor(_config(), net="ed", device="cpu", params={"ed": sd}, kernel_plan=EXACT,
                     face_backend="fullframe", backbone_classes=CLASSES)
    (y, y_val), = pred.predict_videos_stream([(frames, mask)])
    means = ref.video_means({"ed": sd}, torch.from_numpy(frames), torch.from_numpy(mask), small)
    ry, rval = (np.asarray(a) for a in _verdicts(means.numpy()))
    assert (y == ry).all()
    np.testing.assert_allclose(y_val, rval, rtol=1e-4, atol=1e-5)


def _verdicts(means):
    from perfbench.core.compare import verdicts

    return verdicts(means)


def test_swin_kernel_wiring_matches_the_plain_graph(small, monkeypatch):
    """K1 on every MLP half and K2 on every other LayerNorm (their plain
    versions on the CPU, in float32: y and h unrounded) against the plain
    graph: the folds (LN2's affine into fc1, a unit layer scale) and Swin's
    eps."""
    sd = make_state_dicts(small, 5, "cpu")["ed"]
    bb = _model(sd).ed.backbone
    x = ref.normalize(torch.from_numpy(_frames(1, 2, 2)[0]).reshape(-1, PX, PX, 3))
    with torch.no_grad():
        plain = bb.features(x)
        bb.prepare_kernels(KernelPlan())
        assert bb.features(x).equal(plain)     # a CPU input takes the plain path
        k1, k2 = km.ln_mlp_residual.launches, km.layer_norm_rows.launches
        monkeypatch.setattr(port_swin, "kernel_stages",
                            lambda t, plan, n: (frozenset(range(n)), True))
        wired = bb.features(x)
        assert (km.ln_mlp_residual.launches, km.layer_norm_rows.launches) == (k1, k2)
    # K1 and K2 take var = E[x^2] - mean^2, the plain graph two passes
    torch.testing.assert_close(wired, plain, rtol=1e-3, atol=1e-3)
    assert not wired.equal(plain)


def _rows_near_eps(n, c, seed):
    """Rows of variance near 1e-5, so that eps 1e-5 against 1e-6 moves
    rsqrt(var + eps) by a quarter or more."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.rand(n, 1, generator=g) * 4e-3 + 1e-3
    return torch.randn(n, c, generator=g) * scale + 1e-3 * torch.randn(n, 1, generator=g)


def test_k1_plain_at_swin_eps_matches_layer_norm_math():
    c = 64
    g = torch.Generator().manual_seed(2)
    w, b = 1 + 0.2 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w1, b1 = torch.randn(4 * c, c, generator=g) / 8, 0.05 * torch.randn(4 * c, generator=g)
    w2, b2 = torch.randn(c, 4 * c, generator=g) / 16, 0.05 * torch.randn(c, generator=g)
    fold = km.fold_block_mlp(w, b, w1, b1, w2, b2, torch.ones(c), torch.float32)
    x = _rows_near_eps(300, c, 3)
    want = x + F.linear(gelu_rational_f32(F.linear(F.layer_norm(x, (c,), w, b, 1e-5), w1, b1)),
                        w2, b2)
    got = km.ln_mlp_residual(x, x, fold, None, "default", 1e-5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    wrong = km.ln_mlp_residual(x, x, fold, None, "default", 1e-6)   # ConvNeXt's eps
    assert (wrong - want).abs().max() > 1e-2


def test_k2_plain_at_swin_eps_matches_layer_norm():
    c = 96
    g = torch.Generator().manual_seed(4)
    w, b = 1 + 0.2 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    x = _rows_near_eps(200, c, 5)
    want = F.layer_norm(x, (c,), w, b, 1e-5)
    torch.testing.assert_close(km.layer_norm_rows(x, w, b, 1e-5), want, rtol=1e-4, atol=1e-4)
    assert (km.layer_norm_rows(x, w, b) - want).abs().max() > 1e-1   # the default, 1e-6


@pytest.mark.parametrize("net", ["vae", "genconvit"])
def test_vae_on_a_swin_is_refused(small, net):
    with pytest.raises(ValueError, match="only the ED branch runs on a Swin"):
        GenConViT(_config(), net, CLASSES)


@pytest.mark.parametrize("plan", [dict(pallas="1"), dict(pallas="stage"),
                                  dict(int8_mlp="fc1"), dict(dw_rank=1)])
def test_convnext_only_plans_are_refused(small, plan):
    with pytest.raises(ValueError, match="ConvNeXt-only kernels"):
        Predictor(_config(), net="ed", device="cpu", kernel_plan=KernelPlan(**plan),
                  face_backend="fullframe", backbone_classes=CLASSES)


def test_training_a_swin_is_refused(small):
    model = GenConViT(_config(), "ed", CLASSES)
    opt = torch.optim.Adam(model.parameters())
    images, labels = torch.zeros(2, PX, PX, 3, dtype=torch.uint8), torch.tensor([0, 1])
    with pytest.raises(ValueError, match="K7"):
        loop.make_train_step(model, "ed", opt)(images, labels)
    with pytest.raises(ValueError, match="K7"):
        loop.make_eval_step(model, "ed")(images, labels)
    with pytest.raises(ValueError, match="K7"):
        loop.train_model("/nonexistent", "ed", config=_config(), device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        model(torch.zeros(1, 3, PX, PX), train=True)


def test_tensor_parallel_swin_is_refused(small):
    """tp_rule would split the Swin blocks' mlp.fc1/fc2, which run whole."""
    model = GenConViT(_config(), "ed", CLASSES)
    fc1 = model.ed.backbone.layers[0].blocks[0].mlp.fc1.weight
    with pytest.raises(ValueError, match="tensor parallelism does not run a Swin"):
        split_module(model, ModelAxis(None, 2, 0), in_place=False)
    with pytest.raises(ValueError, match="tensor parallelism does not run a Swin"):
        split_module(model, ModelAxis(None, 2, 0))
    assert model.ed.backbone.layers[0].blocks[0].mlp.fc1.weight is fc1   # left whole


def test_converter_takes_a_swin_ed(small):
    sd = make_state_dicts(small, 7, "cpu")["ed"]
    tree = convert.tree_from_state_dict(sd, "ed")
    assert "layers" in tree["backbone"]
    back = convert.state_dict_from_jax(tree, "ed")
    assert set(back) == set(sd) and all(back[k].equal(sd[k]) for k in sd)
    # a timm checkpoint: the embedder and timm's buffers dropped, patch_embed kept
    ckpt = dict(sd, **{"embedder.norm.weight": torch.ones(4),
                       "backbone.layers.0.blocks.1.attn_mask": torch.zeros(16, 16, 16),
                       "backbone.layers.0.blocks.0.attn.relative_position_index":
                           torch.zeros(16, 16, dtype=torch.int64)})
    got = convert.state_dict_from_reference({"state_dict": ckpt}, "ed")
    assert set(got) == set(sd)
    assert convert.tree_from_reference(ckpt, "ed", carry_dead_params=False, strict=True)
    _model(got)   # loads strictly


def test_new_cell_loads_by_name():
    cell = registry.cell("swinl_ed_score_v8")
    cfg = cell["config"]
    assert cfg["backbone"] in port_swin.SWIN_CFGS and cfg["reduced"] == []
    pub = port_swin.SWIN_CFGS[cfg["backbone"]]
    assert (cfg["embed_dim"], tuple(cfg["depths"]), tuple(cfg["num_heads"]),
            cfg["window_size"]) == (pub["embed_dim"], pub["depths"], pub["num_heads"],
                                    pub["window"])
    assert cfg["embed_dim"] // cfg["num_heads"][0] == cfg["head_dim"] == 32
    assert registry.module("drivers", cell["traffic"]["driver"]).run
    bench = registry.benchmark()
    w = next(w for w in bench["workloads"] if w["name"] == "swinl_ed_score_v8")
    assert w["chips"] == 1 and w["config"] == "genconvit_ed_swin_large"
    per_layer = {m["name"] for m in registry.cell_metrics(bench, "swinl_ed_score_v8", True)}
    assert per_layer == {"mfu_swin.score", "k1_roofline_swin.score", "k7_roofline.score_swin",
                         "swin_attn_host_ms.score_swin", "device_idle.score_swin",
                         "peak_mem_gib.score_swin", "launch_host_ms.score_swin",
                         "stage_host_ms.score_swin"}
    for name in per_layer:
        assert callable(registry.reader(name).read)
    e2e = {m["name"] for m in registry.cell_metrics(bench, "swinl_ed_score_v8", False)}
    assert "setup_s" in e2e and len(e2e) == 2


def test_flops_swin_against_a_hand_count():
    cfg = dict(_cfg(), num_frames=1)
    n = 2   # one frame: the ED call's two images
    # patch embed 4x4/4 to 32x32x32
    want = 2 * n * 32 * 32 * 32 * 3 * 16
    for h, c, depth, w in ((32, 32, 2, 4), (16, 64, 2, 4), (8, 128, 2, 4), (4, 256, 1, 4)):
        rows = n * h * h
        qkv, attn, proj, mlp = 2 * rows * c * 3 * c, 2 * 2 * rows * w * w * c, 2 * rows * c * c, \
            2 * 2 * rows * c * 4 * c
        want += depth * (qkv + attn + proj + mlp)
        if h > 4:
            want += 2 * n * (h // 2) ** 2 * 4 * c * 2 * c
    want += 2 * n * 256 * CLASSES
    assert _flops_swin.swin(cfg, n, PX) == want
    enc = sum(2 * 1 * (PX >> i) ** 2 * co * ci * 9
              for i, (ci, co) in enumerate(zip((3, 16, 32, 64, 128), (16, 32, 64, 128, 256))))
    dec = sum(2 * 1 * (4 << i) ** 2 * ci * co * 4
              for i, (ci, co) in enumerate(zip((256, 128, 64, 32, 16), (128, 64, 32, 16, 3))))
    head = 2 * 2 * CLASSES * (CLASSES // 2) + 2 * (CLASSES // 2) * 2
    assert math.isclose(_flops_swin.video(cfg), enc + dec + want + head, rel_tol=1e-12)
    assert [r for r, _, _ in _flops_swin.k1_launches(cfg, 1)] == [2048] * 2 + [512] * 2 + \
        [128] * 2 + [32]
    masked = [m for *_, m in _flops_swin.k7_launches(cfg, 1)]
    assert masked == [False, True, False, True, False, True, False]


def test_score_ed_driver_at_the_test_size(small):
    """The cell's driver end to end on the CPU: the Predictor's stream on a
    pool of two batches, then the reference's check of the sample."""
    import time

    from perfbench import run

    cell = registry.cell("swinl_ed_score_v8")
    cell["config"] = small
    cell["traffic"].update(pool_batches=2, videos_per_batch=2, batches_per_call=2,
                           warmup_calls=1)
    cell["workload"]["check_batches"] = 2
    out = run.run_cell(cell, 2 ** 31 + 11, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert out.readings.window["videos"] >= 4 and out.attempted == out.readings.window["videos"]
    # the port's rational GELU against the reference's erf: far under the cell's limits
    assert out.numbers["yval_logit_max"] < 0.01, out.numbers
    assert out.group("void (anonymous namespace)::window_attn_kernel<32, true, 7>()") == \
        "K7 window_attn"
    line = run.result_line(registry.benchmark(), cell, out, False, {"platform": "cpu"})
    assert set(line["metrics"]) == {"videos_per_s", "setup_s"}
    assert json.dumps(line)


def test_ordered_generation_is_64_bit():
    f = km._Flags(4, torch.device("cpu"))
    f.gen = 2 ** 32 - 1
    assert f.next_gen() == 2 ** 32 and f.next_gen() == 2 ** 32 + 1
    f.gen = 2 ** 64 - 1
    assert f.next_gen() == 1   # never 0
