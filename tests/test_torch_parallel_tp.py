"""The port's tensor parallelism (genconvit_tpu_torch/parallel/mesh.py's split
table and placement, ops/collective.py's Megatron collectives, the split
models, eval_shard's TP path, the DP+TP step and its sharded resume) on the
CPU: four gloo ranks on a 2x2 ('data', 'model') mesh, spawned once for the
module (tests/torch_parallel_ranks.py `tp_rank`), against the JAX
package's predict_sharded(tensor_parallel=True) and make_train_step on
TP-sharded params over `make_mesh(data=2, model=2)` of the conftest's
virtual devices, and against the port's unsplit forward. Small models:
ConvNeXt depths (1,1,1,1), dims (8..64), 64 px, backbone classes 16 (the
port splits evenly: 10 would leave the heads' 5 columns to two ranks),
deterministic VAE. Bounds: y equal; y_val within 1e-5 of JAX
(tests/test_torch_engine.py's) and within 1e-6 of the unsplit port; the
step within tests/test_torch_parallel_train.py's float32 bounds, its raw
gradients against JAX's (from Adam's first moment) within 1e-5 relative L2
for each group of split parameters; the resume's loss within rtol 1e-6.
Planted faults that must miss those bounds: a SwiGLU fc split contiguously
(all of a on one rank, all of b on the other), fc2's bias added on every
rank, all_reduce_sum in place of reduce_from_model.

The JAX package's own DP+TP step is wrong in one place: on a mesh with
model = 2 its gradient of every depthwise conv weight is twice its
one-device step's (GSPMD's partitioning of the grouped convolution's
weight gradient sums it over 'model'; its bias is right). The step is
held against it everywhere else; the depthwise weights are held against
the port's one-process step (itself held against JAX's one-device step
by tests/test_torch_train.py), and the JAX step's doubling is asserted, so
that a change on either side shows."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.tree_util import DictKey

from genconvit_tpu.config import Config as JaxConfig
from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint
from genconvit_tpu.infer.engine import Predictor as JaxPredictor
from genconvit_tpu.parallel import eval_shard as jax_shard
from genconvit_tpu.parallel.mesh import _tp_spec_for_path
from genconvit_tpu.parallel.mesh import make_mesh as jax_mesh
from genconvit_tpu.parallel.mesh import shard_batch as jax_shard_batch
from genconvit_tpu.parallel.mesh import shard_params as jax_shard_params
from genconvit_tpu.train.loop import make_train_step as jax_train_step
from genconvit_tpu.train.optim import make_optimizer as jax_optimizer

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.checkpoint import load_checkpoint, restore_opt_state
from genconvit_tpu_torch.core.convert import state_dict_from_jax, tree_from_state_dict
from genconvit_tpu_torch.models.convnext import Block
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.models.init import init_genconvit_
from genconvit_tpu_torch.parallel.dryrun import Ranks
from genconvit_tpu_torch.parallel.mesh import (COLUMN, ROW, gather_state_dict, split_state_dict,
                                               tp_rule, tp_splits)
from genconvit_tpu_torch.train import loop, optim

from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel_train import _misses
from tests.test_torch_train import _record, _rel
from tests.test_torch_util import (IMG, SMALL_NAME, ed_state_dict, jax_trees,
                                   small_backbone_registered, vae_state_dict)

WORLD = 4
V, F = 5, 3
N = 8
CLASSES = ranks.TP_CLASSES
LATENT = ranks.LATENT
CASES = [c for c, _, _ in ranks.TP_CASES]
# the groups of split parameters, by their names in a branch
_SPLIT_GROUPS = {"mlp.fc1": lambda k: ".mlp.fc1." in k,
                 "mlp.fc2": lambda k: k.endswith(".mlp.fc2.weight"),
                 "backbone head.fc": lambda k: ".head.fc." in k,
                 "branch fc": lambda k: k.startswith("fc."),
                 "branch fc2": lambda k: k == "fc2.weight",
                 "latent heads": lambda k: k.startswith(("encoder.mu.", "encoder.var."))}


def _port_config(variant="original"):
    return Config(model=ModelConfig(backbone=SMALL_NAME, latent_dims=LATENT,
                                    vae_variant=variant), img_size=IMG)


def _port_model(seed, head_act="default", variant="original", net="genconvit"):
    """A seeded small GenConViT of the port's init, layer scale U(0.1, 1)."""
    with small_backbone_registered():
        model = GenConViT(_port_config(variant), net, CLASSES, head_act)
    init_genconvit_(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Block):
                m.gamma.copy_(torch.from_numpy(rng.uniform(0.1, 1.0, m.gamma.shape)
                                               .astype(np.float32)))
    return model


def _scaled(trees, by=10.0):
    """Both heads' last layer scaled, for decisive verdicts (as
    tests/test_torch_parallel.py scales them)."""
    out = {b: dict(t) for b, t in trees.items()}
    for b in out:
        out[b]["fc2"] = {k: np.asarray(v) * by for k, v in out[b]["fc2"].items()}
    return out


def _eps(key, n):
    return np.array(jax.random.normal(key, (n, LATENT), jnp.float32), np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, each rank's results of tp_rank, JAX's results)."""
    tmp = tmp_path_factory.mktemp("parallel_tp")
    rng = np.random.default_rng(0)
    train = jax_trees(ed_state_dict(0, rng, CLASSES), vae_state_dict(1, rng, CLASSES))
    swiglu = _port_model(2, head_act="swiglu")
    updated = _port_model(3, variant="updated", net="vae")
    trees = {"default": _scaled(train),
             "swiglu": _scaled({b: tree_from_state_dict(m.state_dict(), b)
                                for b, m in loop.branches(swiglu).items()}),
             "updated": _scaled({"vae": tree_from_state_dict(updated.vae.state_dict(), "vae")}),
             "train": train}
    keys = list(jax.random.split(jax.random.PRNGKey(5), 2))
    imgs = rng.integers(0, 256, (N, IMG, IMG, 3), np.uint8)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    masks = np.ones((V, F), np.float32)
    masks[1, 2:] = 0
    masks[3, 1:] = 0
    d = {"sds": {w: {b: {k: v.numpy() for k, v in state_dict_from_jax(t, b).items()}
                     for b, t in ts.items()} for w, ts in trees.items()},
         "faces": rng.integers(0, 256, (V, F, IMG, IMG, 3), np.uint8), "masks": masks,
         "batch": (imgs, labels, _eps(keys[0], N)), "batch2": (imgs, labels, _eps(keys[1], N))}
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(d))
    job = Ranks(ranks.tp_rank, WORLD, str(inputs), str(tmp))

    # JAX on a 2x2 mesh of the conftest's virtual devices, meanwhile
    mesh = jax_mesh(data=2, model=2, devices=jax.devices()[:WORLD])
    jcfg = JaxConfig()
    jcfg.img_size = IMG
    jcfg.model.latent_dims = jcfg.derived_latent_dims()
    want = {}
    for case, net, weights in ranks.TP_CASES:
        params = {b: trees[weights][b] for b in ("ed", "vae") if net in (b, "genconvit")}
        jp = JaxPredictor(jcfg, net=net, params=params, deterministic_vae=True,
                          face_backend="fullframe")
        want[case] = jax_shard.predict_sharded(jp, d["faces"], masks, mesh, tensor_parallel=True)
    params = jax_shard_params({b: jax.tree_util.tree_map(jnp.asarray, train[b])
                               for b in ("ed", "vae")}, mesh, tensor_parallel=True)
    tx = jax_optimizer(ranks.LR, ranks.WD)
    state = tx.init(params)
    p0 = jax.tree_util.tree_map(np.asarray, params)
    step = jax_train_step("genconvit", tx, False, donate=False)
    params, state, loss, acc = step(params, state, jax_shard_batch(imgs, mesh),
                                    jax_shard_batch(labels, mesh), keys[0])
    adam = state.inner_state[1]
    mu1 = jax.tree_util.tree_map(np.array, adam.mu)
    want["step_no_dw"] = _record(*(_dw_zeroed(jax.tree_util.tree_map(np.asarray, t))
                                   for t in (params, mu1, adam.mu, adam.nu)),
                                 int(adam.count), _dw_zeroed(p0), [float(loss)], [float(acc)])
    # JAX's gradient of each parameter by the port's names: mu1 = (1 - b1)(g + wd p)
    want["grads"] = {b: {k: v.numpy() / (1 - optim.BETAS[0])
                         - ranks.WD * state_dict_from_jax(p0[b], b)[k].numpy()
                         for k, v in state_dict_from_jax(mu1[b], b).items()}
                     for b in ("ed", "vae")}
    return d, job.join(timeout=300), want


# ------------------------------------------------------------------ the table


def _kind(spec, ndim):
    """COLUMN, ROW or None of a JAX PartitionSpec (on the flax [in, out]
    layout: P(None, 'model') and P('model') cut the output features)."""
    if spec == jax.sharding.PartitionSpec():
        return None
    if ndim == 2:
        return COLUMN if spec == jax.sharding.PartitionSpec(None, "model") else ROW
    return COLUMN


def _markers(sd):
    """Each float tensor of a state dict filled with its own index + 1."""
    return {k: torch.full_like(v, float(i + 1)) if v.is_floating_point() else v
            for i, (k, v) in enumerate(sd.items())}


@pytest.mark.parametrize("variant", ["default", "swiglu", "updated"])
def test_split_table_matches_jax_name_for_name(variant):
    """Every tensor of the port's state dicts: tp_rule's split equals
    `_tp_spec_for_path`'s for the same tensor in the JAX package's tree
    (converted by the JAX package's own converters, each tensor traced by
    a marker value)."""
    model = (_port_model(0, head_act="swiglu") if variant == "swiglu" else
             _port_model(0, variant="updated", net="vae") if variant == "updated" else
             _port_model(0))
    checked = 0
    for b, m in loop.branches(model).items():
        sd = _markers(m.state_dict())
        numpy_sd = {k: v.numpy() for k, v in sd.items()}
        tree = (jax_convert.convert_ed(numpy_sd, carry_dead_params=False) if b == "ed" else
                jax_convert.convert_vae_updated(numpy_sd, carry_dead_params=False)
                if variant == "updated" else
                jax_convert.convert_vae(numpy_sd, carry_dead_params=False))
        names = {float(i + 1): k for i, k in enumerate(sd)}
        seen = {}

        def visit(path, leaf):
            arr = np.asarray(leaf)
            vals = np.unique(arr)
            assert len(vals) == 1, path
            seen[names[float(vals[0])]] = _kind(
                _tp_spec_for_path((DictKey(b),) + path, arr), arr.ndim)

        jax.tree_util.tree_map_with_path(visit, tree)
        for k, v in sd.items():
            if not v.is_floating_point():
                continue
            assert k in seen, k
            assert tp_rule(f"{b}.{k}", v.dim()) == seen[k], (b, k)
            checked += 1
    assert checked > 40
    # the int8 latent heads: the port's wq/scale/bias, JAX's mu_hwc_q
    for head in ("mu", "var"):
        for leaf, nd in (("wq", 2), ("scale", 1), ("bias", 1)):
            path = tuple(DictKey(k) for k in ("vae", "encoder", f"{head}_hwc_q", leaf))
            want = _kind(_tp_spec_for_path(path, np.zeros((4,) * nd)), nd)
            assert tp_rule(f"vae.encoder.{head}.{leaf}", nd) == want == COLUMN


@pytest.mark.parametrize("size", [2, 4])
def test_split_then_gather_state_dict_is_bit_exact(size):
    for model in (_port_model(1), _port_model(1, head_act="swiglu")):
        for b, m in loop.branches(model).items():
            sd = m.state_dict()
            shards = [split_state_dict(sd, i, size) for i in range(size)]
            back = gather_state_dict(shards)
            assert back.keys() == sd.keys()
            for k in sd:
                assert torch.equal(back[k], sd[k]), k
            splits = tp_splits({k: tuple(v.shape) for k, v in sd.items()})
            assert splits["backbone.stages.0.blocks.0.mlp.fc1.weight" if b == "ed" else
                          "convnext_backbone.stages.0.blocks.0.mlp.fc2.weight"][0] in (COLUMN, ROW)
            if m.head_act == "swiglu":   # each rank holds a_r | b_r
                h = sd["fc.weight"].shape[0] // 2
                a, bb = sd["fc.weight"][:h], sd["fc.weight"][h:]
                k = h // size
                for i, s in enumerate(shards):
                    assert torch.equal(s["fc.weight"], torch.cat([a[i * k:(i + 1) * k],
                                                                  bb[i * k:(i + 1) * k]]))
    with pytest.raises(ValueError, match="splits evenly"):
        split_state_dict({"fc.weight": torch.zeros(10, 4)}, 0, 4)


@pytest.mark.parametrize("pallas,gelu,path", [
    ("", "default", "plain"), ("0", "default", "plain"), ("mlpfull", "default", "kernels"),
    ("mlp:0,1", "default", "mlp"), ("mlp", "default", "mlp"), ("1", "default", "1"),
    ("stage", "default", "stage"), ("mlpfull", "exact", "plain")])
def test_split_backbone_path_is_the_jax_packages_multi_device_rule(pallas, gelu, path):
    """On more than one device the JAX package takes the kernel backbone
    for pallas '' no more (`convnext_features`: only on one device or in
    the shard_map scope); 'mlpfull', 'mlp...', '1' and 'stage' keep their
    kernels; in one process pallas '' keeps them."""
    from types import SimpleNamespace

    from genconvit_tpu_torch.models.convnext import backbone_path
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    cuda16 = SimpleNamespace(dtype=torch.bfloat16, is_cuda=True)
    plan = KernelPlan(pallas=pallas, gelu=gelu)
    assert backbone_path(cuda16, plan, tp=True) == path
    if pallas == "":
        assert backbone_path(cuda16, plan) == "kernels"


# ------------------------------------------------------------------ eval


@pytest.mark.parametrize("case", CASES)
def test_predict_sharded_tp_matches_jax_and_the_unsplit_port(runs, case):
    _, got, want = runs
    y_j, v_j = (np.asarray(a) for a in want[case])
    for r in got:
        y, y_val = r[case]["tp"]
        y_u, v_u = r[case]["unsplit"]
        assert y.shape == y_val.shape == (V,)
        np.testing.assert_array_equal(y, y_j)
        np.testing.assert_allclose(y_val, v_j, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(y, y_u)
        np.testing.assert_allclose(y_val, v_u, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(y_val, got[0][case]["tp"][1])
        # the predictor's model stays whole; its cached copy holds a block
        (whole_tp, whole_rows), (copy_tp, copy_rows) = r[case]["fc_rows"]
        assert not whole_tp and copy_tp and copy_rows * 2 == whole_rows
    assert len(set(v_j.tolist())) == V, "every video's verdict its own"


@pytest.mark.parametrize("fault", ["planted_swiglu", "planted_bias"])
def test_planted_eval_faults_are_caught(runs, fault):
    """A SwiGLU fc split contiguously; fc2's bias added on every rank."""
    _, got, _ = runs
    case = "swiglu" if fault == "planted_swiglu" else "genconvit"
    for r in got:
        assert not np.allclose(r[fault][1], r[case]["unsplit"][1], rtol=0, atol=1e-6)


# ------------------------------------------------------------------ training


def _group_errors(grads, want):
    """Relative L2 of each group of split parameters' gradients, by branch."""
    out = {}
    for b in ("ed", "vae"):
        keys = list(grads[b])
        for name, member in _SPLIT_GROUPS.items():
            sel = [k for k in keys if member(k)]
            assert all(tp_rule(k, grads[b][k].ndim) is not None for k in sel), sel
            if sel:
                out[f"{b} {name}"] = _rel(np.concatenate([grads[b][k].ravel() for k in sel]),
                                          np.concatenate([want[b][k].ravel() for k in sel]))
    return out


def _dw_zeroed(tree):
    """The tree with every depthwise conv weight zeroed."""
    if isinstance(tree, dict):
        return {k: ({**v, "kernel": np.zeros_like(np.asarray(v["kernel"]))}
                    if k == "conv_dw" else _dw_zeroed(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_dw_zeroed(v) for v in tree]
    return tree


def _is_dw(k):
    return k.endswith("conv_dw.weight")


def test_dp_tp_step_matches_the_jax_tp_step(runs):
    """Everything but the depthwise conv weights against JAX's DP+TP step
    (module docstring): loss, accuracy, every branch's gradient from Adam's
    first moment, parameter change, moments, BatchNorm statistics; the raw
    gradients of each group of split parameters."""
    _, got, want = runs
    rec = got[0]["dp_tp"]
    port = _record(*(_dw_zeroed(t) for t in (rec["last"]["params"], rec["first"]["mu"],
                                               rec["last"]["mu"], rec["last"]["nu"])),
                   rec["last"]["count"], _dw_zeroed(rec["p0"]), rec["loss"], rec["acc"])
    assert _misses(port, want["step_no_dw"]) == []
    errs = _group_errors(rec["grads"], want["grads"])
    assert len(errs) == 2 * 6 - 1, errs   # the ED has no latent heads
    assert all(e < 1e-5 for e in errs.values()), errs


def test_depthwise_gradients_and_the_jax_tp_steps_doubling(runs):
    _, got, want = runs
    grads, one = got[0]["dp_tp"]["grads"], got[1]["one_grads"]
    for b in ("ed", "vae"):
        dw = [k for k in grads[b] if _is_dw(k)]
        assert len(dw) == 4
        flat = np.concatenate([grads[b][k].ravel() for k in dw])
        assert _rel(flat, np.concatenate([one[b][k].ravel() for k in dw])) < 1e-5
        jax_dw = np.concatenate([want["grads"][b][k].ravel() for k in dw])
        assert _rel(jax_dw, 2 * flat) < 1e-5


def test_reduce_with_a_summed_gradient_is_caught(runs):
    """all_reduce_sum in place of reduce_from_model: the forward is the
    same, the gradients upstream of every row split are not."""
    _, got, want = runs
    planted = got[0]["planted_reduce"]
    assert planted["loss"] == got[0]["loss"]
    errs = _group_errors(planted["grads"], want["grads"])
    assert max(errs.values()) > 1e-3, errs


def test_dp_tp_ranks_agree(runs):
    """The replicated tensors bit-equal on every rank after the step; the
    blocks equal along 'data' and different along 'model'; one loss."""
    _, got, _ = runs
    assert [r["mesh"] for r in got] == [(2, 2)] * WORLD
    assert [(r["data_index"], r["model_index"]) for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({r["digests"][0] for r in got}) == 1
    blocks = {}
    for r in got:
        blocks.setdefault(r["model_index"], set()).add(r["digests"][1])
    assert all(len(s) == 1 for s in blocks.values()) and blocks[0] != blocks[1]
    assert len({r["loss"] for r in got}) == 1


def test_sharded_resume_and_the_file_in_both_packages(runs):
    """The gathered `.gcv`: a restore split again takes the continuing run's
    next step (rtol 1e-6); the JAX package reads the weights of the first
    step; a one-process port run restores it and takes the same next step
    (the float32 step bound)."""
    d, got, _ = runs
    for r in got:
        cont, restored = r["resume"]
        np.testing.assert_allclose(restored, cont, rtol=1e-6)
    saved = jax_load_checkpoint(got[0]["saved"])
    first = got[0]["dp_tp"]["first"]["params"]
    flat_j = jax.tree_util.tree_leaves(saved["params"])
    flat_p = jax.tree_util.tree_leaves(first)
    assert len(flat_j) == len(flat_p)
    for a, b in zip(flat_j, flat_p):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    payload = load_checkpoint(got[0]["saved"])
    with small_backbone_registered():
        model = GenConViT(_port_config(), "genconvit", CLASSES)
    for b, m in loop.branches(model).items():
        m.load_state_dict(state_dict_from_jax(payload["params"][b], b))
    model = model.to(memory_format=torch.channels_last)
    opt = optim.make_optimizer(model.parameters(), ranks.LR, ranks.WD)
    restore_opt_state(opt, loop.branches(model), payload["opt_state"])
    x, y, e = (torch.from_numpy(a) for a in d["batch2"])
    loss = float(loop.make_train_step(model, "genconvit", opt)(x, y.long(), e)[0])
    np.testing.assert_allclose(loss, got[0]["resume"][0], rtol=1e-5)
