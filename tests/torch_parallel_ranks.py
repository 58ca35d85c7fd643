"""Rank functions for the port's data-parallel tests (this file holds no
tests). Each runs in a process that `genconvit_tpu_torch.parallel.dryrun.
Ranks` spawns as one gloo rank on the CPU with one thread; a spawned
process does not inherit the tests' monkeypatches, so each registers the
small backbone itself. Nothing here imports JAX or the JAX package: the
ranks get their weights and inputs as numpy arrays in a pickle the test
wrote, and return numpy results."""

import copy
import hashlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

# tests/test_torch_util.py's small configuration (that module imports JAX)
SMALL_NAME = "convnext_test"
SMALL_DEPTHS = (1, 1, 1, 1)
SMALL_DIMS = (8, 16, 32, 64)
IMG = 64
BACKBONE_CLASSES = 10
LATENT = 256 * (IMG // 32) ** 2
LR, WD = 1e-4, 1e-4


def _register_small():
    from genconvit_tpu_torch.models import convnext

    convnext.CONVNEXT_CFGS[SMALL_NAME] = dict(depths=SMALL_DEPTHS, dims=SMALL_DIMS)


def _config():
    from genconvit_tpu_torch.config import Config, ModelConfig

    return Config(model=ModelConfig(backbone=SMALL_NAME, latent_dims=LATENT), img_size=IMG,
                  weight_dir="/nonexistent")


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _params(sds, net):
    return {b: {k: torch.from_numpy(v) for k, v in sds[b].items()}
            for b in ("ed", "vae") if net in (b, "genconvit")}


def _digest(module) -> str:
    h = hashlib.sha256()
    for _, t in sorted(module.state_dict().items()):
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ eval


def eval_rank(rank, world, inputs):
    """predict_sharded and predict_long_video on a world x 1 mesh, each
    next to the predictor's own unsharded forward, and the mesh's and the
    broadcast's checks (tests/test_torch_parallel.py)."""
    _register_small()
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel import eval_shard
    from genconvit_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params

    d = _load(inputs)
    out = {}
    broadcasts = []
    real_shard_params = eval_shard.shard_params

    def counted(module, mesh):
        broadcasts.append(id(module))
        return real_shard_params(module, mesh)

    eval_shard.shard_params = counted
    mesh = make_mesh(data=world)
    out["mesh_shape"] = tuple(mesh.mesh.shape)

    def predictor(net, **kw):
        kw.setdefault("params", _params(d["sds"], net))  # None: a random init from the seed
        kw.setdefault("deterministic_vae", True)
        return Predictor(_config(), net=net, device="cpu", kernel_plan=KernelPlan(),
                         backbone_classes=BACKBONE_CLASSES, face_backend="fullframe", **kw)

    for net in ("ed", "genconvit"):
        pred = predictor(net)
        faces, masks = d["faces"], d["masks"]
        frames, fmask = d["frames"], d["fmask"]
        out[net] = {
            "sharded": eval_shard.predict_sharded(pred, faces, masks, mesh),
            "again": eval_shard.predict_sharded(pred, faces, masks, mesh),
            "unsharded": pred.predict_videos_batched(faces, masks),
            "long": eval_shard.predict_long_video(pred, frames, fmask, mesh),
            "long_unsharded": pred.predict_videos_batched(frames[None], fmask[None]),
            "prefix": eval_shard.predict_long_video(pred, frames[:d["prefix"]], None, mesh),
            "broadcasts": broadcasts.count(id(pred.model)),
            "cached": len(pred._sharded_params_cache),
        }
        # the gather's rank order rotated (a planted fault)
        real_gather = eval_shard.gather_blocks
        eval_shard.gather_blocks = lambda rows, index, n, group: real_gather(
            rows, (index + 1) % n, n, group)
        try:
            out[net]["rotated"] = eval_shard.predict_sharded(pred, faces, masks, mesh)
        finally:
            eval_shard.gather_blocks = real_gather

    # sampling: one video on every rank; each rank's shard draws its own eps
    same = np.repeat(d["faces"][:1], world, axis=0)
    same_mask = np.ones(same.shape[:2], np.float32)
    out["sampled"] = eval_shard.predict_sharded(
        predictor("genconvit", deterministic_vae=False, seed=0), same, same_mask, mesh)[1]
    out["deterministic"] = eval_shard.predict_sharded(
        predictor("genconvit"), same, same_mask, mesh)[1]

    # replicas from different seeds agree after the broadcast, folds included
    rand = predictor("ed", params=None, seed=rank)
    before = _digest(rand.model)
    verdicts = eval_shard.predict_sharded(rand, d["faces"], d["masks"], mesh)
    out["replica"] = (before, _digest(rand.model), verdicts)

    out["files"] = eval_shard.shard_file_list(d["paths"])
    out["blocks"] = [shard_batch(np.arange(n), mesh) for n in (2 * world, 2 * world + 2)]
    # the meshes and calls the data-parallel port refused now run: tensor parallelism
    # on the world x 1 mesh (a 'model' axis of one), a mesh with model 2
    # (weights replicated over 'model'), and the TP split in place
    runs = {}
    try:
        make_mesh(data=3, model=2)
        runs["3x2"] = None
    except ValueError as e:
        runs["3x2"] = (type(e).__name__, str(e))
    runs["tp"] = eval_shard.predict_sharded(pred, faces, masks, mesh, tensor_parallel=True)
    runs["dp"] = eval_shard.predict_sharded(pred, faces, masks, mesh)
    whole = {k: v.clone() for k, v in pred.model.state_dict().items()}
    split = shard_params(copy.deepcopy(pred.model), mesh, tensor_parallel=True)
    runs["tp_params"] = all(torch.equal(v, whole[k]) for k, v in split.state_dict().items())
    if world % 2 == 0:
        mesh2 = make_mesh(data=world // 2, model=2)
        out["mesh2_shape"] = tuple(mesh2.mesh.shape)
        runs["model2"] = eval_shard.predict_sharded(pred, faces, masks, mesh2)
        runs["model2_long"] = eval_shard.predict_long_video(pred, frames, None, mesh2)
        runs["long"] = eval_shard.predict_long_video(pred, frames, None, mesh)
        runs["model2_params"] = _digest(shard_params(pred.model, mesh2)) == _digest(
            pred.model)
    out["runs"] = runs
    return out


# ------------------------------------------------------------------ training


def _model(sds, net="genconvit", classes=BACKBONE_CLASSES):
    from genconvit_tpu_torch.models.genconvit import GenConViT
    from genconvit_tpu_torch.train import loop

    model = GenConViT(_config(), net, classes)
    for b, m in loop.branches(model).items():
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sds[b].items()})
    return model.to(memory_format=torch.channels_last)


def _tree(model, opt):
    """The JAX package's trees of the parameters and of Adam's moments."""
    from genconvit_tpu_torch.core.checkpoint import _list_form, opt_state_tree
    from genconvit_tpu_torch.train import loop

    def numpy(t):
        if isinstance(t, dict):
            return {k: numpy(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [numpy(v) for v in t]
        return np.array(t)

    adam = _list_form(opt_state_tree(opt, loop.branches(model))["inner_state"]["1"])
    return {"params": numpy(loop.params_tree(model)),
            "mu": numpy(adam["mu"]), "nu": numpy(adam["nu"]), "count": int(adam["count"])}


def run_steps(sds, batches, group):
    """One run from the weights: a step on each (images, labels, eps) of
    batches; returns the trees before, after the first step and at the end,
    the losses and accuracies."""
    from genconvit_tpu_torch.parallel.mesh import shard_rows
    from genconvit_tpu_torch.train import loop, optim

    model = _model(sds)
    opt = optim.make_optimizer(model.parameters(), LR, WD)
    step = loop.make_train_step(model, "genconvit", opt, group=group)
    rec = {"p0": _tree(model, opt)["params"], "loss": [], "acc": []}
    for i, (x, y, e) in enumerate(batches):
        if group is not None:   # the step takes this rank's rows of the images
            x = x[shard_rows(len(y), group)]
        loss, acc = step(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
                         torch.from_numpy(e))
        rec["loss"].append(float(loss))
        rec["acc"].append(float(acc))
        if i == 0:
            rec["first"] = _tree(model, opt)
    rec["last"] = _tree(model, opt)
    return rec, model, opt, step


def dp_rank(rank, world, inputs):
    """Two data-parallel genconvit steps on the 8-row batch over the world's
    ranks: the trees for the JAX comparison, the BatchNorm statistics of
    each forward and recompute, the losses and the parameters' digest
    (tests/test_torch_parallel_train.py)."""
    _register_small()
    from genconvit_tpu_torch.models import vae as vae_mod
    from genconvit_tpu_torch.parallel.mesh import data_group, make_mesh

    d = _load(inputs)
    group = data_group(make_mesh(data=world))
    real_bn = vae_mod.batch_norm_train
    seen = []

    def logged(x, bn, momentum=0.1, eps=1e-5, group=None):
        y, new = real_bn(x, bn, momentum, eps, group)
        seen.append(torch.cat([t.detach().float().reshape(-1) for t in new]).numpy().copy())
        return y, new

    vae_mod.batch_norm_train = logged
    try:
        rec, model = run_steps(d["sds"], d["batch8"], group)[:2]
    finally:
        vae_mod.batch_norm_train = real_bn
    rec["bn_calls"] = seen
    rec["digest"] = _digest(model)
    return rec if rank == 0 else {"digest": rec["digest"], "loss": rec["loss"]}


def train_rank(rank, world, inputs, tmp):
    """The data-parallel genconvit step over the world's ranks against the
    one-process step: two steps on the 8-row batch, then a save, restore and
    step; the same two steps with each rank's own BatchNorm statistics (a
    planted fault); a 5-row batch split 2/1/1/1; the one-process runs of
    both batches on ranks 1 and 2 (tests/test_torch_parallel_step.py)."""
    _register_small()
    from genconvit_tpu_torch.core.checkpoint import (load_checkpoint, opt_state_tree,
                                                     restore_opt_state, save_checkpoint)
    from genconvit_tpu_torch.core.convert import state_dict_from_jax
    from genconvit_tpu_torch.models import vae as vae_mod
    from genconvit_tpu_torch.parallel.mesh import data_group, make_mesh, shard_rows
    from genconvit_tpu_torch.train import loop, optim

    d = _load(inputs)
    group = data_group(make_mesh(data=world))
    sds, b8, b5 = d["sds"], d["batch8"], d["batch5"]
    rec, model, opt, step = run_steps(sds, b8, group)
    out = {"dp": rec} if rank == 0 else {}

    # the first rank saves, every rank restores, and both runs take the next step
    ck = os.path.join(tmp, "dp.gcv")
    if rank == 0:
        save_checkpoint(ck, loop.params_tree(model), epoch=1, min_loss=0.0,
                        opt_state=opt_state_tree(opt, loop.branches(model)))
    dist.barrier(group)
    payload = load_checkpoint(ck)
    m2 = loop.new_model(_config(), "genconvit", torch.device("cpu"), seed=rank,
                        backbone_classes=BACKBONE_CLASSES)
    for b, m in loop.branches(m2).items():
        m.load_state_dict(state_dict_from_jax(payload["params"][b], b))
    o2 = optim.make_optimizer(m2.parameters(), LR, WD)
    restore_opt_state(o2, loop.branches(m2), payload["opt_state"])
    s2 = loop.make_train_step(m2, "genconvit", o2, group=group)
    x, y, e = (torch.from_numpy(a) for a in b8[0])
    x = x[shard_rows(len(y), group)]
    out["resume"] = (float(step(x, y.long(), e)[0]), float(s2(x, y.long(), e)[0]))
    del model, m2, opt, o2

    # each rank's own BatchNorm statistics: the planted fault
    real_bn = vae_mod.batch_norm_train
    vae_mod.batch_norm_train = lambda x, bn, momentum=0.1, eps=1e-5, group=None: real_bn(
        x, bn, momentum, eps)
    try:
        planted = run_steps(sds, b8, group)[0]
    finally:
        vae_mod.batch_norm_train = real_bn
    if rank == 0:
        out["planted"] = planted

    uneven = run_steps(sds, b5, group)[0]
    rows = shard_rows(5, group)
    out["rows5"] = rows.stop - rows.start
    if rank == 0:
        out["uneven"] = uneven
    # the one-process runs, side by side on two ranks
    if rank == 1:
        out["one8"] = run_steps(sds, b8, None)[0]
    if rank == 2:
        out["one5"] = run_steps(sds, b5, None)[0]
    return out


def fit_kwargs():
    """train_model's arguments for tests/test_torch_parallel_fit.py, over
    ranks and in one process alike."""
    return dict(mod="genconvit", num_epochs=1, batch_size=4, config=_config(), seed=3,
                save_best=True, test_model=True, device="cpu")


def train_model_rank(rank, world, data_dir, wdir):
    """train_model data-parallel over the world's ranks (the default: every
    rank of the process group); each rank's save_checkpoint calls and the
    rows of each batch it read (tests/test_torch_parallel_fit.py)."""
    _register_small()
    from genconvit_tpu_torch.data import folder
    from genconvit_tpu_torch.train import loop

    calls, reads = [], []
    real_save, real_load = loop.save_checkpoint, folder.load_image

    def save(path, *a, **kw):
        calls.append(os.path.basename(path))
        return real_save(path, *a, **kw)

    def load(path, *a, **kw):
        reads.append(path)
        return real_load(path, *a, **kw)

    loop.save_checkpoint, folder.load_image = save, load
    s = loop.train_model(data_dir, weight_dir=wdir, **fit_kwargs())
    return {"history": s["history"], "checkpoint": s["checkpoint"],
            "test": s["test_accuracy"], "digest": _digest(s["model"]), "saves": calls,
            "reads": reads}


# ------------------------------------------------------------------ tensor parallelism

TP_CLASSES = 16   # backbone classes that split evenly over 'model' down to the heads' fc2
TP_CASES = (("ed", "ed", "default"), ("vae", "vae", "default"),
            ("genconvit", "genconvit", "default"), ("swiglu", "genconvit", "swiglu"),
            ("updated", "vae", "updated"))


def _bias_on_every_rank(x, weight, bias, tp):
    """row_linear with fc2's bias added on every rank before the sum (a
    planted fault)."""
    from genconvit_tpu_torch.ops import collective

    if tp is None:
        return torch.nn.functional.linear(x, weight, bias)
    z = x.float() @ weight.float().t() + bias.float()
    return collective.reduce_from_model(z, tp.group).to(x.dtype)


def _summed_twice(x, group):
    """all_reduce_sum in place of reduce_from_model (a planted fault: the
    gradient is summed over the group as well)."""
    from genconvit_tpu_torch.ops.collective import all_reduce_sum

    return all_reduce_sum(x, group)


class _Patched:
    """setattr for the duration of a with block."""

    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.real = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


def _tp_step(sds, mesh, fresh_seed=None):
    """A split genconvit model (from the weights, or seeded with fresh_seed
    before the weights are loaded), its optimizer and DP+TP step."""
    from genconvit_tpu_torch.parallel.mesh import data_group, shard_params
    from genconvit_tpu_torch.train import loop, optim

    if fresh_seed is None:
        model = _model(sds, classes=TP_CLASSES)
    else:
        model = loop.new_model(_config(), "genconvit", torch.device("cpu"), seed=fresh_seed,
                               backbone_classes=TP_CLASSES)
    shard_params(model, mesh, tensor_parallel=True)
    opt = optim.make_optimizer(model.parameters(), LR, WD)
    return model, opt, loop.make_train_step(model, "genconvit", opt, group=data_group(mesh))


def _take_step(model, step, mesh, batch):
    """One step on this rank's rows; (loss, acc, every gradient whole)."""
    from genconvit_tpu_torch.parallel.mesh import all_gather_state_dict, data_group, shard_rows
    from genconvit_tpu_torch.train import loop

    x, y, e = (torch.from_numpy(a) for a in batch)
    loss, acc = step(x[shard_rows(len(y), data_group(mesh))], y.long(), e)
    grads = {}
    for b, m in loop.branches(model).items():
        whole = all_gather_state_dict({k: p.grad for k, p in m.named_parameters()}, m.tp)
        grads[b] = {k: v.numpy().copy() for k, v in whole.items()}
    return float(loss), float(acc), grads


def _split_digests(model):
    """(digest of the replicated tensors, digest of this rank's blocks)."""
    from genconvit_tpu_torch.parallel.mesh import tp_splits

    sd = model.state_dict()
    split = tp_splits({k: tuple(v.shape) for k, v in sd.items()})
    rep, blk = hashlib.sha256(), hashlib.sha256()
    for k, t in sorted(sd.items()):
        (blk if k in split else rep).update(t.detach().contiguous().numpy().tobytes())
    return rep.hexdigest(), blk.hexdigest()


def tp_rank(rank, world, inputs, tmp):
    """Tensor parallelism on a (world/2) x 2 mesh (tests/test_torch_parallel_tp.py):
    predict_sharded(tensor_parallel=True) for every case of TP_CASES beside
    the unsplit forward, planted faults in the eval (a contiguous SwiGLU
    split, fc2's bias on every rank), the DP+TP genconvit step's record,
    gradients and digests, a gathered `.gcv` save, a restore into a model
    split again and the next step, the same first step with all_reduce_sum
    in place of reduce_from_model (a planted fault), and on rank 1 the
    one-process step's gradients."""
    _register_small()
    from genconvit_tpu_torch.core.checkpoint import (load_checkpoint, opt_state_tree,
                                                     restore_opt_state, save_checkpoint)
    from genconvit_tpu_torch.core.convert import state_dict_from_jax
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.ops import collective
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel import eval_shard, mesh as mesh_mod
    from genconvit_tpu_torch.parallel.mesh import (DATA_AXIS, load_whole_state_dict, make_mesh,
                                                   model_axis)
    from genconvit_tpu_torch.train import loop, optim

    d = _load(inputs)
    mesh = make_mesh(data=world // 2, model=2)
    out = {"mesh": tuple(mesh.mesh.shape), "model_index": model_axis(mesh).index,
           "data_index": mesh.get_local_rank(DATA_AXIS)}

    def predictor(net, weights):
        return Predictor(_config(), net=net, device="cpu", params=_params(d["sds"][weights], net),
                         deterministic_vae=True, kernel_plan=KernelPlan(),
                         backbone_classes=TP_CLASSES, face_backend="fullframe")

    def tp_eval(net, weights):
        return eval_shard.predict_sharded(predictor(net, weights), d["faces"], d["masks"], mesh,
                                          tensor_parallel=True)

    for case, net, weights in TP_CASES:
        pred = predictor(net, weights)
        out[case] = {"tp": eval_shard.predict_sharded(pred, d["faces"], d["masks"], mesh,
                                                      tensor_parallel=True),
                     "unsplit": pred.predict_videos_batched(d["faces"], d["masks"])}
        # the predictor's model stays whole; the cached copy holds the blocks
        copy, = pred._sharded_params_cache.values()
        out[case]["fc_rows"] = [(m.tp is not None, m.fc.weight.shape[0])
                                for m in (pred.model.branches()[-1], copy.branches()[-1])]
    with _Patched(mesh_mod, "_halves", lambda name, shapes: 1):
        out["planted_swiglu"] = tp_eval("genconvit", "swiglu")
    with _Patched(collective, "row_linear", _bias_on_every_rank):
        out["planted_bias"] = tp_eval("genconvit", "default")

    batch = d["batch"]
    model, opt, step = _tp_step(d["sds"]["train"], mesh)
    p0 = _tree(model, opt)["params"]
    loss, acc, grads = _take_step(model, step, mesh, batch)
    first = _tree(model, opt)
    out["digests"] = _split_digests(model)
    if rank == 0:
        out["dp_tp"] = {"p0": p0, "first": first, "last": first, "loss": [loss], "acc": [acc],
                        "grads": grads}
    out["loss"] = loss

    # the first rank writes the gathered trees; every rank restores and splits
    ck = os.path.join(tmp, "tp.gcv")
    params, opt_tree = loop.params_tree(model), opt_state_tree(opt, loop.branches(model))
    if rank == 0:
        save_checkpoint(ck, params, epoch=1, min_loss=loss, opt_state=opt_tree)
    dist.barrier()
    payload = load_checkpoint(ck)
    m2, o2, s2 = _tp_step(None, mesh, fresh_seed=rank + 7)
    for b, m in loop.branches(m2).items():
        load_whole_state_dict(m, state_dict_from_jax(payload["params"][b], b))
    restore_opt_state(o2, loop.branches(m2), payload["opt_state"])
    out["resume"] = (_take_step(model, step, mesh, d["batch2"])[0],
                     _take_step(m2, s2, mesh, d["batch2"])[0])
    if rank == 0:
        out["saved"] = ck
        out["after_resume"] = _tree(m2, o2)["params"]
    else:
        _tree(m2, o2)
    del model, m2, opt, o2

    with _Patched(collective, "reduce_from_model", _summed_twice):
        model, opt, step = _tp_step(d["sds"]["train"], mesh)
        planted = _take_step(model, step, mesh, batch)
    if rank == 0:
        out["planted_reduce"] = {"loss": planted[0], "grads": planted[2]}
    if rank == 1:   # the one-process step's gradients, beside
        model = _model(d["sds"]["train"], classes=TP_CLASSES)
        opt = optim.make_optimizer(model.parameters(), LR, WD)
        x, y, e = (torch.from_numpy(a) for a in batch)
        loop.make_train_step(model, "genconvit", opt)(x, y.long(), e)
        out["one_grads"] = {b: {k: p.grad.numpy().copy() for k, p in m.named_parameters()}
                            for b, m in loop.branches(model).items()}
    return out
