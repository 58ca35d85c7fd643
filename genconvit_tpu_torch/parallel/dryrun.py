"""Multi-device dry run (the port's counterpart of __graft_entry__.py:42-202).

    python -m genconvit_tpu_torch.parallel.dryrun N               # on the card
    python -m genconvit_tpu_torch.parallel.dryrun N --device cpu

spawns N gloo ranks (one CPU thread each, a FileStore in a temporary
directory), each on its card (gloo on CUDA tensors; ranks share a card
when there are more ranks than cards) or, with `--device cpu`, on the CPU,
lays them on a ('data', 'model') mesh by the JAX package's rule (model = 2
where N is even: `dryrun 2` is 1x2, `dryrun 4` 2x2; else N x 1) and
checks, at 64 px on the default convnext_tiny config (`dryrun_multichip`'s
small: ConvNeXt depths 1,1,1,1, dims 8-64, backbone classes 16, the tests'
quick check on the CPU) with seeded random weights and the environment's
kernel plan, each of these in turn:

  1. a float32 genconvit train step over 2 x data images, the model split
     over 'model' (tensor parallelism) where model > 1, with its loss;
  2. the sharded {params, opt_state} gathered over 'model' into one `.gcv`
     by the first rank, restored and split again on every rank, and the
     next step, whose loss must equal the continuing run's within rtol
     1e-6;
  3. `predict_sharded` on V=5 videos (padded to the data axis), with
     tensor_parallel where model > 1, against the one-process forward of
     each rank's block (y equal, y_val within 1e-6; 5e-4 on the card, and
     where model > 1 within 5e-3 where decisive, against the one-process
     forward of the path the split backbone takes, pallas '0' for the
     default plan: its split products round differently) and of the whole
     batch (the same, within 1e-6; on the card within 2e-2, the bf16
     parity bound, since there the batch's size and the path change the
     rounding, and only where the two class means lie farther apart than
     twice that: at a tie the verdict flips on rounding; both heads' last
     layer is scaled by 30 so that few are ties);
  4. `predict_long_video` on F = 2 x data + 3 frames with a 2-frame masked
     tail, the weights replicated over 'model', against the one-process
     forward of the data ranks' blocks, summed, and of the whole video (the
     same bounds).

Every rank returns the lines it checked; the first prints them. Without
CUDA the default raises. `Ranks` is the spawner (the tests and
`chip_smoke.py` run their ranks through it too).
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from genconvit_tpu_torch.device import default_device
from genconvit_tpu_torch.infer.aggregate import finish_aggregate, masked_prob_sums
from genconvit_tpu_torch.parallel.multihost import initialize_multihost, rank_device

# (each rank's block, the whole batch or video) y_val bounds against the
# one-process forward, by device type
TOLERANCE = {"cpu": (1e-6, 1e-6), "cuda": (5e-4, 2e-2)}
# a split rank's block against the one-process forward of the same path on
# the card: the split products round differently from the unsplit cuBLAS
# ones (bf16 features 1-2 ulps apart; the scaled heads carry that to y_val
# as the bf16 batch effect does), so it is held where decisive, as the
# whole batch is
TP_BLOCK_TOL = 5e-3
HEAD_SCALE = 30.0   # on both heads' last layer, as chip_smoke.py's phase 5 scales them
SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))   # the small ConvNeXt
SMALL_NAME = "dryrun_small"
SMALL_CLASSES = 16   # its backbone classes (even splits over 'model' down to fc2)


def mesh_shape(n: int) -> tuple:
    """(data, model) of n devices by the JAX package's rule
    (__graft_entry__.py:88-90): model = 2 where n is even."""
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return n // model, model


class Ranks:
    """fn(rank, n, *args) in n processes (spawned: fn must be importable),
    each a rank of one gloo process group (a FileStore in a temporary
    directory) with one CPU thread, on its `rank_device`: with CUDA
    cuda:LOCAL_RANK, LOCAL_RANK being the rank modulo the visible cards (on
    one card the ranks share it); `join` returns each rank's result."""

    def __init__(self, fn, n: int, *args):
        self.n = n
        self._tmp = tempfile.TemporaryDirectory(prefix="gcv_ranks_")
        self._ctx = mp.spawn(_rank_main, args=(fn, n, self._tmp.name, args), nprocs=n,
                             join=False)

    def join(self, timeout: float = 600.0) -> list:
        """Wait for every rank (raising the first failure; every rank is
        killed past `timeout` seconds) and return their results in rank
        order."""
        try:
            deadline = time.monotonic() + timeout
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in self._ctx.processes:
                        p.kill()
                    raise TimeoutError(f"{self.n} ranks still running after {timeout} s")
            out = []
            for r in range(self.n):
                with open(os.path.join(self._tmp.name, f"result_{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._tmp.cleanup()


def _rank_main(rank: int, fn, n: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank % max(torch.cuda.device_count(), 1))
    initialize_multihost(f"file://{os.path.join(tmp, 'store')}", n, rank, backend="gloo")
    try:
        out = fn(rank, n, *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _dryrun_rank(rank: int, n: int, tmp: str, kind: str, small: bool = False) -> list:
    import dataclasses

    from genconvit_tpu_torch.config import Config
    from genconvit_tpu_torch.core.checkpoint import (load_checkpoint, opt_state_tree,
                                                     restore_opt_state, save_checkpoint)
    from genconvit_tpu_torch.core.convert import state_dict_from_jax
    from genconvit_tpu_torch.infer.engine import Predictor
    from genconvit_tpu_torch.models import convnext
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
    from genconvit_tpu_torch.parallel.eval_shard import predict_long_video, predict_sharded
    from genconvit_tpu_torch.parallel.mesh import (DATA_AXIS, data_group, load_whole_state_dict,
                                                   make_mesh, shard_params, shard_rows)
    from genconvit_tpu_torch.train import loop, optim

    lines = []

    def say(msg):
        lines.append(f"dryrun_multichip({n}): {msg}")
        if rank == 0:
            print(lines[-1], flush=True)

    ndata, nmodel = mesh_shape(n)
    tp = nmodel > 1
    mesh = make_mesh(data=ndata, model=nmodel)
    group = data_group(mesh)
    index = mesh.get_local_rank(DATA_AXIS)
    config = Config(img_size=64)
    classes = 1000
    if small:
        convnext.CONVNEXT_CFGS[SMALL_NAME] = SMALL
        config.model.backbone, classes = SMALL_NAME, SMALL_CLASSES
    config.model.latent_dims = config.derived_latent_dims()
    dev = rank_device() if kind == "cuda" else torch.device("cpu")
    block_tol, whole_tol = TOLERANCE[kind]

    def trainer(model):
        opt = optim.make_optimizer(model.parameters(), config.learning_rate,
                                   config.weight_decay)
        return opt, loop.make_train_step(model, "genconvit", opt, plan=KernelPlan(),
                                         group=group)

    def split_model(seed):
        return shard_params(loop.new_model(config, "genconvit", dev, seed, classes), mesh,
                            tensor_parallel=tp)

    model = split_model(rank)
    opt, step = trainer(model)
    rng = np.random.default_rng(0)
    batch = 2 * ndata
    images = torch.from_numpy(rng.integers(0, 255, (batch, 64, 64, 3), np.uint8)).to(dev)
    labels = (torch.arange(batch) % 2).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    eps = [loop.draw_eps(model, batch, torch.float32, gen) for _ in range(2)]
    mine = images[shard_rows(batch, group)]   # this rank's rows of the images
    loss, acc = step(mine, labels, eps[0])
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    say(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} tp={tp} "
        f"loss={float(loss):.4f} acc={float(acc):.3f}")

    # every rank gathers (a collective); the first writes
    ck = os.path.join(tmp, "sharded.gcv")
    params, opt_tree = loop.params_tree(model), opt_state_tree(opt, loop.branches(model))
    if rank == 0:
        save_checkpoint(ck, params, epoch=1, min_loss=float(loss), opt_state=opt_tree)
    del params, opt_tree
    dist.barrier()
    payload = load_checkpoint(ck)
    restored = split_model(rank + n)
    for b, m in loop.branches(restored).items():
        load_whole_state_dict(m, state_dict_from_jax(payload["params"][b], b))
    opt_r, step_r = trainer(restored)
    restore_opt_state(opt_r, loop.branches(restored), payload["opt_state"])
    loss2a = float(step(mine, labels, eps[1])[0])
    loss2b = float(step_r(mine, labels, eps[1])[0])
    np.testing.assert_allclose(loss2b, loss2a, rtol=1e-6)
    say(f"sharded ckpt resume parity ok (gather->save->restore->split->step: loss "
        f"{loss2b:.6f} == {loss2a:.6f}, opt_state round-tripped)")
    del model, restored, opt, opt_r

    config.weight_dir = os.path.join(tmp, "none")   # random init (no weights)
    pred = Predictor(config, net="genconvit", device=dev, seed=0, deterministic_vae=True,
                     face_backend="fullframe", backbone_classes=classes)
    with torch.no_grad():   # both heads' last layer scaled, so that verdicts are decisive
        for branch in pred.model.branches():
            branch.fc2.weight.mul_(HEAD_SCALE)
            branch.fc2.bias.mul_(HEAD_SCALE)
    v, f = 5, 3
    faces = rng.integers(0, 255, (v, f, 64, 64, 3), np.uint8)
    masks = np.ones((v, f), np.float32)
    y_sh, val_sh = predict_sharded(pred, faces, masks, mesh, tensor_parallel=tp)
    # this data rank's block of the padded batch, in one process, on the
    # path the split backbone takes (the plain graph for pallas '')
    b = -(-v // ndata)
    pad_faces = np.concatenate([faces, np.zeros((b * ndata - v,) + faces.shape[1:], np.uint8)])
    pad_masks = np.concatenate([masks, np.zeros((b * ndata - v, f), np.float32)])
    plan = pred.kernel_plan
    if tp and plan.pallas == "":
        pred.kernel_plan = dataclasses.replace(plan, pallas="0")
    sums, counts = _sums(pred, pad_faces[index * b:(index + 1) * b],
                         pad_masks[index * b:(index + 1) * b])
    pred.kernel_plan = plan
    own = slice(min(index * b, v), min((index + 1) * b, v))   # without the padding
    k = own.stop - own.start
    if tp and kind == "cuda":
        _check_whole(y_sh[own], val_sh[own], (sums[:k], counts[:k]), TP_BLOCK_TOL, False,
                     f"rank {rank}'s block")
    else:
        y_b, val_b = finish_aggregate(sums, counts)
        _check(y_sh[own], val_sh[own], y_b[:k], val_b[:k], block_tol, f"rank {rank}'s block")
    whole = _sums(pred, faces, masks)
    decided = _check_whole(y_sh, val_sh, whole, whole_tol, kind == "cpu", "the whole batch")
    say(f"sharded eval parity ok (V={v} videos, mesh {ndata}x{nmodel}, tp={tp}; max |dval|="
        f"{float(np.abs(val_sh - finish_aggregate(*whole)[1].numpy()).max()):.2e} against "
        f"the whole batch, {decided} of {v} verdicts held)")

    f_long = 2 * ndata + 3
    frames = rng.integers(0, 255, (f_long, 64, 64, 3), np.uint8)
    lmask = np.ones((f_long,), np.float32)
    lmask[-2:] = 0.0
    y_l, v_l = predict_long_video(pred, frames, lmask, mesh)
    # the data ranks' blocks in one process, summed as the all-reduce sums them
    b = -(-f_long // ndata)
    pad = np.concatenate([frames, np.zeros((b * ndata - f_long,) + frames.shape[1:], np.uint8)])
    pmask = np.concatenate([lmask, np.zeros(b * ndata - f_long, np.float32)])
    blocks = [_sums(pred, pad[None, r * b:(r + 1) * b], pmask[None, r * b:(r + 1) * b])
              for r in range(ndata)]
    y_b, val_b = finish_aggregate(sum(s for s, _ in blocks), sum(c for _, c in blocks))
    _check(np.array([y_l]), np.array([v_l]), y_b, val_b, block_tol, "the blocks' sums")
    whole = _sums(pred, frames[None], lmask[None])
    held = _check_whole(np.array([y_l]), np.array([v_l]), whole, whole_tol, kind == "cpu",
                        "the whole video")
    say(f"long-video frame-sharding parity ok (F={f_long} frames over the data axis, "
        f"masked all-reduced mean |dval|={abs(v_l - float(finish_aggregate(*whole)[1])):.2e} "
        f"against the whole video, {'held' if held else 'a tie, not held'})")
    return lines


def _sums(pred, frames, masks):
    """The one-process forward of [V,F,S,S,3] videos: the masked sigmoid
    sums [V, 2] and counts [V] (`forward_batched` before its last step),
    on the CPU."""
    dev = pred.device
    with torch.no_grad():
        logits, mask = pred.video_logits(torch.as_tensor(frames).to(dev),
                                         torch.as_tensor(masks, dtype=torch.float32).to(dev))
        sums, count = masked_prob_sums(logits, mask)
    return sums.cpu(), count.cpu()


def _check(y, val, y_ref, val_ref, tol: float, what: str) -> None:
    if not np.array_equal(np.asarray(y), np.asarray(y_ref)):
        raise AssertionError(f"verdicts diverged from {what}'s: {y} vs {y_ref}")
    np.testing.assert_allclose(val, val_ref, rtol=0, atol=tol, err_msg=what)


def _check_whole(y, val, ref, tol: float, every: bool, what: str) -> int:
    """y equal and y_val within tol of the reference's (sums, counts), for
    every video (every) or for those whose two class means lie farther
    apart than twice tol: at a tie the verdict flips on rounding, and
    y_val jumps from one mean to one minus the other. Returns how many
    were held."""
    y_ref, val_ref = (t.numpy() for t in finish_aggregate(*ref))
    means = (ref[0] / ref[1].clamp(min=1.0)[:, None]).numpy()
    held = np.ones(len(y_ref), bool) if every else np.abs(means[:, 0] - means[:, 1]) > 2 * tol
    _check(np.asarray(y)[held], np.asarray(val)[held], y_ref[held], val_ref[held], tol, what)
    return int(held.sum())


def dryrun_multichip(n: int, device=None, small: bool = False) -> list:
    """The four checks of the module docstring over n gloo ranks, on the
    card unless device is 'cpu' (without CUDA the default raises); raises
    on the first that fails, else returns each rank's lines. small: the
    cut ConvNeXt (`SMALL`). On the card the kernels are built once here,
    before the ranks start."""
    kind = default_device().type if device is None else torch.device(device).type
    if kind == "cuda":
        from genconvit_tpu_torch.ops.cuda import _build

        _build.build()
    with tempfile.TemporaryDirectory(prefix="gcv_dryrun_") as tmp:
        return Ranks(_dryrun_rank, n, tmp, kind, small).join()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Multi-device dry run over N gloo ranks "
                                             "(model = 2 where N is even).")
    ap.add_argument("n", nargs="?", type=int, default=4, help="ranks (default 4)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run there; the card by default")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
