"""Sharded dataset evaluation (port of genconvit_tpu/parallel/eval_shard.py).

The reference scores videos one after another in one process; the only
cluster behaviour to reproduce is embarrassingly parallel scoring. Here the
video axis (`predict_sharded`) or one long video's frame axis
(`predict_long_video`) is split over the mesh's 'data' ranks: each rank runs
the Predictor's own forward, with its kernels and plan, on its block, and
the verdict rows or the masked frame sums are summed over the 'data' group.
A multi-host run splits the file list per process first (`shard_file_list`).

On a mesh with model > 1 the weights are replicated over 'model' (the
ranks of one 'data' index score the same block alike), unless
`predict_sharded` is asked for tensor parallelism: then each rank runs a
copy of the model split over 'model' (parallel/mesh.split_module; the
JAX package's GSPMD path, :194-198 there), in which the backbone takes the
path `models/convnext.backbone_path` gives a split backbone: the plain
graph under pallas '', the kernels on whole weights under the plans that
force them.

The collectives are all-reduces of small float32 buffers, which NCCL and
gloo (CUDA tensors included) both take: the verdicts are gathered by summing
a zero-filled [2, V] buffer in which each rank wrote its block.

VAE sampling (deterministic_vae False): every rank builds its Predictor
from the same seed, so their generators would draw the same eps for
different videos. Each call instead draws one 63-bit seed from the
predictor's generator (the same draw on every rank) and mixes it with the
rank's index along 'data' through numpy's SeedSequence; the shard samples
from a generator seeded so, as the JAX package folds the axis index into
the key (:74, :114 there).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from genconvit_tpu_torch.infer.aggregate import finish_aggregate, masked_prob_sums
from genconvit_tpu_torch.parallel.mesh import (DATA_AXIS, make_mesh, model_axis, shard_params,
                                               split_module)


def shard_file_list(paths: Sequence[str], process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> List[str]:
    """Round-robin split of the video list across processes (:23-29
    there); the rank and world of the process group unless given."""
    pi = dist.get_rank() if process_index is None else process_index
    pc = dist.get_world_size() if process_count is None else process_count
    return [p for i, p in enumerate(paths) if i % pc == pi]


def sharded_params(predictor, mesh: DeviceMesh,
                   tensor_parallel: bool = False) -> torch.nn.Module:
    """The model the mesh's forward runs, once per (mesh, tensor_parallel),
    cached on the predictor (:32-45 there; the VAE's latent heads alone are
    630M parameters): the predictor's model replicated over the mesh, in
    place (`shard_params`: broadcast from the mesh's first rank), its
    kernel folds made again; with tensor_parallel, then a copy split over
    'model' (`split_module`), which shares every replicated tensor with the
    predictor's model and holds this rank's blocks of the split ones (at
    convnext_tiny's widths 1/m of the latent heads' 630M parameters, of
    the MLPs' 2 x 14M and of the heads), with its own folds
    (`prepare_kernels`: whole weights for the plans that force kernels),
    one per kernel plan (the copy's folds follow the predictor's plan, as
    the JAX package keys its traces on it). The predictor's model itself
    is never split."""
    where = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape))
    key = where + (tensor_parallel, predictor.kernel_plan if tensor_parallel else None)
    cache = predictor.__dict__.setdefault("_sharded_params_cache", {})
    if key not in cache:
        if not any(k[:2] == where for k in cache):   # replicated once per mesh
            shard_params(predictor.model, mesh)
            predictor.prepare_kernels()
        model = predictor.model
        if tensor_parallel:
            model = split_module(model, model_axis(mesh), in_place=False)
            if predictor.dtype == torch.bfloat16:
                model.prepare_kernels(predictor.kernel_plan)
        cache[key] = model
    return cache[key]


def gather_blocks(rows: torch.Tensor, index: int, n: int, group) -> torch.Tensor:
    """[k, b] rows of the block at `index` -> [k, n b], every rank's block
    in rank order, on every rank (an all-reduce of a zero-filled buffer)."""
    out = rows.new_zeros((rows.shape[0], n * rows.shape[1]))
    out[:, index * rows.shape[1]:(index + 1) * rows.shape[1]] = rows
    dist.all_reduce(out, group=group)
    return out


def _pad(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-len(x)) % mult
    return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x


def _shard(predictor, mesh: Optional[DeviceMesh], tensor_parallel: bool = False):
    """('data' group, its size, this rank's index along it, the shard's
    generator, the model to run: `sharded_params`)."""
    mesh = mesh or make_mesh()
    group = mesh.get_group(DATA_AXIS)
    n, index = mesh.size(0), mesh.get_local_rank(DATA_AXIS)
    model = sharded_params(predictor, mesh, tensor_parallel)
    gen = None
    if not predictor.deterministic_vae:
        g = predictor.generator
        seed = int(torch.randint(0, 2**63 - 1, (), generator=g, device=g.device))
        state = np.random.SeedSequence([seed, index]).generate_state(2, np.uint64)
        gen = torch.Generator(device=predictor.device).manual_seed(int(state[0] >> 1))
    return group, n, index, gen, model


def predict_sharded(predictor, faces_batch, masks, mesh: Optional[DeviceMesh] = None,
                    tensor_parallel: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Score V videos ([V,F,S,S,3] uint8 and [V,F] masks, numpy or tensors)
    with the video axis split over the mesh's 'data' ranks (:167-201
    there): V padded to a multiple of the group's size with zero-mask
    videos, this rank's block through `predictor.forward_batched` (with
    tensor_parallel, of the model split over 'model'), the [2, V/n]
    verdict rows gathered in rank order over 'data' only. Returns (y [V]
    int64, y_val [V] float32) on every rank."""
    group, n, index, gen, model = _shard(predictor, mesh, tensor_parallel)
    frames = torch.as_tensor(faces_batch)
    v = len(frames)
    frames = _pad(frames, n)
    mask = _pad(torch.as_tensor(masks, dtype=torch.float32), n)
    b = len(frames) // n
    block = slice(index * b, (index + 1) * b)
    dev = predictor.device
    rows = predictor._rows(predictor.forward_batched(frames[block].to(dev), mask[block].to(dev),
                                                     generator=gen, model=model))
    out = gather_blocks(rows, index, n, group).cpu().numpy()
    return out[0, :v].astype(np.int64), out[1, :v].astype(np.float32)


def predict_long_video(predictor, frames_u8, mask=None,
                       mesh: Optional[DeviceMesh] = None) -> Tuple[int, float]:
    """Score ONE video ([F,S,S,3] uint8, [F] mask or None for all frames)
    with its frame axis split over the mesh's 'data' ranks (:132-164
    there): F padded with zero-mask frames, each rank's F/n frames through
    the forward and `masked_prob_sums` (for the ensemble the ED rows then
    the VAE rows, each under the frame mask), the sums and the count
    all-reduced over 'data', then `finish_aggregate`; the weights are
    replicated over 'model' (:157 there). Returns (y, y_val) on every
    rank."""
    group, n, index, gen, _ = _shard(predictor, mesh)
    frames = torch.as_tensor(frames_u8)
    mask = (torch.ones(len(frames)) if mask is None
            else torch.as_tensor(mask, dtype=torch.float32))
    frames, mask = _pad(frames, n), _pad(mask, n)
    b = len(frames) // n
    block = slice(index * b, (index + 1) * b)
    dev = predictor.device
    logits, full_mask = predictor.video_logits(frames[None, block].to(dev),
                                               mask[None, block].to(dev), generator=gen)
    sums, count = masked_prob_sums(logits[0], full_mask[0])
    total = torch.cat([sums, count[None]])
    dist.all_reduce(total, group=group)
    y, y_val = finish_aggregate(total[:2], total[2])
    return int(y), float(y_val)
