"""Device mesh and data-parallel placement (port of
genconvit_tpu/parallel/mesh.py, data parallelism only).

The ranks of the process group lie on a DeviceMesh with dims ('data',
'model'). A batch is split on 'data' into contiguous blocks in rank order,
the split `P('data')` makes; the parameters are replicated, which here means
broadcast from the 'data' group's first rank. The JAX package lets XLA
insert the collectives; here they are explicit: `all_reduce_sum`, a
differentiable all-reduce (from ops/collective.py), and `all_reduce_grads`,
the gradients' sum.

Tensor parallelism (the 'model' axis, mesh.py:52-81 there) is not ported:
every function here raises NotImplementedError for it and never falls back
to replication.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from genconvit_tpu_torch.ops.collective import all_reduce_sum  # noqa: F401 (re-exported)
from genconvit_tpu_torch.parallel.multihost import rank_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TP_NOT_PORTED = ("tensor parallelism (a mesh with model > 1) is not ported yet: it is "
                 "ROADMAP.md's next queue-1 item (tensor parallelism)")
GRAD_BUCKET = 1 << 24   # elements a flattened gradient all-reduce carries


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A ('data', 'model') mesh over `devices` (ranks; every rank of the
    process group by default), data * model of them in row-major order.
    Every rank of the group must call it (it creates the mesh's groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost() "
                           "(or torch.distributed.init_process_group) first")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if data is None:
        data = len(ranks) // model
    if data * model != len(ranks):
        raise ValueError(f"mesh {data}x{model} != {len(ranks)} devices")
    return DeviceMesh(rank_device().type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_data_parallel(mesh: DeviceMesh, tensor_parallel: bool = False) -> None:
    """Raise NotImplementedError for tensor parallelism or a mesh with
    model > 1."""
    if tensor_parallel or mesh.size(1) > 1:
        raise NotImplementedError(TP_NOT_PORTED)


def data_group(mesh: DeviceMesh):
    """The 'data' process group of this rank."""
    check_data_parallel(mesh)
    return mesh.get_group(DATA_AXIS)


def shard_rows(n: int, group) -> slice:
    """This rank's contiguous block of n rows over `group`, in rank order:
    n / size rows each when size divides n (P('data')), else the first n %
    size ranks take one more."""
    size, index = dist.get_world_size(group), dist.get_rank(group)
    base, extra = divmod(n, size)
    start = index * base + min(index, extra)
    return slice(start, start + base + (index < extra))


def shard_batch(x, mesh: DeviceMesh):
    """This rank's rows of the batch x (leading axis), as `shard_rows`
    splits them."""
    return x[shard_rows(len(x), data_group(mesh))]


@torch.no_grad()
def shard_params(module: torch.nn.Module, mesh: DeviceMesh,
                 tensor_parallel: bool = False) -> torch.nn.Module:
    """Replicate the module over 'data': every parameter and buffer is
    broadcast, in place, from the 'data' group's first rank, so that
    replicas built from different seeds agree (what device_put with a
    replicated sharding means in the JAX package)."""
    check_data_parallel(mesh, tensor_parallel)
    group = mesh.get_group(DATA_AXIS)
    src = dist.get_global_rank(group, 0)
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, src, group=group)
    return module


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Every gradient summed over `group`, in place: gradients of one dtype
    and device are flattened into buckets of up to GRAD_BUCKET elements, one
    all-reduce each; a contiguous gradient as large as a bucket goes alone,
    without a copy. The order is the parameters', the same on every rank."""
    pending, size = [], 0

    def flush():
        nonlocal pending, size
        if pending:
            flat = torch.cat([g.reshape(-1) for g in pending])
            dist.all_reduce(flat, group=group)
            for g, v in zip(pending, flat.split([g.numel() for g in pending])):
                g.copy_(v.view(g.shape))
        pending, size = [], 0

    for p in params:
        g = p.grad
        if g is None:
            continue
        if g.numel() >= GRAD_BUCKET and g.is_contiguous():
            dist.all_reduce(g, group=group)
            continue
        if pending and (g.dtype != pending[0].dtype or g.device != pending[0].device
                        or size + g.numel() > GRAD_BUCKET):
            flush()
        pending.append(g)
        size += g.numel()
    flush()
