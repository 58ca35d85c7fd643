"""Device mesh, data-parallel placement and tensor-parallel splits (port of
genconvit_tpu/parallel/mesh.py).

The ranks of the process group lie on a DeviceMesh with dims ('data',
'model'). A batch is split on 'data' into contiguous blocks in rank order,
the split `P('data')` makes. Replicated parameters are broadcast from the
mesh's first rank. The JAX package lets XLA insert the collectives; here
they are explicit: `all_reduce_sum`, a differentiable all-reduce (from
ops/collective.py), and `all_reduce_grads`, the gradients' sum.

Tensor parallelism splits the fat matmuls over 'model', as the JAX
package's `_tp_spec_for_path` (:52-81 there) does, by this module's own
table (`tp_rule`, on the port's parameter names): the VAE's latent heads
mu and var (float `weight`/`bias` or int8 `wq`/`scale`/`bias`) and every
`fc` (the branch heads and the backbones' classifier) by output column,
every ConvNeXt `mlp.fc1` by output column and `mlp.fc2` by input row, the
branch heads' `fc2` by input row; everything else (convolutions, norms,
fc2's biases, the updated VAE's decoder_input) is replicated. In the torch
layout [out, in] a column split cuts a weight's first axis and a row split
its second. A SwiGLU head's fc (twice fc2's input width) is split in each
of its halves a | b, so that a rank holds a_r | b_r, the pairs its gate
takes. Splits are even: a width that the axis does not divide is refused.
The models run a split module through ops/collective.py's Megatron
collectives, reading the `ModelAxis` that `split_module` gives them. A
Swin backbone is refused: its blocks' `mlp.fc1`/`mlp.fc2` match the MLP
rules, but a Swin block runs its MLP whole, with no all-reduce.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from genconvit_tpu_torch.ops.collective import ModelAxis, all_reduce_sum  # noqa: F401
from genconvit_tpu_torch.parallel.multihost import rank_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
COLUMN, ROW = 0, 1   # the torch axis a split cuts ([out, in] weights)
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


def data_group(mesh: DeviceMesh):
    """The 'data' process group of this rank (the ranks that hold the same
    block of every split tensor)."""
    return mesh.get_group(DATA_AXIS)


def model_axis(mesh: DeviceMesh) -> ModelAxis:
    """This rank's place on the mesh's 'model' axis."""
    return ModelAxis(mesh.get_group(MODEL_AXIS), mesh.size(1),
                     mesh.get_local_rank(MODEL_AXIS))


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


# ------------------------------------------------------------------ TP table


def tp_rule(name: str, ndim: int) -> Optional[int]:
    """The split of one parameter or buffer under tensor parallelism, by its
    name (from any module down to it) and rank: COLUMN, ROW or None
    (replicated). The JAX package's `_tp_spec_for_path` rules, in their
    order, on the port's names (`wq`/`scale` for JAX's int8 `wq`/`scale`,
    `weight` for `kernel`)."""
    parts = name.split(".")
    leaf = parts[-1]
    head = any(p.startswith(("mu", "var")) for p in parts)
    if head and leaf in ("weight", "wq") and ndim == 2:
        return COLUMN
    if head and leaf in ("bias", "scale") and ndim == 1:
        return COLUMN
    if "mlp" in parts and "fc1" in parts:
        if leaf == "weight" and ndim == 2:
            return COLUMN
        if leaf == "bias":
            return COLUMN
    if "mlp" in parts and "fc2" in parts and leaf == "weight" and ndim == 2:
        return ROW
    if parts[-2:] == ["fc", "weight"] and ndim == 2:
        return COLUMN
    if parts[-2:] == ["fc", "bias"]:
        return COLUMN
    if parts[-2:] == ["fc2", "weight"] and ndim == 2:
        return ROW
    return None


def _halves(name: str, shapes: Mapping[str, Sequence[int]]) -> int:
    """2 for a SwiGLU head's fc weight or bias (its output width twice its
    fc2's input width, as core/convert.branch_spec tells the heads apart),
    split in each half; else 1."""
    parts = name.split(".")
    if parts[-2:] not in (["fc", "weight"], ["fc", "bias"]):
        return 1
    fc2 = ".".join(parts[:-2] + ["fc2", "weight"])
    if fc2 not in shapes or len(shapes[fc2]) != 2:
        return 1
    return 2 if shapes[name][0] == 2 * shapes[fc2][1] else 1


def tp_splits(shapes: Mapping[str, Sequence[int]]) -> Dict[str, Tuple[int, int]]:
    """{name: (axis, halves)} of every tensor the table splits, from the
    names and shapes of a state dict (whole or a rank's block: a SwiGLU
    fc keeps twice its fc2's input width in both)."""
    out = {}
    for name, shape in shapes.items():
        axis = tp_rule(name, len(shape))
        if axis is not None:
            out[name] = (axis, _halves(name, shapes))
    return out


def _blocks_view(t: torch.Tensor, axis: int, halves: int, size: int) -> torch.Tensor:
    """t with `axis` viewed as [halves, size, n / (halves size)]: [:, r] is
    rank r's block."""
    n = t.shape[axis]
    if n % (halves * size):
        raise ValueError(f"cannot split {n} over {size} ranks"
                         f"{' in each half' if halves > 1 else ''}: the port splits evenly")
    return t.reshape(t.shape[:axis] + (halves, size, n // (halves * size)) + t.shape[axis + 1:])


def split_tensor(t: torch.Tensor, axis: int, halves: int, index: int,
                 size: int) -> torch.Tensor:
    """Rank `index`'s block of t along `axis` (each half's block, in half
    order, where halves is 2), a contiguous copy."""
    v = _blocks_view(t, axis, halves, size).select(axis + 1, index)
    return v.reshape(t.shape[:axis] + (-1,) + t.shape[axis + 1:]).contiguous()


def join_blocks(blocks: Sequence[torch.Tensor], axis: int, halves: int) -> torch.Tensor:
    """The inverse of `split_tensor` over every rank's block, in rank order."""
    v = [b.reshape(b.shape[:axis] + (halves, -1) + b.shape[axis + 1:]) for b in blocks]
    t = torch.stack(v, dim=axis + 1)
    return t.reshape(t.shape[:axis] + (-1,) + t.shape[axis + 3:])


def split_state_dict(sd: Mapping[str, torch.Tensor], index: int,
                     size: int) -> Dict[str, torch.Tensor]:
    """Rank `index`'s shard of a one-device state dict over a 'model' axis
    of `size`: the split tensors' blocks, the others as they are."""
    splits = tp_splits({k: tuple(v.shape) for k, v in sd.items()})
    return {k: split_tensor(v, *splits[k], index, size) if k in splits else v
            for k, v in sd.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The one-device state dict of every rank's shard (in rank order): the
    inverse of `split_state_dict`."""
    splits = tp_splits({k: tuple(v.shape) for k, v in shards[0].items()})
    return {k: join_blocks([s[k] for s in shards], *splits[k]) if k in splits else v
            for k, v in shards[0].items()}


@torch.no_grad()
def all_gather_state_dict(sd: Mapping[str, torch.Tensor],
                          tp: ModelAxis) -> Dict[str, torch.Tensor]:
    """The one-device state dict from this rank's shard, on every rank of
    the model group: each split tensor's whole, an all-reduce of a
    zero-filled buffer in which each rank wrote its block."""
    splits = tp_splits({k: tuple(v.shape) for k, v in sd.items()})
    out = {}
    for k, v in sd.items():
        if k not in splits:
            out[k] = v
            continue
        axis, halves = splits[k]
        shape = list(v.shape)
        shape[axis] *= tp.size
        whole = v.new_zeros(shape)
        _blocks_view(whole, axis, halves, tp.size).select(axis + 1, tp.index).copy_(
            v.reshape(v.shape[:axis] + (halves, -1) + v.shape[axis + 1:]))
        dist.all_reduce(whole, group=tp.group)
        out[k] = whole
    return out


# ------------------------------------------------------------------ placement


def _tensors(module: torch.nn.Module):
    """(owner module, attribute, full name, tensor, is a parameter) of every
    parameter and buffer."""
    for mname, m in module.named_modules():
        for store, is_param in ((m._parameters, True), (m._buffers, False)):
            for attr, t in store.items():
                if t is not None:
                    yield m, attr, f"{mname}.{attr}" if mname else attr, t, is_param


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Every parameter and buffer broadcast, in place, from the mesh's
    first rank (over 'model', then over 'data'), so that replicas built
    from different seeds agree (what device_put with a replicated sharding
    means in the JAX package)."""
    for axis in (MODEL_AXIS, DATA_AXIS):
        if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
            continue
        group = mesh.get_group(axis)
        src = dist.get_global_rank(group, 0)
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src, group=group)
    return module


@torch.no_grad()
def split_module(module: torch.nn.Module, tp: ModelAxis,
                 in_place: bool = True) -> torch.nn.Module:
    """The module with every tensor `tp_rule` splits cut to rank tp.index's
    block and `tp` given to every module that runs split tensors (those
    with a `tp` attribute). in_place False: a copy that holds the blocks
    and shares every replicated tensor with `module`, which is left as it
    was (without any kernel folds or packs: prepare them on the copy).
    A module holding a Swin backbone is refused (module docstring)."""
    from genconvit_tpu_torch.models.swin import SwinTransformer

    if any(isinstance(m, SwinTransformer) for m in module.modules()):
        raise ValueError("tensor parallelism does not run a Swin backbone: tp_rule splits "
                         "its blocks' mlp.fc1/mlp.fc2, but a Swin block has no all-reduce "
                         "and would return a partial MLP sum; run it data parallel only")
    items = list(_tensors(module))
    splits = tp_splits({name: tuple(t.shape) for _, _, name, t, _ in items})
    blocks = {}
    for m, attr, name, t, is_param in items:
        if name in splits:
            b = split_tensor(t, *splits[name], tp.index, tp.size)
            blocks[id(t)] = torch.nn.Parameter(b, t.requires_grad) if is_param else b
    if in_place:
        for m, attr, name, t, is_param in items:
            if id(t) in blocks:
                (m._parameters if is_param else m._buffers)[attr] = blocks[id(t)]
        out = module
    else:
        memo = {id(t): blocks.get(id(t), t) for _, _, _, t, _ in items}
        for m in module.modules():   # the kernel folds of the whole weights stay behind
            for attr in ("_kernel_weights", "_fused_weights"):
                if getattr(m, attr, None) is not None:
                    memo[id(getattr(m, attr))] = None
        out = copy.deepcopy(module, memo)
    for m in out.modules():
        if hasattr(m, "tp"):
            m.tp = tp
    return out


def shard_params(module: torch.nn.Module, mesh: DeviceMesh,
                 tensor_parallel: bool = False) -> torch.nn.Module:
    """The module replicated over the mesh (`replicate`), in place; with
    tensor_parallel, then split over 'model' in place (`split_module`):
    each rank keeps its block of the split tensors, and the ranks of one
    'data' group hold the same blocks."""
    replicate(module, mesh)
    if tensor_parallel:
        split_module(module, model_axis(mesh))
    return module


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Every gradient summed over `group`, in place: gradients of one dtype
    and device are flattened into buckets of up to GRAD_BUCKET elements, one
    all-reduce each; a contiguous gradient as large as a bucket goes alone,
    without a copy. The order is the parameters', the same on every rank."""
    pending: List[torch.Tensor] = []
    size = 0

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


def whole_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's one-device state dict: gathered over 'model' where the
    module is split (its `tp`; every rank of the model group must call
    it), its own otherwise."""
    sd = module.state_dict()
    tp = getattr(module, "tp", None)
    return sd if tp is None else all_gather_state_dict(sd, tp)


def load_whole_state_dict(module: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load a one-device state dict into the module: this rank's blocks of
    it where the module is split (`split_state_dict`)."""
    tp = getattr(module, "tp", None)
    module.load_state_dict(sd if tp is None else split_state_dict(sd, tp.index, tp.size))
