"""Model summaries (port of genconvit_tpu/utils/summary.py; the fork's
get_model_summary, ref pred_func_updated.py:332-341)."""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.nn as nn

from genconvit_tpu_torch.core.pytree import param_count, tree_bytes


def _line(path: Tuple[str, ...], n: int, nbytes: int) -> str:
    return f"  {'/'.join(path) or '(root)':40s} {n:>12,}  {nbytes / 1e6:8.1f} MB"


def _weights(m: nn.Module) -> List[torch.Tensor]:
    """What the JAX package's tree of the module holds: the floating-point
    tensors of its state dict (parameters, and BatchNorm's running mean
    and variance, the tree's 'mean' and 'var'; num_batches_tracked, an
    integer count, has no place there)."""
    return [t for t in m.state_dict(keep_vars=True).values() if t.is_floating_point()]


def _module_items(m: nn.Module):
    """A module's own weights and its children that hold weights, in
    registration order."""
    for name, p in m.named_parameters(recurse=False):
        yield name, p
    for name, b in m.named_buffers(recurse=False):
        if name not in m._non_persistent_buffers_set and b.is_floating_point():
            yield name, b
    for name, child in m.named_children():
        if _weights(child):
            yield name, child


def _sizes(x: Any) -> Tuple[int, int]:
    if isinstance(x, nn.Module):
        ts = _weights(x)
        return sum(t.numel() for t in ts), sum(t.numel() * t.element_size() for t in ts)
    return param_count(x), tree_bytes(x)


def model_summary(params_or_module: Any, max_depth: int = 2) -> str:
    """Per-subtree parameter counts, torchsummary-flavored. A tree of dicts
    and lists gives the JAX package's string for the same tree; a module
    is walked by its named children and its own weights (`_weights`:
    what its JAX tree would hold, so that the totals agree)."""
    lines: List[str] = []

    def walk(node: Any, path: Tuple[str, ...]):
        if isinstance(node, nn.Module):
            items = list(_module_items(node))
        elif isinstance(node, dict):
            items = list(node.items())
        elif isinstance(node, list):
            items = list(enumerate(node))
        else:
            items = None
        if len(path) >= max_depth or items is None:
            lines.append(_line(path, *_sizes(node)))
            return
        for k, v in items:
            walk(v, path + (str(k),))

    walk(params_or_module, ())
    lines.append(_line(("TOTAL",), *_sizes(params_or_module)))
    return "\n".join(lines)
