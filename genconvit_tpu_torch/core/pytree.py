"""Parameter-tree sizes (port of genconvit_tpu/core/pytree.py:44-50).

A tree is nested dicts and lists (tuples too) whose leaves are numpy arrays
or torch tensors; None is an empty subtree, as in a JAX pytree.
`live_params` and `cast_floats` are not ported: the converter already drops
the dead groups (core/convert.py), and the port casts modules.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a tree of dicts, lists and tuples."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _size_and_itemsize(x: Any):
    if isinstance(x, torch.Tensor):
        return x.numel(), x.element_size()
    a = np.asarray(x)
    return a.size, a.dtype.itemsize


def param_count(tree: Any) -> int:
    return sum(_size_and_itemsize(x)[0] for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(n * item for n, item in map(_size_and_itemsize, tree_leaves(tree)))
