"""Pytrees of the port: nested dicts and lists of tensors.

The JAX package keeps parameters, optimizer state and caches as pytrees
and walks them with ``jax.tree``. The port keeps the same nesting and
walks it here. Leaves are visited in JAX's order: the keys of a dict
sorted, the items of a list or tuple in order. A leaf's path key is the
reference checkpoint's: dict keys and list indices joined by ``/``
(``params/runs/0/mix/wq``).

bfloat16 leaves cross to numpy as their 16-bit patterns (``uint16``)
with the dtype name beside them: numpy has no bfloat16 of its own, and
the port does not depend on ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def leaves_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's order; a path is a tuple of dict
    keys and list indices."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in :func:`leaves`
    order, by ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ------------------------------------------------------------------ numpy
def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` that nothing else shares (an in-place update
    of ``t`` afterwards does not reach it), and numpy's name of its dtype
    (``float32``, ``int32``, ``bfloat16``); a bfloat16 tensor as its
    16-bit patterns."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = host.numpy()
    return arr, arr.dtype.name


def from_numpy(a, device, dtype: Optional[str] = None) -> torch.Tensor:
    """A tensor on ``device`` from a numpy array. ``dtype="bfloat16"``, or
    an array of ``ml_dtypes``' bfloat16, reads the array's 16-bit patterns
    as bfloat16, bit for bit (``torch.from_numpy`` refuses that type)."""
    a = np.array(a)                       # a writable host copy
    if (dtype or a.dtype.name) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_to_numpy(tree) -> Tuple[Any, Any]:
    """``(arrays, dtypes)``: two trees of ``tree``'s structure, the host
    copies of :func:`to_numpy` and their dtype names."""
    flat = [to_numpy(t) for t in leaves(tree)]
    return (unflatten(tree, [a for a, _ in flat]),
            unflatten(tree, [d for _, d in flat]))
