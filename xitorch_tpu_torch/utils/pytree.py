"""Nested containers of tensors as one flat vector (the port's counterpart
of ``jax.tree_util`` and ``jax.flatten_util.ravel_pytree`` for what the
integrators need).

A tree is a tensor, or a dict, tuple, list or ``NamedTuple`` of trees.
Leaves are visited in the JAX order: dict keys sorted, sequences in order,
so a raveled state lines up element for element with the JAX package's.
Written by hand rather than with ``torch.utils._pytree`` (a private
module) because only these containers occur and the order must be JAX's.
Everything here is plain tensor code (``reshape``, ``cat``, slicing), so it
runs under ``torch.func.vmap`` and autograd.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch

__all__ = ["tree_flatten", "tree_unflatten", "tree_map", "ravel_pytree"]


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the containers."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return [leaf for p in parts for leaf in p[0]], ("dict", keys, [p[1] for p in parts])
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(v) for v in tree]
        kind = type(tree) if _is_namedtuple(tree) else ("tuple" if isinstance(tree, tuple)
                                                       else "list")
        return [leaf for p in parts for leaf in p[0]], (kind, None, [p[1] for p in parts])
    return [tree], None


def _count(treedef) -> int:
    if treedef is None:
        return 1
    return sum(_count(d) for d in treedef[2])


def tree_unflatten(treedef, leaves: List[Any]):
    """Inverse of :func:`tree_flatten`."""
    if treedef is None:
        (leaf,) = leaves
        return leaf
    kind, keys, defs = treedef
    vals, start = [], 0
    for d in defs:
        k = _count(d)
        vals.append(tree_unflatten(d, leaves[start:start + k]))
        start += k
    if kind == "dict":
        return dict(zip(keys, vals))
    if kind == "tuple":
        return tuple(vals)
    if kind == "list":
        return vals
    return kind(*vals)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*vals) for vals in zip(leaves, *others)])


def ravel_pytree(tree) -> Tuple[torch.Tensor, Callable]:
    """``(flat, unravel)``: the leaves raveled and joined into one vector of
    their promoted type, and the function that splits a vector back.
    ``unravel`` also takes leading dims, ``(*lead, n) -> leaves of shape
    (*lead, *leaf_shape)``, which turns a trajectory of flat states back
    into a tree of trajectories."""
    leaves, treedef = tree_flatten(tree)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [int(math.prod(s)) for s in shapes]
    if len(leaves) == 1:
        flat = leaves[0].reshape(-1)
    else:
        dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
        flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])

    def unravel(v: torch.Tensor):
        lead = tuple(v.shape[:-1])
        parts = torch.split(v, sizes, dim=-1) if len(sizes) > 1 else (v,)
        return tree_unflatten(treedef, [p.reshape(lead + s).to(dt)
                                        for p, s, dt in zip(parts, shapes, dtypes)])

    return flat, unravel
