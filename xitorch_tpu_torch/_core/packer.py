"""Packer: a nested structure of tensors to a list of tensors or one flat
vector and back (counterpart of xitorch_tpu/_core/packer.py), on the
port's ``utils/pytree.py`` (dict keys sorted, sequences in order, as JAX
orders the leaves).  Gradients of a leaf used twice accumulate through
autograd, so the reference's aliasing bookkeeping is not needed.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch

from xitorch_tpu_torch.utils.pytree import ravel_pytree, tree_flatten, tree_unflatten

__all__ = ["Packer"]


class Packer:
    """Flatten/unflatten a nested structure (tensors in dicts, tuples,
    lists and NamedTuples) to a list of tensors or one flat vector.

    Example
    -------
    >>> import torch
    >>> packer = Packer({"a": torch.ones(3), "b": (torch.zeros(2),)})
    >>> flat = packer.get_param_tensor()
    >>> obj2 = packer.construct_from_tensor(flat * 2)
    """

    def __init__(self, obj: Any):
        self._obj = obj
        self._leaves, self._treedef = tree_flatten(obj)
        flat, self._unravel = ravel_pytree(obj)
        self._numel = flat.numel()

    @property
    def obj(self):
        return self._obj

    def get_param_tensor_list(self) -> List[torch.Tensor]:
        """Return the tensor leaves of the packed object."""
        return list(self._leaves)

    def get_param_tensor(self) -> torch.Tensor:
        """Return all leaves flattened into a single 1D tensor."""
        return ravel_pytree(self._obj)[0]

    def construct_from_tensor_list(self, leaves: Sequence[torch.Tensor]) -> Any:
        """Rebuild the structure from a list of tensor leaves."""
        return tree_unflatten(self._treedef, list(leaves))

    def construct_from_tensor(self, flat: torch.Tensor) -> Any:
        """Rebuild the structure from a single flat tensor."""
        if flat.numel() != self._numel:
            raise RuntimeError(
                "Packer.construct_from_tensor expects %d elements, got %d"
                % (self._numel, flat.numel()))
        return self._unravel(flat)
