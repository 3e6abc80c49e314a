"""Batch-shape broadcasting helpers (counterpart of xitorch_tpu/utils/bcast.py).

Every operator and solver carries arbitrary leading batch dimensions which
broadcast against each other.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["normalize_bcast_dims", "get_bcasted_dims", "match_dim"]


def normalize_bcast_dims(*shapes: Sequence[int]):
    """Pad the given shapes with 1s at the front so they all have equal rank."""
    maxlen = max(len(shape) for shape in shapes)
    return [[1] * (maxlen - len(shape)) + list(shape) for shape in shapes]


def get_bcasted_dims(*shapes: Sequence[int]) -> Tuple[int, ...]:
    """Return the broadcasted shape of the given shapes."""
    return tuple(torch.broadcast_shapes(*[tuple(s) for s in shapes]))



def match_dim(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Broadcast all tensors on their leading (non-last) dimensions.

    The last dimension of each input is kept as-is; everything before it is
    broadcast to a common shape (views, no copies).  Used by the
    searchsorted/gather steps of interpolation.
    """
    batch = get_bcasted_dims(*[x.shape[:-1] for x in xs])
    return tuple(x.expand(*batch, x.shape[-1]) for x in xs)
