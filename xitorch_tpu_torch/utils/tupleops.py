"""Arithmetic over nested structures of tensors (counterpart of
xitorch_tpu/utils/tupleops.py), on the port's ``utils/pytree.py``."""
from xitorch_tpu_torch.utils.pytree import tree_flatten, tree_map

__all__ = ["tuple_axpy1"]


def tuple_axpy1(a, x, y):
    """a*x + y elementwise over matching trees (``a`` a scalar, a tensor
    or a tree of the same structure)."""
    if tree_flatten(a)[1] is None:
        return tree_map(lambda xx, yy: a * xx + yy, x, y)
    return tree_map(lambda aa, xx, yy: aa * xx + yy, a, x, y)
