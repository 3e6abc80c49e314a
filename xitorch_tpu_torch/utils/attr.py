"""Attribute get/set/delete by dotted / indexed path, such as
``a.b[0]['k']`` (counterpart of xitorch_tpu/utils/attr.py).  The
EditableModule protocol uses the same helpers."""
from __future__ import annotations

from xitorch_tpu_torch._core.editable_module import (
    _del_attr_path, _get_attr_path, _set_attr_path,
)

__all__ = ["get_attr", "set_attr", "del_attr"]


def get_attr(obj, name: str):
    return _get_attr_path(obj, name)


def set_attr(obj, name: str, val) -> None:
    _set_attr_path(obj, name, val)


def del_attr(obj, name: str) -> None:
    _del_attr_path(obj, name)
