"""EditableModule: the protocol for objects whose methods read tensors of
their own (counterpart of xitorch_tpu/_core/editable_module.py).

A subclass names, per method, the attribute paths of the tensors that
affect that method's output; :meth:`EditableModule.assertparams` checks
the names against the tensors the method really reads, by the rule of
:func:`xitorch_tpu_torch._core.pure.make_pure`: every tensor requiring
grad that the method reads besides its arguments must be declared.
"""
from __future__ import annotations

from abc import abstractmethod
from typing import Callable, List

import torch

from xitorch_tpu_torch._core.pure import captured_tensors
from xitorch_tpu_torch.utils.exceptions import GetSetParamsError

__all__ = ["EditableModule"]


def _key(idx: str):
    try:
        return int(idx)
    except ValueError:
        return idx.strip("'\"")


def _get_attr_path(obj, name: str):
    """Follow a dotted / indexed path such as ``a.b[0]['k']``."""
    cur = obj
    for part in name.split("."):
        while "[" in part:
            base, rest = part.split("[", 1)
            idx, part2 = rest.split("]", 1)
            if base:
                cur = getattr(cur, base)
            cur = cur[_key(idx)]
            part = part2.lstrip(".")
            if not part:
                break
        if part:
            cur = getattr(cur, part)
    return cur


def _set_attr_path(obj, name: str, val) -> None:
    """Set what a :func:`_get_attr_path` path names."""
    if "[" in name.rsplit(".", 1)[-1]:
        container_name, idx = name.rsplit("[", 1)
        _get_attr_path(obj, container_name)[_key(idx.rstrip("]"))] = val
    elif "." in name:
        parent_name, attr = name.rsplit(".", 1)
        setattr(_get_attr_path(obj, parent_name), attr, val)
    else:
        setattr(obj, name, val)


def _del_attr_path(obj, name: str) -> None:
    """Delete the attribute a dotted path names."""
    if "." in name or "[" in name:
        parent_name, attr = name.rsplit(".", 1)
        delattr(_get_attr_path(obj, parent_name), attr)
    else:
        delattr(obj, name)


class EditableModule:
    """Protocol: declare, per method, which attribute paths hold tensors
    that affect that method's output."""

    @abstractmethod
    def getparamnames(self, methodname: str, prefix: str = "") -> List[str]:
        """Return names (dotted paths) of tensors affecting ``methodname``."""
        raise NotImplementedError

    def getparams(self, methodname: str) -> List[torch.Tensor]:
        return [_get_attr_path(self, n) for n in self.getparamnames(methodname)]

    def setparams(self, methodname: str, *params) -> int:
        names = self.getparamnames(methodname)
        if len(names) != len(params):
            raise GetSetParamsError(
                "setparams for %s expects %d params, got %d"
                % (methodname, len(names), len(params)))
        for n, p in zip(names, params):
            _set_attr_path(self, n, p)
        return len(params)

    def getuniqueparams(self, methodname: str) -> List[torch.Tensor]:
        seen = {}
        for p in self.getparams(methodname):
            seen.setdefault(id(p), p)
        return list(seen.values())

    def assertparams(self, method: Callable, *args, **kwargs) -> None:
        """Check ``getparamnames(method)`` by running ``method(*args,
        **kwargs)`` once: every floating-point tensor requiring grad that
        it reads besides its arguments must be declared (by identity).  A
        declared tensor the method does not read is not an error."""
        methodname = method.__name__
        declared = {id(d) for d in self.getparams(methodname)}
        missing = [c for c in captured_tensors(method, *args, **kwargs)
                   if (c.is_floating_point() or c.is_complex()) and id(c) not in declared]
        if missing:
            raise GetSetParamsError(
                "getparamnames for method %r of %s is missing %d tensor(s) that "
                "affect the output (tensors requiring grad that it reads)"
                % (methodname, type(self).__name__, len(missing)))
