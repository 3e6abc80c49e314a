"""Pure functions from callables that read tensors of their own
(counterpart of xitorch_tpu/_core/pure.py).

JAX's ``closure_convert`` hoists the closed-over values a transformation
may perturb (tracers) into explicit arguments.  The counterpart here is the
tensors that require grad which the callable reads other than through its
arguments: in its closure, in a bound object, inside an ``nn.Module``.
:func:`make_pure` finds them by running the callable once under a
``torch.overrides.TorchFunctionMode`` that records every tensor an
operation receives that is neither an argument nor made during the call.
``pure_fcn(*args, *consts)`` runs the callable under a mode that hands each
operation the given tensors in place of the captured ones (by identity),
so gradients reach the tensors passed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["make_pure", "make_sibling"]


def _tensors_in(obj, out: List[torch.Tensor]) -> None:
    if torch.is_tensor(obj):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _tensors_in(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors_in(o, out)


def _replaced(obj, new: Dict[int, torch.Tensor]):
    if torch.is_tensor(obj):
        return new.get(id(obj), obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_replaced(o, new) for o in obj)
    if isinstance(obj, dict):
        return {k: _replaced(o, new) for k, o in obj.items()}
    return obj


class _RecordReads(TorchFunctionMode):
    """Records the tensors requiring grad that operations receive, other
    than the ``known`` ones and those the operations themselves made."""

    def __init__(self, known: Sequence[torch.Tensor]):
        super().__init__()
        self.made = {id(t): t for t in known}
        self.reads: Dict[int, torch.Tensor] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        seen: List[torch.Tensor] = []
        _tensors_in((args, kwargs), seen)
        for t in seen:
            if t.requires_grad and id(t) not in self.made:
                self.reads.setdefault(id(t), t)
        out = func(*args, **kwargs)
        made: List[torch.Tensor] = []
        _tensors_in(out, made)
        for t in made:
            # kept alive here, so that no id is reused during the call
            self.made.setdefault(id(t), t)
        return out


class _Substitute(TorchFunctionMode):
    """Hands every operation ``new[id(t)]`` in place of each tensor ``t``."""

    def __init__(self, new: Dict[int, torch.Tensor]):
        super().__init__()
        self.new = new

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*_replaced(args, self.new), **_replaced(kwargs or {}, self.new))


def captured_tensors(fcn: Callable, *args, **kwargs) -> List[torch.Tensor]:
    """The tensors requiring grad that ``fcn(*args, **kwargs)`` reads other
    than through its arguments, in the order it first reads them (runs
    ``fcn`` once, with gradients enabled)."""
    known: List[torch.Tensor] = []
    _tensors_in((args, kwargs), known)
    rec = _RecordReads(known)
    with torch.enable_grad(), rec:
        fcn(*args, **kwargs)
    return list(rec.reads.values())


def make_pure(fcn: Callable, *example_args) -> Tuple[Callable, Sequence[Any]]:
    """Hoist the tensors ``fcn`` reads besides its arguments into explicit
    trailing arguments: returns ``(pure_fcn, consts)`` with
    ``pure_fcn(*args, *consts) == fcn(*args)``.  ``consts`` are the read
    tensors that require grad (none for a callable that captures no such
    tensor, as JAX's ``closure_convert`` hoists nothing from a concrete
    closure); ``pure_fcn`` computes with the tensors it is given in their
    place, so gradients flow to those.  The counterpart of the reference's
    ``get_pure_function``."""
    consts = tuple(captured_tensors(fcn, *example_args))
    nargs = len(example_args)

    def pure_fcn(*args_and_consts):
        if len(args_and_consts) != nargs + len(consts):
            raise TypeError("pure function of %s takes %d arguments and %d captured "
                            "tensors, got %d" % (getattr(fcn, "__name__", fcn), nargs,
                                                 len(consts), len(args_and_consts)))
        args, given = args_and_consts[:nargs], args_and_consts[nargs:]
        new = {id(c): g for c, g in zip(consts, given) if g is not c}
        if not new:
            return fcn(*args)
        with _Substitute(new):
            return fcn(*args)

    return pure_fcn, consts


def make_sibling(*pfcns):
    """Decorator marking a function as a sibling (same hidden state) of
    others.  Siblings here are ordinary closures over the same tensors, so
    this is an identity decorator kept for the reference's API."""
    def decorator(fcn):
        return fcn
    return decorator
