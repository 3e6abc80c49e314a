"""Docstring synthesizer: appends a "Methods" section listing each
registered method's keyword options to an API function's docstring
(counterpart of xitorch_tpu/_docstr/api_docstr.py; pure introspection).
"""
from __future__ import annotations

import inspect
from typing import Callable, Mapping, Sequence, Union

__all__ = ["get_methods_docstr"]


def get_methods_docstr(cls_or_func: Callable,
                       methods: Union[Sequence[Callable], Mapping[str, Callable]],
                       ignore_kwargs: Sequence[str] = ()) -> str:
    """Return the docstring of ``cls_or_func`` extended with a section per
    method documenting its name and keyword arguments."""
    method_template = """
    method="{name}"
    {sep}

    .. code-block:: python

        {fullsig}
{docstr}
"""
    res = cls_or_func.__doc__ or ""
    if isinstance(methods, Mapping):
        items = list(methods.items())
    else:
        items = [(getattr(m, "__name__", str(m)), m) for m in methods]

    for name, method in items:
        try:
            sig = inspect.signature(method)
        except (TypeError, ValueError):
            continue
        params = [p for pname, p in sig.parameters.items()
                  if p.kind == inspect.Parameter.KEYWORD_ONLY
                  or (p.default is not inspect.Parameter.empty
                      and pname not in ignore_kwargs)]
        arglist = ", ".join(
            "%s=%s" % (p.name,
                       repr(p.default)
                       if p.default is not inspect.Parameter.empty else "...")
            for p in params)
        fullsig = "%s(..., %s)" % (getattr(cls_or_func, "__name__", "fn"), arglist)
        docstr = inspect.cleandoc(method.__doc__ or "")
        docstr = "\n".join("    " + line for line in docstr.splitlines())
        res += method_template.format(
            name=name, sep="^" * (len(name) + 9), fullsig=fullsig, docstr=docstr)
    return res
