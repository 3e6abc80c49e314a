"""1-D quadrature with differentiable bounds and parameters (counterpart of
xitorch_tpu/integrate/quad.py).

The fixed-node rules are explicit weighted sums, so autograd through them
gives the gradients to the bounds and the parameters, to any order; no
custom rule is needed.  The integrand's output may be a tensor or a
dict/tuple/list of tensors.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Sequence, Union

import torch

from xitorch_tpu_torch._impls.integrate.fixed_quad import leggauss, tanhsinh
from xitorch_tpu_torch.utils.misc import get_method
from xitorch_tpu_torch.utils.pytree import tree_map

__all__ = ["quad"]

_QUAD_METHODS = {
    "leggauss": leggauss,
    "tanhsinh": tanhsinh,
}


def _dtype_device(bounds, params):
    """The promoted floating type of the tensor bounds (of the tensor
    params where no bound is a tensor) and their device.  Where neither is
    a tensor: the default dtype, on torch's default device when that is a
    CUDA device, else on the current CUDA device."""
    def floats(vals):
        return [v for v in vals if torch.is_tensor(v) and v.is_floating_point()]

    tensors = floats(bounds) or floats(params)
    if tensors:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        return dtype, tensors[0].device
    dtype = torch.get_default_dtype()
    dev = torch.get_default_device()
    if dev.type == "cuda":
        return dtype, dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: quad runs on the card unless a bound or "
                           "parameter is a tensor on another device")
    return dtype, torch.device("cuda", torch.cuda.current_device())


def _isinf(v) -> bool:
    return math.isinf(float(v.detach() if torch.is_tensor(v) else v))


def quad(fcn: Callable, xl, xu,
         params: Sequence[Any] = (),
         bck_options: Mapping[str, Any] = {},
         method: Union[str, Callable, None] = None,
         **fwd_options):
    r"""Calculate :math:`y = \int_{x_l}^{x_u} f(x,\theta)\,dx`.

    fcn's output may be a tensor of any shape or a dict/tuple/list of
    tensors.  Infinite bounds are handled with the tan substitution.
    Gradients flow to xl, xu and params (first and second order).  The
    integral runs in the type and on the device of the tensors among the
    bounds and params (bounds given as Python numbers take them), else on
    the card in the default dtype (give a CPU tensor bound for the CPU).
    Methods:
    "leggauss" (default; option ``n`` = number of nodes), "tanhsinh"
    (double-exponential; handles endpoint singularities), or a custom
    callable ``(fcn, xl, xu, params, **cfg)`` taking one-element tensor
    bounds.

    Examples
    --------
    >>> import math, torch
    >>> from xitorch_tpu_torch.integrate import quad
    >>> w = torch.tensor(1.0, dtype=torch.float64)
    >>> val = quad(lambda x, w: torch.sin(w * x), 0.0, math.pi, params=(w,))
    >>> bool((val - 2.0).abs() < 1e-8)
    True
    """
    for name, v in (("xl", xl), ("xu", xu)):
        if torch.is_tensor(v) and v.numel() != 1:
            raise RuntimeError("%s must be a 1-element value" % name)
    if method is None:
        method = "leggauss"
    method_fcn = get_method("quad", _QUAD_METHODS, method)
    dtype, dev = _dtype_device((xl, xu), params)
    xl_t = torch.as_tensor(xl, dtype=dtype, device=dev).reshape(())
    xu_t = torch.as_tensor(xu, dtype=dtype, device=dev).reshape(())

    if _isinf(xl) or _isinf(xu):
        # infinite bounds: x = tan(t), dx = sec^2(t) dt
        def fcn2(t, *params):
            sec2 = 1.0 / torch.cos(t) ** 2
            return tree_map(lambda y: y * sec2, fcn(torch.tan(t), *params))

        return method_fcn(fcn2, torch.arctan(xl_t), torch.arctan(xu_t), params,
                          **fwd_options)
    return method_fcn(fcn, xl_t, xu_t, params, **fwd_options)


# docstring completion
from xitorch_tpu_torch._docstr.api_docstr import get_methods_docstr  # noqa: E402

quad.__doc__ = get_methods_docstr(quad, _QUAD_METHODS)
