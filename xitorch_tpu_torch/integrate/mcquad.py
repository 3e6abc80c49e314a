"""Monte-Carlo quadrature (expectation values) with score-function
gradients (counterpart of xitorch_tpu/integrate/mcquad.py).

The gradients, to any order, come from autograd through a
self-normalised importance-ratio surrogate:

    epf = sum_i w_i r_i f(x_i, θ_f) / sum_i w_i r_i,
    r_i = exp(logp(x_i, θ_p) - logp(x_i, θ_p).detach())

The samples are drawn once without gradients (sampling is never
differentiated).  At the evaluation point r_i = 1, so the value is the
plain weighted average; its first θ_p-derivative is E[(f - E[f])·∂logp],
and every higher derivative is the corresponding importance-sampling
identity.  ``ffcn`` and ``log_pfcn`` take one sample, so they run over the
samples through ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence, Union

import torch
from torch.func import vmap

from xitorch_tpu_torch._impls.integrate.mcmc import dummy1d, mh, mhcustom
from xitorch_tpu_torch.utils.misc import get_method, partition_params
from xitorch_tpu_torch.utils.pytree import tree_map
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["mcquad"]

_MCQUAD_METHODS = {
    "mh": mh,
    "mhcustom": mhcustom,
    "_dummy1d": dummy1d,
    "dummy1d": dummy1d,
}


def mcquad(ffcn: Callable, log_pfcn: Callable, x0: torch.Tensor,
           fparams: Sequence[Any] = (),
           pparams: Sequence[Any] = (),
           bck_options: Mapping[str, Any] = {},
           method: Union[str, Callable, None] = None,
           **fwd_options):
    r"""Compute :math:`\mathbb{E}_p[f]` by Monte-Carlo sampling of
    ``log_pfcn(x, *pparams)`` (unnormalised) and averaging
    ``ffcn(x, *fparams)`` (a tensor or a dict/tuple/list of tensors), on the
    device of ``x0``.

    Gradients (any order) flow to fparams and pparams; sampling itself is
    treated as non-differentiable (score-function estimator).

    Methods: "mh" (Metropolis-Hastings, nchains parallel chains; options
    nsamples, nburnout, step_size, nchains, seed/generator), "mhcustom"
    (option custom_step(generator, x, *pparams)), "dummy1d" (deterministic
    1-D test sampler; options nsamples, lb, ub), or a custom callable
    ``(log_pfcn, x0, pparams, **cfg)`` returning ``(xsamples, wsamples)``.

    Examples
    --------
    >>> import torch
    >>> from xitorch_tpu_torch.integrate import mcquad
    >>> mu = torch.tensor([0.5], dtype=torch.float64)
    >>> ev = mcquad(lambda x: x, lambda x, mu: -0.5 * ((x - mu) ** 2).sum(),
    ...             torch.zeros(1, dtype=torch.float64), pparams=(mu,),
    ...             method="dummy1d", nsamples=100)
    >>> bool((ev[0] - 0.5).abs() < 1e-4)
    True
    """
    if method is None:
        method = "mh"
    method_fcn = get_method("mcquad", _MCQUAD_METHODS, method)

    fdyn, fmerge = partition_params(fparams)
    pdyn, pmerge = partition_params(pparams)

    # draw samples with gradients blocked
    with torch.no_grad():
        xs, ws = method_fcn(lambda x, *pd: log_pfcn(x, *pmerge(pd)), x0.detach(),
                            tuple(p.detach() for p in pdyn), **fwd_options)
    xs, ws = xs.detach(), ws.detach()

    # self-normalised importance-ratio surrogate (exact value, exact grads)
    logp = vmap(lambda x: log_pfcn(x, *pmerge(pdyn)))(xs).reshape(xs.shape[0])
    wr = ws * torch.exp(logp - logp.detach())
    denom = torch.sum(wr)
    fs = vmap(lambda x: ffcn(x, *fmerge(fdyn)))(xs)  # leaves with a leading nsamples
    return tree_map(lambda v: einsum_hi("n,n...->...", wr.to(v.dtype), v) / denom, fs)


# docstring completion
from xitorch_tpu_torch._docstr.api_docstr import get_methods_docstr  # noqa: E402

mcquad.__doc__ = get_methods_docstr(mcquad, {"mh": mh, "mhcustom": mhcustom})
