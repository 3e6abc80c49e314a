"""Monte-Carlo samplers for mcquad (counterpart of
xitorch_tpu/_impls/integrate/mcmc.py).

Metropolis-Hastings as ``nchains`` parallel chains, a custom-stepper
variant, and the deterministic 1-D Gauss-Legendre "sampler" of the exact
tests.  ``logpfcn`` takes one sample (as the JAX package's does), so it
runs over the chains through ``torch.func.vmap``.  Draws come from a
``torch.Generator``: pass ``generator=``, or ``seed=`` for a new one on the
device of ``x0`` (the JAX package takes ``key=``/``seed=``); the same seed
does not give the JAX package's draws, so samples compare by their
statistics only.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

__all__ = ["mh", "mhcustom", "dummy1d"]


def _generator(generator: Optional[torch.Generator], seed: int, device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(int(seed))


def mh(logpfcn: Callable, x0: torch.Tensor, pparams=(),
       nsamples: int = 10000, nburnout: int = 5000, step_size: float = 1.0,
       nchains: int = 64, seed: int = 721, generator: Optional[torch.Generator] = None,
       **unused):
    """Metropolis-Hastings with Gaussian proposals, run as ``nchains``
    parallel chains: every step advances all chains at once, so the wall
    clock scales with ``nsamples/nchains`` steps instead of ``nsamples``.

    Keyword arguments
    -----------------
    nsamples: total number of collected samples (split across chains;
        rounded up to a multiple of ``nchains``).
    nburnout: number of burn-in steps *per chain*.
    step_size: proposal standard deviation.
    nchains: number of parallel chains (1: one sequential chain).
    seed / generator: seed of a new ``torch.Generator`` on x0's device, or
        the generator to draw from.
    """
    gen = _generator(generator, seed, x0.device)
    nchains = max(1, int(nchains))
    spc = -(-int(nsamples) // nchains)  # samples per chain
    logp = vmap(lambda xc: logpfcn(xc, *pparams))

    def chain_step(x, logpx):
        xnext = x + step_size * torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                            device=x.device)
        logpnext = logp(xnext)
        u = torch.rand((nchains,), generator=gen, dtype=logpnext.dtype, device=x.device)
        accept = torch.log(u) < logpnext - logpx
        x = torch.where(accept.reshape((nchains,) + (1,) * x0.dim()), xnext, x)
        return x, torch.where(accept, logpnext, logpx)

    # overdispersed starts: chain 0 anchors at x0 exactly, the rest start
    # from x0 + step_size * noise
    noise = torch.randn((nchains, *x0.shape), generator=gen, dtype=x0.dtype,
                        device=x0.device) * step_size
    noise[0] = 0.0
    x = x0[None] + noise
    # domain guard: a dispersed start may leave logpfcn's support, and a
    # chain started at logp = nan never accepts a move; such chains start
    # from the user's x0
    ok = torch.isfinite(logp(x)).reshape((nchains,) + (1,) * x0.dim())
    x = torch.where(ok, x, x0[None])
    logpx = logp(x)
    for _ in range(nburnout):
        x, logpx = chain_step(x, logpx)
    samples = []
    for _ in range(spc):
        x, logpx = chain_step(x, logpx)
        samples.append(x)
    samples = torch.stack(samples, dim=1).reshape(nchains * spc, *x0.shape)
    ntot = nchains * spc
    weights = torch.full((ntot,), 1.0 / ntot, dtype=samples.dtype, device=samples.device)
    return samples, weights


def mhcustom(logpfcn: Callable, x0: torch.Tensor, pparams=(),
             nsamples: int = 10000, nburnout: int = 5000,
             custom_step: Optional[Callable] = None,
             seed: int = 721, generator: Optional[torch.Generator] = None, **unused):
    """Metropolis sampling with a user-provided stepper
    ``custom_step(generator, x, *pparams) -> xnext`` (accept/reject already
    done).
    """
    if custom_step is None:
        raise RuntimeError("custom_step must be specified for mhcustom method")
    if not callable(custom_step):
        raise RuntimeError("custom_step option for mhcustom must be callable")
    gen = _generator(generator, seed, x0.device)
    x = x0
    for _ in range(nburnout):
        x = custom_step(gen, x, *pparams)
    samples = []
    for _ in range(nsamples):
        x = custom_step(gen, x, *pparams)
        samples.append(x)
    samples = torch.stack(samples)
    weights = torch.full((nsamples,), 1.0 / nsamples, dtype=samples.dtype,
                         device=samples.device)
    return samples, weights


def dummy1d(logpfcn: Callable, x0: torch.Tensor, pparams=(),
            nsamples: int = 100, lb: float = -np.inf, ub: float = np.inf,
            **unused):
    """Deterministic 1-D 'sampler': Gauss-Legendre nodes under the tan
    transform, weighted by exp(logp).  Exact for tests.
    """
    if x0.numel() != 1:
        raise RuntimeError("This dummy operation can only be done in 1D space")
    dtype, dev = x0.dtype, x0.device
    tu = torch.arctan(torch.as_tensor(ub, dtype=dtype, device=dev))
    tl = torch.arctan(torch.as_tensor(lb, dtype=dtype, device=dev))
    tlg_np, wlg_np = np.polynomial.legendre.leggauss(nsamples)
    tlg = torch.as_tensor(tlg_np, dtype=dtype, device=dev)
    wlg = torch.as_tensor(wlg_np, dtype=dtype, device=dev) * 0.5 * (tu - tl)
    tsamples = tlg * (0.5 * (tu - tl)) + 0.5 * (tu + tl)
    xsamples = torch.tan(tsamples).reshape(nsamples, *x0.shape)
    wt = torch.cos(tsamples) ** (-2.0)
    wp = vmap(lambda x: logpfcn(x, *pparams))(xsamples)
    wsamples = wt * wlg * torch.exp(wp.reshape(nsamples))
    wsamples = wsamples / torch.sum(wsamples)
    return xsamples, wsamples
