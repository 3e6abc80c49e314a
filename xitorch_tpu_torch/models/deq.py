"""Deep Equilibrium (DEQ) model (counterpart of xitorch_tpu/models/deq.py).

A DEQ layer's forward pass IS ``xitorch_tpu_torch.optimize.equilibrium``:
the hidden state solves z* = tanh(z W^T + x U^T + b), and training
gradients flow through the *solution* by the implicit function theorem.
``shard=True`` constrains the state's layout with
``parallel.with_batch_sharding``, as the JAX package constrains it over a
device mesh; on one device that is the state itself, so the result is
``shard=False``'s.  Training takes a ``torch.optim`` optimizer in place of
optax.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xitorch_tpu_torch.convert import _device
from xitorch_tpu_torch.optimize import equilibrium
from xitorch_tpu_torch.parallel import with_batch_sharding

__all__ = ["DEQParams", "init_deq", "deq_forward", "deq_loss", "train_step"]


class DEQParams(NamedTuple):
    W: torch.Tensor      # (h, h)
    U: torch.Tensor      # (h, d)
    b: torch.Tensor      # (h,)
    Wout: torch.Tensor   # (o, h)
    bout: torch.Tensor   # (o,)


def init_deq(generator: torch.Generator, d_in: int, hidden: int, d_out: int,
             dtype: torch.dtype = torch.float32, device=None) -> DEQParams:
    """Random parameters drawn from ``generator`` (on its own device), put
    on ``device`` (default: the card) as leaf tensors that require grad."""
    device = _device(device)

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device) * scale

    # spectral scaling keeps the fixed-point map contractive
    params = DEQParams(W=normal(hidden, hidden, scale=0.5 / hidden ** 0.5),
                       U=normal(hidden, d_in, scale=1.0 / d_in ** 0.5),
                       b=torch.zeros(hidden, dtype=dtype),
                       Wout=normal(d_out, hidden, scale=1.0 / hidden ** 0.5),
                       bout=torch.zeros(d_out, dtype=dtype))
    return DEQParams(*(p.to(device).requires_grad_() for p in params))


def _cell(z, W, U, b, x):
    # z: (batch, h); x: (batch, d)
    return torch.tanh(z @ W.T + x @ U.T + b)


def deq_forward(params: DEQParams, x: torch.Tensor,
                solver_kwargs: Optional[dict] = None,
                shard: bool = False) -> torch.Tensor:
    """Forward pass: solve the equilibrium and apply the readout.

    x: (batch, d_in) -> (batch, d_out), on the device of ``x``.  Gradients
    w.r.t. params flow through the fixed point implicitly (the backward
    keeps no solver iterations).  ``shard`` constrains the state's layout
    (``parallel.with_batch_sharding``; on one device, no change)."""
    cfg = {"method": "anderson_acc", "feat_ndims": 1, "msize": 6,
           "maxiter": 80, "f_tol": 1e-4, "x_tol": 1e-6}
    if solver_kwargs:
        cfg.update(solver_kwargs)
    z0 = torch.zeros((x.shape[0], params.W.shape[0]), dtype=x.dtype, device=x.device)

    def f(z, W, U, b, x):
        zn = _cell(z, W, U, b, x)
        return with_batch_sharding(zn) if shard else zn

    zstar = equilibrium(f, z0, params=(params.W, params.U, params.b, x), **cfg)
    return zstar @ params.Wout.T + params.bout


def deq_loss(params: DEQParams, x: torch.Tensor, y: torch.Tensor,
             solver_kwargs: Optional[dict] = None, shard: bool = False) -> torch.Tensor:
    pred = deq_forward(params, x, solver_kwargs=solver_kwargs, shard=shard)
    return torch.mean((pred - y) ** 2)


def train_step(params: DEQParams, optimizer: torch.optim.Optimizer, x, y,
               solver_kwargs: Optional[dict] = None, shard: bool = False):
    """One optimisation step with implicit gradients through the DEQ solve:
    ``optimizer`` (built over ``params``) updates them in place.  Returns
    ``(params, loss)``, the loss before the step."""
    optimizer.zero_grad()
    loss = deq_loss(params, x, y, solver_kwargs=solver_kwargs, shard=shard)
    loss.backward()
    optimizer.step()
    return params, loss.detach()
