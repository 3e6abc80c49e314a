"""Neural ODE: a continuous-depth model on ``integrate.solve_ivp``
(counterpart of xitorch_tpu/models/node.py).

The layer's forward pass integrates dz/dt = f(t, z; θ) with the adaptive
RK45 solver; training gradients flow through the trajectory (default:
autograd through the solver's steps; ``adjoint="backsolve"`` gives the
continuous adjoint, O(1) memory in the steps).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xitorch_tpu_torch.convert import _device
from xitorch_tpu_torch.integrate import solve_ivp

__all__ = ["NODEParams", "init_node", "node_forward", "node_loss"]


class NODEParams(NamedTuple):
    W1: torch.Tensor    # (h, h+1) time-conditioned input weight
    b1: torch.Tensor    # (h,)
    W2: torch.Tensor    # (h, h)
    b2: torch.Tensor    # (h,)
    Win: torch.Tensor   # (h, d_in)
    Wout: torch.Tensor  # (o, h)
    bout: torch.Tensor  # (o,)


def init_node(generator: torch.Generator, d_in: int, hidden: int, d_out: int,
              dtype: torch.dtype = torch.float32, device=None) -> NODEParams:
    """Random parameters drawn from ``generator`` (on its own device), put
    on ``device`` (default: the card) as leaf tensors that require grad."""
    device = _device(device)
    s = 1.0 / hidden ** 0.5

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device) * scale

    params = NODEParams(W1=normal(hidden, hidden + 1, scale=s),
                        b1=torch.zeros(hidden, dtype=dtype),
                        W2=normal(hidden, hidden, scale=s),
                        b2=torch.zeros(hidden, dtype=dtype),
                        Win=normal(hidden, d_in, scale=1.0 / d_in ** 0.5),
                        Wout=normal(d_out, hidden, scale=s),
                        bout=torch.zeros(d_out, dtype=dtype))
    return NODEParams(*(p.to(device).requires_grad_() for p in params))


def _dynamics(t, z, W1, b1, W2, b2):
    # z: (batch, h); time-conditioned two-layer MLP vector field
    tcol = torch.broadcast_to(t, (*z.shape[:-1], 1)).to(z.dtype)
    h = torch.tanh(torch.cat([z, tcol], dim=-1) @ W1.T + b1)
    return torch.tanh(h @ W2.T + b2)


def node_forward(params: NODEParams, x: torch.Tensor,
                 t1: float = 1.0, method: str = "rk45",
                 adjoint: str = "autodiff",
                 solver_kwargs: Optional[dict] = None) -> torch.Tensor:
    """x (batch, d_in) -> (batch, d_out), integrating the hidden state from
    t=0 to t1 on the device of ``x``."""
    cfg = {"atol": 1e-6, "rtol": 1e-5, "max_steps": 256}
    if method not in ("rk45", "rk23"):
        cfg = {}
    if solver_kwargs:
        cfg.update(solver_kwargs)
    z0 = x @ params.Win.T
    ts = torch.tensor([0.0, t1], dtype=x.dtype, device=x.device)
    zt = solve_ivp(_dynamics, ts, z0, params=(params.W1, params.b1, params.W2, params.b2),
                   method=method, adjoint=adjoint, **cfg)
    return zt[-1] @ params.Wout.T + params.bout


def node_loss(params: NODEParams, x: torch.Tensor, y: torch.Tensor,
              **kwargs) -> torch.Tensor:
    pred = node_forward(params, x, **kwargs)
    return torch.mean((pred - y) ** 2)
