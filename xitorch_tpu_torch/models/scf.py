"""DQC-style self-consistent field (SCF) loop, BASELINE config 5
(counterpart of xitorch_tpu/models/scf.py).

A partial eigendecomposition nested inside a fixed-point solve:

    rho* = density( eigvecs( H(rho*) ) ),

with gradients to the Hamiltonian's parameters flowing through BOTH
implicit layers: the equilibrium rule's adjoint solve (its Jacobian
products by the double-VJP trick) differentiates through ``symeig``'s
rule, the shifted-solve ``autograd.Function`` for the iterative methods
or the degeneracy-safe ``degen_eigh`` for exacteig.

A minimal Hartree-Fock-like model:
    H(rho) = (A + A^T)/2 + g * diag(rho),  occupy the lowest ``nocc``
    orbitals,  rho = sum_i |psi_i|^2.
"""
from __future__ import annotations

from typing import Optional

import torch

from xitorch_tpu_torch._core.linop import LinearOperator
from xitorch_tpu_torch.linalg import symeig
from xitorch_tpu_torch.optimize import equilibrium

__all__ = ["HamiltonianOp", "scf_density", "scf_energy"]


class HamiltonianOp(LinearOperator):
    """H = (A + A^T)/2 + g * diag(rho), matrix-free and hermitian, on the
    device of ``a``."""

    def __init__(self, a, g, rho):
        n = a.shape[-1]
        super().__init__(shape=(*a.shape[:-2], n, n), is_hermitian=True,
                         dtype=a.dtype, device=a.device)
        self.a = a
        self.g = g
        self.rho = rho

    def _getparamnames(self, prefix=""):
        return [prefix + "a", prefix + "g", prefix + "rho"]

    def _sym(self):
        return (self.a + self.a.mT) * 0.5

    def _mv(self, x):
        return (self._sym() @ x[..., None])[..., 0] + self.g * self.rho * x

    def _mm(self, x):
        return self._sym() @ x + (self.g * self.rho)[..., :, None] * x


def _eig_options(eig_method: str, eig_options: Optional[dict]) -> dict:
    opts = {"min_eps": 1e-9, "max_niter": 2000} if eig_method == "davidson" else {}
    if eig_options:
        opts.update(eig_options)
    return opts


def _density(a, g, rho, nocc: int, method: str, **eig_options):
    evals, evecs = symeig(HamiltonianOp(a, g, rho), nocc, "lowest", method=method,
                          **eig_options)
    return torch.sum(evecs * evecs.conj(), dim=-1).real


def scf_density(a, g, nocc: int = 2,
                eig_method: str = "davidson",
                scf_method: str = "broyden1",
                eig_options: Optional[dict] = None,
                **scf_options):
    """Solve the SCF fixed point rho = density(H(rho)) and return rho*.

    Gradients w.r.t. ``a`` and ``g`` flow through the nested implicit
    adjoints (equilibrium + symeig).  The default ``f_tol`` of 1e-9 suits
    float64; a float32 caller names its own (float32 eigenvectors leave the
    density's residual near 1e-6)."""
    n = a.shape[-1]
    eig_opts = _eig_options(eig_method, eig_options)
    cfg = {"f_tol": 1e-9, "maxiter": 1000}
    cfg.update(scf_options)

    def density_map(rho, a, g):
        return _density(a, g, rho, nocc, eig_method, **eig_opts)

    rho0 = torch.full((n,), float(nocc) / n, dtype=a.dtype, device=a.device)
    return equilibrium(density_map, rho0, params=(a, g), method=scf_method, **cfg)


def scf_energy(a, g, nocc: int = 2, **kwargs):
    """Total orbital energy at the SCF solution (differentiable)."""
    rho = scf_density(a, g, nocc=nocc, **kwargs)
    eig_method = kwargs.get("eig_method", "davidson")
    evals, _ = symeig(HamiltonianOp(a, g, rho), nocc, "lowest", method=eig_method,
                      **_eig_options(eig_method, kwargs.get("eig_options")))
    return torch.sum(evals)
