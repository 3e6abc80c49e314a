"""Sampled-quadrature weight matrices: cumulative integration of samples
(counterpart of xitorch_tpu/_impls/integrate/samples_quad.py).

Every weight matrix is built vectorised and out of place (index masks,
diagonal embeddings and products with one-hot matrices; no index
assignment into a tensor that may need grad), so the weights are
differentiable in the sample positions x at any order.
Each contraction runs in IEEE float32 (``einsum_hi``), never TF32, as the
reference's are ``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from xitorch_tpu_torch._impls.interpolate.interp_1d import get_spline_mat_inv
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["CubicSplineSQuad", "TrapzSQuad", "SimpsonSQuad",
           "get_trapz_weights", "get_simpson_weights", "get_cspline_grad_weights"]


def _lower_masks(nx: int, like: torch.Tensor):
    """``(j < i, j <= i)`` as (nx, nx) matrices of ``like``'s type."""
    i = torch.arange(nx, device=like.device)[:, None]
    j = torch.arange(nx, device=like.device)[None, :]
    return (j < i).to(like.dtype), (j <= i).to(like.dtype)


def get_trapz_weights(x: torch.Tensor) -> torch.Tensor:
    """W (.., nx, nx) with z_i = sum_j W[i,j] y_j the cumulative trapezoid."""
    dx = x[..., 1:] - x[..., :-1]  # (..., nx-1)
    dxp = F.pad(dx, (0, 1))  # dx_j (j=nx-1 -> 0)
    dxm = F.pad(dx, (1, 0))  # dx_{j-1} (j=0 -> 0)
    lt, le = _lower_masks(x.shape[-1], x)
    # coeff of y_j in z_i: 0.5*(dx_j [j<i] + dx_{j-1} [j<=i])
    return 0.5 * (dxp[..., None, :] * lt + dxm[..., None, :] * le)


def get_cspline_grad_weights(x: torch.Tensor) -> torch.Tensor:
    """Weights on the spline gradients k: coeff (dx^2/12)(k_j - k_{j+1})
    accumulated (Holmes quadrature)."""
    dx = x[..., 1:] - x[..., :-1]
    f = dx * dx / 12.0
    fp = F.pad(f, (0, 1))   # f_j, j=nx-1 -> 0
    fm = F.pad(f, (1, 0))   # f_{j-1}, j=0 -> 0
    lt, le = _lower_masks(x.shape[-1], x)
    # z_i += sum_{k<i} f_k (k_k - k_{k+1}): coeff of k_j = f_j [j<i] - f_{j-1} [j<=i]
    return fp[..., None, :] * lt - fm[..., None, :] * le


def _one_hot(rows: int, cols: int, start: int, like: torch.Tensor) -> torch.Tensor:
    """(rows, cols) with a one at (j, start + 2 j) for each row j."""
    j = torch.arange(rows, device=like.device)[:, None]
    c = torch.arange(cols, device=like.device)[None, :]
    return (c == start + 2 * j).to(like.dtype)


def get_simpson_weights(x: torch.Tensor) -> torch.Tensor:
    """Composite Simpson weights for irregularly spaced samples.

    The reference adds, for each pair of intervals j (ending at sample
    i = 2 j + 2), eta_j, beta_j, alpha_j to columns i-2, i-1, i of every
    row from i on, then a three-point end correction on each odd row from
    3 on, and the trapezoid on the first interval in row 1.  Here the
    first part is one product of a row mask (rows >= 2 j + 2) with the
    pairs' one-hot column rows, the end correction three diagonal
    embeddings: each entry receives the same terms in the same order.
    """
    h = x[..., 1:] - x[..., :-1]
    h1 = h[..., 1::2]
    h0 = h[..., :-1:2]
    h1_2, h0_2 = h1 * h1, h0 * h0
    h1_3, h0_3 = h1_2 * h1, h0_2 * h0
    alpha = (2 * h1_3 - h0_3 + 3 * h0 * h1_2) / (6 * h1 * (h1 + h0))
    eta = (2 * h0_3 - h1_3 + 3 * h1 * h0_2) / (6 * h0 * (h1 + h0))
    beta = (h1_3 + h0_3 + 3 * h1 * h0 * (h1 + h0)) / (6 * h1 * h0)
    hN1 = h[..., 2::2]
    hN2 = h[..., 1:-1:2]
    alpha_l = (2 * hN1 * hN1 + 3 * hN1 * hN2) / (6 * (hN1 + hN2))
    eta_l = hN1 * hN1 * hN1 / (6 * hN2 * (hN1 + hN2))
    beta_l = (hN1 * hN1 + 3 * hN1 * hN2) / (6 * hN2)

    nx = x.shape[-1]
    npair, nend = (nx - 1) // 2, (nx - 2) // 2
    # pair j's coefficients on its three columns: (..., npair, nx)
    cols = (eta[..., :, None] * _one_hot(npair, nx, 0, x)
            + beta[..., :, None] * _one_hot(npair, nx, 1, x)
            + alpha[..., :, None] * _one_hot(npair, nx, 2, x))
    rows = torch.arange(nx, device=x.device)[:, None]
    pairs = torch.arange(npair, device=x.device)[None, :]
    reach = (rows >= 2 * pairs + 2).to(x.dtype)  # (nx, npair)
    res = einsum_hi("ij,...jk->...ik", reach, cols)
    # the end correction on rows 3, 5, ...: (i, i), (i, i-1), (i, i-2)
    onrow = _one_hot(nend, nx, 3, x)
    d0 = einsum_hi("...j,jk->...k", alpha_l, onrow)
    d1 = einsum_hi("...j,jk->...k", beta_l, onrow)
    d2 = einsum_hi("...j,jk->...k", -eta_l, onrow)
    res = (res + torch.diag_embed(d2[..., 2:], offset=-2)
           + torch.diag_embed(d1[..., 1:], offset=-1) + torch.diag_embed(d0))
    # trapezoidal for the first interval
    row1 = torch.zeros((nx, nx), dtype=x.dtype, device=x.device)
    row1[1, :2] = 1.0
    return res + (0.5 * h[..., 0])[..., None, None] * row1


class _SQuadBase:
    def cumsum(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def integrate(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class CubicSplineSQuad(_SQuadBase):
    r"""Cumulative integration assuming cubic-spline interpolation (Holmes
    quadrature): S = sum[ (y_i+y_{i+1})/2 + (k_i - k_{i+1}) dx^2/12 ].

    Keyword arguments
    -----------------
    bc_type: str
        Boundary condition for the spline (default "natural").
    """

    def __init__(self, x: torch.Tensor, bc_type: str = "natural", **unused):
        self.spline_mat = get_spline_mat_inv(x, bc_type=bc_type)  # (nx, nx)
        self.wy = get_trapz_weights(x)
        self.wk = get_cspline_grad_weights(x)

    def cumsum(self, y):
        ks = einsum_hi("...ij,...j->...i", self.spline_mat, y)
        return (einsum_hi("...ij,...j->...i", self.wk, ks)
                + einsum_hi("...ij,...j->...i", self.wy, y))

    def integrate(self, y):
        ks = einsum_hi("...ij,...j->...i", self.spline_mat, y)
        return (einsum_hi("...j,...j->...", self.wk[..., -1, :], ks)
                + einsum_hi("...j,...j->...", self.wy[..., -1, :], y))


class _WeightBasedSQuad(_SQuadBase):
    def __init__(self, x: torch.Tensor, **options):
        self.w = self.get_weights(x, **options)

    def get_weights(self, x, **options):
        raise NotImplementedError

    def cumsum(self, y):
        return einsum_hi("...ij,...j->...i", self.w, y)

    def integrate(self, y):
        return einsum_hi("...j,...j->...", self.w[..., -1, :], y)


class TrapzSQuad(_WeightBasedSQuad):
    """Cumulative trapezoidal integration."""

    def get_weights(self, x, **unused):
        return get_trapz_weights(x)


class SimpsonSQuad(_WeightBasedSQuad):
    """Composite Simpson integration for irregular samples."""

    def get_weights(self, x, **unused):
        return get_simpson_weights(x)
