"""1-D interpolation: cubic spline (four boundary conditions), PCHIP and
linear (counterpart of xitorch_tpu/_impls/interpolate/interp_1d.py).

* Evaluation is ``torch.searchsorted`` (left side, as ``jnp.searchsorted``)
  and ``torch.gather``; batched knots against unbatched queries broadcast
  through :func:`match_dim`.
* Extrapolation is vectorised with ``torch.where`` masks; ``%`` is
  ``torch.remainder``, which matches ``jnp``'s ``%`` for negative input.
* The dense spline system (natural / clamped / not-a-knot / periodic) is
  built out of place (diagonal embeddings, the boundary rows joined on with
  ``torch.cat``; no index assignment into a tensor that may need grad, so
  gradients of any order reach x) and solved once at construction with
  ``torch.linalg.solve``.
* Natural and clamped splines on a 1-D knot vector of 128 or more knots
  take the O(n) tridiagonal route (:func:`spline_ks_tridiag`): the port's
  differentiable ``ops/tridiag.py::tridiag_solve``, which launches the
  Thomas kernel on CUDA tensors and runs its plain version on CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.ops.tridiag import tridiag_solve
from xitorch_tpu_torch.utils.bcast import match_dim
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["CubicSpline1D", "Pchip1D", "LinearInterp1D", "get_spline_mat_inv",
           "spline_tridiag_system", "spline_ks_tridiag"]

# the smallest knot count at which the natural / clamped spline takes the
# tridiagonal route by default (the reference's rule)
TRIDIAG_MIN_KNOTS = 128


def check_same_device(what: str, ref: torch.Tensor, *others) -> None:
    """Raise unless every tensor in ``others`` lies on ``ref``'s device."""
    for t in others:
        if torch.is_tensor(t) and t.device != ref.device:
            raise RuntimeError("%s: tensors on %s and %s; give them on one device"
                               % (what, ref.device, t.device))


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    # minimum(maximum(.)) as jnp.clip, so that a tie splits the gradient
    # between x and the bound as it does in JAX
    return torch.minimum(torch.maximum(x, lo), hi)


def _searchsorted_batched(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    # x: (*B, nr) sorted; xq: (*B, nrq) -> indices (*B, nrq)
    if x.dim() == 1:
        return torch.searchsorted(x, xq)
    return torch.searchsorted(x.contiguous(), xq.contiguous())


def _get_extrap_pos(xq: torch.Tensor, extrap: str, xmin, xmax) -> torch.Tensor:
    """Map out-of-bounds positions into [xmin, xmax]."""
    xqnorm = (xq - xmin) / (xmax - xmin)
    if extrap == "periodic":
        xqin = xqnorm % 1.0
    elif extrap == "mirror":
        xqabs = xqnorm.abs()
        xq_ceil = torch.floor(xqabs).to(torch.int64) + 1
        xqhalf = xq_ceil // 2
        xqin = (2 * xqhalf - xqabs) * (1 - (xq_ceil % 2) * 2)
    elif extrap == "bound":
        xqin = _clip(xqnorm, xqnorm.new_zeros(()), xqnorm.new_ones(()))
    else:
        raise RuntimeError("get_extrap_pos only works for periodic, mirror, bound")
    return xqin * (xmax - xmin) + xmin


class _BaseInterp1D:
    def __init__(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                 extrap=None, **unused):
        check_same_device("Interp1D", x, y)
        self._y_is_given = y is not None
        self._extrap = extrap
        self._xmin = torch.amin(x, dim=-1, keepdim=True)
        self._xmax = torch.amax(x, dim=-1, keepdim=True)
        self._y = y

    def __call__(self, xq: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self._y_is_given:
            y = self._y
        elif y is None:
            raise RuntimeError("y must be given")
        check_same_device("Interp1D", self._xmin, xq, y)

        extrap = self._extrap
        inbound = (xq >= self._xmin) & (xq <= self._xmax)

        if extrap in ("mirror", "periodic", "bound"):
            xq2 = torch.where(inbound, xq, _get_extrap_pos(xq, extrap, self._xmin, self._xmax))
            return self._interp(xq2, y)

        # evaluate on clamped positions, patch extrapolated entries after
        xq_safe = _clip(xq, self._xmin, self._xmax)
        yq = self._interp(xq_safe, y)
        if extrap is None or (isinstance(extrap, str) and extrap == "nan"):
            fill = torch.full_like(yq, float("nan"))
        elif isinstance(extrap, (int, float)) or (
                torch.is_tensor(extrap) and extrap.numel() == 1):
            fill = torch.zeros_like(yq) + extrap
        elif callable(extrap):
            fill = torch.broadcast_to(extrap(xq), yq.shape)
        else:
            raise RuntimeError(
                "Invalid extrap type (type: %s): %s" % (type(extrap), extrap))
        return torch.where(inbound, yq, fill)

    def _interp(self, xq, y):
        raise NotImplementedError


class CubicSpline1D(_BaseInterp1D):
    """Cubic-spline 1-D interpolation for non-uniform x.

    Keyword arguments
    -----------------
    bc_type: "natural" | "clamped" | "not-a-knot" | "periodic" (default
        "not-a-knot").
    extrap: int/float/one-element tensor (pad value), "mirror", "periodic",
        "bound", "nan", a callable, or None (default per bc_type:
        clamped->"mirror", periodic->"periodic", else "nan").
    use_tridiag: the O(n) tridiagonal route for natural / clamped on a 1-D
        knot vector (default: from 128 knots on).
    use_pallas: accepted for the JAX package's signature; the tridiagonal
        route always goes through ``ops/tridiag.py::tridiag_solve`` here.
    """

    def __init__(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                 bc_type: Optional[str] = None, extrap=None,
                 use_tridiag: Optional[bool] = None,
                 use_pallas: bool = False, **unused):
        if bc_type is None:
            bc_type = "not-a-knot"
        bc_types = ["natural", "clamped", "not-a-knot", "periodic"]
        if bc_type not in bc_types:
            raise RuntimeError(
                "Unimplemented %s bc_type. Available options: %s" % (bc_type, bc_types))
        if extrap is None:
            extrap = {"clamped": "mirror", "periodic": "periodic"}.get(bc_type, "nan")
        super().__init__(x, y, extrap=extrap)
        self.x = x
        self.bc_type = bc_type
        if use_tridiag is None:
            use_tridiag = bc_type in ("natural", "clamped") and x.dim() == 1 \
                and x.shape[-1] >= TRIDIAG_MIN_KNOTS
        self._use_tridiag = bool(use_tridiag) and bc_type in ("natural", "clamped") \
            and x.dim() == 1
        if not self._use_tridiag:
            self.spline_mat_inv = get_spline_mat_inv(x, bc_type)  # (*BX, nr, nr)
        if self._y_is_given:
            self.ks = self._solve_ks(y)

    def _solve_ks(self, y):
        if self._use_tridiag:
            return spline_ks_tridiag(self.x, y, self.bc_type)
        return einsum_hi("...ij,...j->...i", self.spline_mat_inv, y)

    def _interp(self, xq, y):
        ks = self.ks if self._y_is_given else self._solve_ks(y)
        return _hermite_interp(self.x, y, ks, xq)


def _left_index(x: torch.Tensor, xq: torch.Tensor):
    """``(x, xq, idxl)`` broadcast on their batch dims, with the index of
    each query's left knot (its interval clipped to the knots' range)."""
    x, xq_b = match_dim(x, xq)
    nr = x.shape[-1]
    idxr = torch.clamp(_searchsorted_batched(x, xq_b), 1, nr - 1)
    return x, xq_b, idxr - 1


def _hermite_interp(x, y, ks, xq):
    """Evaluate the cubic Hermite form with knot values y and knot slopes
    ks at query points xq (shared by the cubic spline and pchip)."""
    x, xq_b, idxl = _left_index(x, xq)
    x_b, y_b, ks_b, idxl_b = match_dim(x, y, ks, idxl)
    idxr_b = idxl_b + 1
    xl = torch.gather(x_b, -1, idxl_b)
    xr = torch.gather(x_b, -1, idxr_b)
    yl = torch.gather(y_b, -1, idxl_b)
    yr = torch.gather(y_b, -1, idxr_b)
    kl = torch.gather(ks_b, -1, idxl_b)
    kr = torch.gather(ks_b, -1, idxr_b)

    dxrl = xr - xl
    t = (xq_b - xl) / dxrl
    tinv = 1 - t
    tta = t * tinv * tinv
    ttb = t * tinv * t
    tyl = tinv + tta - ttb
    tyr = t - tta + ttb
    tkl = tta * dxrl
    tkr = -ttb * dxrl
    return yl * tyl + yr * tyr + kl * tkl + kr * tkr


class Pchip1D(_BaseInterp1D):
    """Monotone cubic (PCHIP, Fritsch-Carlson) 1-D interpolation: knot
    slopes as SciPy's PchipInterpolator (weighted harmonic means of the
    neighbouring secants, zero at local extrema, the monotonicity-clamped
    three-point end formula).

    Keyword arguments
    -----------------
    extrap: same options as cspline (default "nan").
    """

    def __init__(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                 extrap=None, **unused):
        super().__init__(x, y, extrap=extrap)
        self.x = x
        if self._y_is_given:
            self.ks = self._slopes(y)

    def _slopes(self, y):
        x, y = match_dim(self.x, y)
        h = x[..., 1:] - x[..., :-1]                     # (..., n-1)
        delta = (y[..., 1:] - y[..., :-1]) / h

        dl = delta[..., :-1]                             # (..., n-2)
        dr = delta[..., 1:]
        hl = h[..., :-1]
        hr = h[..., 1:]
        w1 = 2.0 * hr + hl
        w2 = hr + 2.0 * hl
        same_sign = (dl * dr) > 0
        # weighted harmonic mean where the secants agree in sign, else 0
        safe_dl = torch.where(same_sign, dl, 1.0)
        safe_dr = torch.where(same_sign, dr, 1.0)
        interior = torch.where(same_sign, (w1 + w2) / (w1 / safe_dl + w2 / safe_dr), 0.0)

        def edge(h0, h1, d0, d1):
            d = ((2.0 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
            return torch.where(d * d0 <= 0, 0.0,
                               torch.where((d0 * d1 < 0) & (d.abs() > 3.0 * d0.abs()),
                                           3.0 * d0, d))

        k0 = edge(h[..., :1], h[..., 1:2], delta[..., :1], delta[..., 1:2])
        kn = edge(h[..., -1:], h[..., -2:-1], delta[..., -1:], delta[..., -2:-1])
        return torch.cat([k0, interior, kn], dim=-1)

    def _interp(self, xq, y):
        ks = self.ks if self._y_is_given else self._slopes(y)
        return _hermite_interp(self.x, y, ks, xq)


class LinearInterp1D(_BaseInterp1D):
    """Linear 1-D interpolation for non-uniform x.

    Keyword arguments
    -----------------
    extrap: same options as CubicSpline1D (default "nan").
    """

    def __init__(self, x, y=None, extrap=None, **unused):
        super().__init__(x, y, extrap=extrap)
        self.x = x

    def _interp(self, xq, y):
        x, xq_b, idxl = _left_index(self.x, xq)
        x_b, y_b, idxl_b = match_dim(x, y, idxl)
        xl = torch.gather(x_b, -1, idxl_b)
        xr = torch.gather(x_b, -1, idxl_b + 1)
        yl = torch.gather(y_b, -1, idxl_b)
        yr = torch.gather(y_b, -1, idxl_b + 1)
        t = (xq_b - xl) / (xr - xl)
        return yl + (yr - yl) * t


def _row(nr: int, terms, like: torch.Tensor) -> torch.Tensor:
    """The (..., nr) rows with ``coeff`` at column ``j`` for each
    ``(coeff, j)`` in ``terms`` (entries of one column add up)."""
    out = 0
    for coeff, j in terms:
        e = torch.zeros(nr, dtype=like.dtype, device=like.device)
        e[j] = 1.0
        out = out + coeff[..., None] * e
    return out


def _end_rows(mat: torch.Tensor, first, last, add: bool = False) -> torch.Tensor:
    """``mat`` with its first and last rows replaced by (with ``add``: plus)
    the rows :func:`_row` makes of ``first`` and ``last``, out of place."""
    nr = mat.shape[-1]
    row0, rown = _row(nr, first, mat), _row(nr, last, mat)
    if add:
        mid = torch.zeros_like(mat[..., 1:-1, :])
        return mat + torch.cat([row0[..., None, :], mid, rown[..., None, :]], dim=-2)
    return torch.cat([row0[..., None, :], mat[..., 1:-1, :], rown[..., None, :]], dim=-2)


def get_spline_mat_inv(x: torch.Tensor, bc_type: str = "not-a-knot") -> torch.Tensor:
    """Matrix S with ks = S @ y giving the spline gradients at the knots:
    the tridiagonal-ish lhs and rhs from diagonal embeddings, the rows of
    the boundary condition, and one dense solve."""
    inv_dx = 1.0 / (x[..., 1:] - x[..., :-1])  # (*BX, nr-1)
    inv_dx_pad = F.pad(inv_dx, (1, 1))
    lhs_diag = (inv_dx_pad[..., :-1] + inv_dx_pad[..., 1:]) * 2  # (*BX, nr)
    lhs = (torch.diag_embed(lhs_diag) + torch.diag_embed(inv_dx, offset=1)
           + torch.diag_embed(inv_dx, offset=-1))

    inv_dx2_pad = (inv_dx_pad * inv_dx_pad) * 3
    rhs_diag = inv_dx2_pad[..., :-1] - inv_dx2_pad[..., 1:]
    rhs_off = inv_dx2_pad[..., 1:-1]
    rhs = (torch.diag_embed(rhs_diag) + torch.diag_embed(rhs_off, offset=1)
           - torch.diag_embed(rhs_off, offset=-1))

    if bc_type == "natural":
        pass
    elif bc_type == "clamped":
        one, zero = x.new_ones(x.shape[:-1]), x.new_zeros(x.shape[:-1])
        lhs = _end_rows(lhs, [(one, 0)], [(one, -1)])
        rhs = _end_rows(rhs, [(zero, 0)], [(zero, -1)])
    elif bc_type == "not-a-knot":
        h0, h1 = inv_dx[..., 0], inv_dx[..., 1]
        hn, hn1 = inv_dx[..., -1], inv_dx[..., -2]

        def sq(v):
            return v * v

        def cube(v):
            return v * v * v

        lhs = _end_rows(lhs, [(sq(h0), 0), (sq(h0) - sq(h1), 1), (-sq(h1), 2)],
                        [(-sq(hn), -1), (sq(hn1) - sq(hn), -2), (sq(hn1), -3)])
        rhs = _end_rows(rhs, [(2 * (-cube(h0)), 0), (2 * (cube(h0) + cube(h1)), 1),
                              (2 * (-cube(h1)), 2)],
                        [(2 * (-cube(hn)), -1), (2 * (cube(hn) + cube(hn1)), -2),
                         (2 * (-cube(hn1)), -3)])
    elif bc_type == "periodic":
        h1, h0 = inv_dx[..., -1], inv_dx[..., 0]
        h1_sq3, h0_sq3 = 3 * h1 * h1, 3 * h0 * h0
        lhs = _end_rows(lhs, [(h1, -2), (h1 * 2, 0)], [(h0, 1), (h0 * 2, -1)], add=True)
        rhs = _end_rows(rhs, [(-h1_sq3, -2), (h1_sq3, 0)], [(h0_sq3, 1), (-h0_sq3, -1)],
                        add=True)
    else:
        raise RuntimeError("Unknown boundary condition: %s" % bc_type)

    return torch.linalg.solve(lhs, rhs)


def spline_tridiag_system(x: torch.Tensor, y: torch.Tensor, bc_type: str):
    """The tridiagonal system ``T ks = r`` of the natural / clamped spline:
    ``(dl, d, du, r)`` with ``(nr,)`` diagonals in ``tridiag_solve``'s
    layout (``dl[0]`` and ``du[-1]`` are not read) and ``r`` of y's shape.

    x: (nr,); y: (*BY, nr).
    """
    dxinv0 = 1.0 / (x[1:] - x[:-1])  # (nr-1,)
    dxinv = F.pad(dxinv0, (1, 1))  # (nr+1,)
    diag = (dxinv[:-1] + dxinv[1:]) * 2  # (nr,)
    # sub- and super-diagonals in tridiag_solve's layout: dl[0] and du[-1]
    # are not read
    dl = F.pad(dxinv0, (1, 0))
    du = F.pad(dxinv0, (0, 1))

    dxinv2 = (dxinv * dxinv) * 3
    diagr = dxinv2[:-1] - dxinv2[1:]  # (nr,)
    udiagr = dxinv2[1:-1]  # (nr-1,)

    r = diagr * y
    r = r + F.pad(udiagr * y[..., 1:], (0, 1))
    r = r + F.pad(-udiagr * y[..., :-1], (1, 0))

    if bc_type == "clamped":
        one = x.new_ones(1)
        diag = torch.cat([one, diag[1:-1], one])
        du = F.pad(du[1:], (1, 0))
        dl = F.pad(dl[:-1], (0, 1))
        r = F.pad(r[..., 1:-1], (1, 1))
    elif bc_type != "natural":
        raise RuntimeError("tridiagonal spline path supports natural/clamped only")
    return dl, diag, du, r


def spline_ks_tridiag(x: torch.Tensor, y: torch.Tensor, bc_type: str) -> torch.Tensor:
    """Spline gradients ks for natural/clamped bc by an O(n) tridiagonal
    solve (the Thomas kernel on CUDA tensors, its plain version on CPU
    tensors) instead of the dense inverse.  The ``(nr,)`` diagonals
    broadcast against the ``(*BY, nr)`` right-hand side.

    x: (nr,); y: (*BY, nr) -> ks: (*BY, nr).
    """
    return tridiag_solve(*spline_tridiag_system(x, y, bc_type))
