"""Batched one-sided Jacobi symmetric eigendecomposition and SVD
(counterpart of xitorch_tpu/ops/jacobi_eigh.py).

The dense decompositions of ``symeig``/``svd`` (BASELINE config 2: 64
matrices of 256 x 256, float32) run the classic one-sided (Hestenes)
Jacobi iteration on a row panel ``G^T``:

* a "column rotation" of the implicit ``G = A V`` is a row-pair rotation
  of the panel; no V is carried: for the Gershgorin-shifted PSD input the
  rows at convergence are the scaled eigenvectors (``v_i = g_i / |g_i|``,
  ``lam'_i = |g_i|``);
* the squared row norms ride along with every rotation analytically and
  are refreshed by a full reduction once per sweep, so a round needs one
  reduction (``gamma = <g_p, g_q>``) instead of three;
* pairing is the Brent-Luk round-robin tournament; a sweep is
  ``ceil((n-1)/6)*6`` rounds, as in the reference, so sweep counts compare;
* before the first sweep and after each, a Gram gauge measures the true
  ``max cos^2`` of the panel and the loop leaves once it is below
  ``tol^2``;
* rectangular panels (rows = columns of A) make the same iteration
  Hestenes' SVD.

On a CUDA float32 panel :func:`jacobi_sweep` launches the hand-written
kernel in ``csrc/jacobi_sweep.cu`` (:func:`jacobi_sweep_cuda`) or raises;
on a CPU panel it runs :func:`jacobi_sweep_plain`, the same algorithm in
PyTorch.  The kernel keeps a panel in shared memory when it fits
(``n * width * 4 B <= 219 KB``) and otherwise works in the output buffer
in device memory; each matrix is its own thread block with its own exit
and sweep count, and the rows keep their input order (the plain version
moves rows as the reference does, so its output is a row permutation of
the kernel's: every consumer sorts).

Not in this module yet: the spectral divide-and-conquer warm start
(``precondition=True``, with its ``_guard_warm_start``/``_rot_correct``
tail), the deflated path and complex input; each raises
``NotImplementedError`` naming the slice of the port that brings it.
The warm start changes how many sweeps run, never the result.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.ops.tridiag import use_kernel
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["jacobi_eigh", "jacobi_svd", "use_jacobi_for", "use_jacobi_svd_for",
           "jacobi_sweep", "jacobi_sweep_cuda", "jacobi_sweep_plain",
           "fits_jacobi_sweep"]

# global switch: degen_eigh / degen_svd dispatch the dense decomposition
# here when use_jacobi_for / use_jacobi_svd_for approve
ENABLED = True

_UNROLL = 6  # a sweep is ceil((n-1)/_UNROLL)*_UNROLL rounds (the reference's)

# Window of the kernel on the H100.  Rows: the carried norms are a static
# shared-memory array of _N_MAX floats (kMaxN in csrc/jacobi_sweep.cu).
# Width: a panel larger than the 227 KB a block may opt in to works in
# device memory, so the width is bounded only by keeping one panel
# (n * width * 4 B <= 16 MB) well inside the 50 MB L2.
_N_MAX = 1024
_W_MAX = 4096
# largest panel kept in shared memory: 227 KB less the static norm and
# reduction arrays (and headroom)
_SMEM_PANEL = 232448 - 8192

_NEXT_SLICE = ("the next slice of the port (config 2 warm start: the DC "
               "kernel, spectral_dc, _guard_warm_start/_rot_correct and the "
               "complex sweep kernel; see ROADMAP.md)")

_P = ctypes.c_void_p
_SIGNATURES = {
    "jacobi_sweep_f32": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_float,
                         ctypes.c_float, ctypes.c_int, _P],
}


def _eps_floor(dtype) -> float:
    return float(torch.finfo(dtype).tiny) * 16.0


def fits_jacobi_sweep(n: int, width: int, dtype) -> bool:
    """Whether an (n, width) panel lies in the kernel's window: float32,
    n even and at most 1024 rows, width at most 4096."""
    return bool(dtype == torch.float32 and n >= 2 and n % 2 == 0
                and n <= _N_MAX and 1 <= width <= _W_MAX)


# ------------------------------------------------------------------
# the sweep: plain version, kernel wrapper, dispatcher
# ------------------------------------------------------------------

def _max_cos2(G: torch.Tensor) -> torch.Tensor:
    """Gram gauge of a (B, n, width) panel: per matrix, the max over i != j
    of ``<g_i, g_j>^2 / max(|g_i|^2 |g_j|^2, 16 tiny)``, in IEEE float32."""
    n = G.shape[-2]
    nrm = (G * G).sum(-1)
    gram = dot_hi(G, G.mT)
    denom = torch.clamp(nrm[..., :, None] * nrm[..., None, :],
                        min=_eps_floor(G.dtype))
    ratio = gram * gram / denom
    eye = torch.eye(n, dtype=torch.bool, device=G.device)
    return ratio.masked_fill(eye, 0.0).amax(dim=(-2, -1))


def _rot_coeffs(nt, nb, gam, live_thresh: float):
    """Jacobi rotation (c, s) for row pairs with carried squared norms
    ``nt``/``nb`` and pair dot ``gam``; pairs already orthogonal (or zero)
    get the identity."""
    ratio = gam * gam / torch.clamp(nt * nb, min=_eps_floor(gam.dtype))
    live = ratio > live_thresh
    zeta = (nb - nt) / torch.where(live, 2.0 * gam, torch.ones_like(gam))
    sgn = torch.where(zeta >= 0, 1.0, -1.0).to(gam.dtype)
    t = sgn / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
    # 1/sqrt in IEEE rounding (the card's approximate rsqrt is biased, and
    # a bias in c^2 + s^2 adds up over the rotations of a sweep); any
    # error left is a common scale on (c, s) since s = c*t
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = c * t
    c = torch.where(live, c, torch.ones_like(c))
    s = torch.where(live, s, torch.zeros_like(s))
    return c, s


def _shuffle(h: int, top, bot):
    """Brent-Luk tournament shuffle along the pair axis (-2):
    new_top = [top0, bot0, top1..top_{h-2}], new_bot = [bot1.., top_{h-1}]."""
    if h == 1:
        return top, bot
    new_top = torch.cat([top[..., 0:1, :], bot[..., 0:1, :], top[..., 1:h - 1, :]],
                        dim=-2)
    new_bot = torch.cat([bot[..., 1:h, :], top[..., h - 1:h, :]], dim=-2)
    return new_top, new_bot


def _one_round(h: int, top, bot, nt, nb, live_thresh: float):
    gam = (top * bot).sum(-1, keepdim=True)
    c, s = _rot_coeffs(nt, nb, gam, live_thresh)
    # c top - s bot and s top + c bot, written so that 1 - c is never formed
    # by rounding c (tau = s/(1+c) = (1-c)/s): in float32 c rounds to 1 for
    # the many small rotations of the late sweeps, and applying c and s as
    # they are then stretches every such pair, always upwards (measured:
    # G^T G drifted by 5e-5 relative at n = 256, against 1e-6 in this form)
    tau = s / (1.0 + c)
    ntop = top - s * (bot + tau * top)
    nbot = bot + s * (top - tau * bot)
    # norms follow analytically: |c g_p - s g_q|^2 = c^2 a - 2 c s g + s^2 b
    cs2 = 2.0 * c * s * gam
    nt_new = c * c * nt + s * s * nb - cs2
    nb_new = s * s * nt + c * c * nb + cs2
    new_top, new_bot = _shuffle(h, ntop, nbot)
    new_nt, new_nb = _shuffle(h, nt_new, nb_new)
    return new_top, new_bot, new_nt, new_nb


def _check_panel(panel: torch.Tensor, what: str) -> None:
    if panel.dim() != 3 or panel.shape[-2] < 2 or panel.shape[-2] % 2:
        raise RuntimeError("%s expects a (B, n, width) panel with n even, got %s"
                           % (what, tuple(panel.shape)))


def jacobi_sweep_plain(panel: torch.Tensor, max_sweeps: int, tol: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep kernel on a (B, n, width) panel:
    the same rotations, pairing, norm carry, per-sweep refresh and gauge
    exit, each matrix leaving on its own gauge.  Returns ``(G, sweeps)``:
    the swept panel (rows in tournament order, a permutation of the
    input's) and each matrix's executed sweep count (B,) int32."""
    _check_panel(panel, "jacobi_sweep_plain")
    B, n, _ = panel.shape
    h = n // 2
    tol2 = tol * tol
    live_thresh = tol2 * 0.01
    rounds = -(-(n - 1) // _UNROLL) * _UNROLL
    G = panel.clone()
    sweeps = torch.zeros(B, dtype=torch.int32, device=panel.device)
    worst = _max_cos2(G) if B else G.new_zeros(0)
    for _ in range(max_sweeps):
        idx = (worst > tol2).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        g = G[idx]
        top, bot = g[:, :h], g[:, h:]
        # fresh norms once per sweep: kills the analytic-update drift
        nt = (top * top).sum(-1, keepdim=True)
        nb = (bot * bot).sum(-1, keepdim=True)
        for _r in range(rounds):
            top, bot, nt, nb = _one_round(h, top, bot, nt, nb, live_thresh)
        g = torch.cat([top, bot], dim=1)
        G[idx] = g
        sweeps[idx] += 1
        worst[idx] = _max_cos2(g)
    return G, sweeps


def jacobi_sweep_cuda(panel: torch.Tensor, max_sweeps: int, tol: float,
                      return_stats: bool = False):
    """Launch the sweep kernel on a contiguous float32 CUDA panel
    (B, n, width) inside the window of :func:`fits_jacobi_sweep`.  Returns
    ``(G, sweeps)`` (rows in the input's order), and with ``return_stats``
    also each matrix's last measured gauge (B,) float32 and its number of
    rotated pairs (B,) int32 (pairs skipped as orthogonal do not count)."""
    _check_panel(panel, "jacobi_sweep_cuda")
    if not panel.is_cuda or panel.dtype != torch.float32 or not panel.is_contiguous():
        raise RuntimeError("jacobi_sweep_cuda: expected a contiguous float32 CUDA "
                           "panel (B, n, width)")
    B, n, width = panel.shape
    if B == 0 or not fits_jacobi_sweep(n, width, panel.dtype):
        raise RuntimeError(
            "jacobi_sweep_cuda: a (%d, %d, %d) panel is outside the kernel's "
            "window (1 <= B, n even <= %d, width <= %d)"
            % (B, n, width, _N_MAX, _W_MAX))
    w4 = -(-width // 4) * 4
    # the kernel reads rows as float4: zero columns change no dot product
    a = F.pad(panel, (0, w4 - width)) if w4 != width else panel
    g = torch.empty_like(a)
    sweeps = torch.empty(B, dtype=torch.int32, device=panel.device)
    gauge = torch.empty(B, dtype=torch.float32, device=panel.device)
    rotations = torch.empty(B, dtype=torch.int32, device=panel.device)
    tol2 = tol * tol
    lib = _build.load("jacobi_sweep", _SIGNATURES)
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.jacobi_sweep_f32(a.data_ptr(), g.data_ptr(), sweeps.data_ptr(),
                                  gauge.data_ptr(), rotations.data_ptr(), B, n, w4,
                                  int(max_sweeps),
                                  tol2, tol2 * 0.01, _SMEM_PANEL, stream)
    _build.check(rc, "jacobi_sweep_cuda")
    jacobi_sweep_cuda.launches += 1
    if w4 != width:
        g = g[..., :width].contiguous()
    return (g, sweeps, gauge, rotations) if return_stats else (g, sweeps)


jacobi_sweep_cuda.launches = 0


def jacobi_sweep(panel: torch.Tensor, max_sweeps: int, tol: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sweep a (B, n, width) panel: the kernel for a CUDA tensor (or an
    error), the plain version for a CPU tensor.  Counterpart of
    ``_pallas_g_panel``; returns ``(G, sweeps)``."""
    if use_kernel(panel):
        return jacobi_sweep_cuda(panel.contiguous(), max_sweeps, tol)
    return jacobi_sweep_plain(panel, max_sweeps, tol)


# ------------------------------------------------------------------
# host side
# ------------------------------------------------------------------

def _padded_n(n: int) -> int:
    """Working size for an (n, n) input: a multiple of 16, as the
    reference's sweep kernel takes (padding eigenvalues are placed above
    the spectrum and sliced off after the sort)."""
    return max(16, -(-n // 16) * 16)


def _newton_orthonormalize(V: torch.Tensor) -> torch.Tensor:
    """One Newton step ``V (3 I - V^T V) / 2``: squares the orthogonality
    drift away."""
    eye = torch.eye(V.shape[-1], dtype=V.dtype, device=V.device)
    return dot_hi(V, 1.5 * eye - 0.5 * dot_hi(V.mT, V))


def jacobi_eigh(A: torch.Tensor, *, max_sweeps: int = 18,
                tol: Optional[float] = None,
                precondition: Optional[bool] = None,
                deflate: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric eigendecomposition, ``torch.linalg.eigh`` contract.

    ``A``: (*B, n, n) real symmetric.  Returns ascending eigenvalues
    (*B, n) and column eigenvectors (*B, n, n).  Raw entry without
    derivatives; ``degen_eigh`` wraps it with the degeneracy-safe
    gradient.  Pads n to a multiple of 16 internally.

    ``precondition=None`` resolves to the cold sweep; the warm start
    (``precondition=True``) and ``deflate=True`` are not ported yet.
    """
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError("jacobi_eigh expects (*B, n, n), got %s" % (tuple(A.shape),))
    if A.is_complex():
        raise NotImplementedError(
            "jacobi_eigh: complex hermitian input needs the complex sweep "
            "kernel, which comes with " + _NEXT_SLICE)
    if precondition:
        raise NotImplementedError(
            "jacobi_eigh: precondition=True (the spectral divide-and-conquer "
            "warm start) comes with " + _NEXT_SLICE)
    if deflate:
        raise NotImplementedError(
            "jacobi_eigh: deflate=True builds on the DC kernel, which comes "
            "with " + _NEXT_SLICE)
    batch = A.shape[:-2]
    n = A.shape[-1]
    dt = A.dtype
    if tol is None:
        # the reachable floor: after a rotation, rounding leaves pair
        # cosines at ~eps*sqrt(n), so a tolerance below that can never be
        # met; 4*eps*sqrt(n) sits above the noise floor
        tol = float(torch.finfo(dt).eps) * 4.0 * math.sqrt(n)
    Bflat = math.prod(batch) if batch else 1
    a0 = A.reshape(Bflat, n, n)
    a = a0

    # PSD shift: sigma >= -lambda_min via the one-sided Gershgorin bound,
    # plus a 1% ||A||_F margin that floors the smallest shifted eigenvalue
    # (the eigenvector extraction divides by lambda'_i = |g_i|)
    absa = a.abs()
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    offsum = absa.sum(-1) - torch.diagonal(absa, dim1=-2, dim2=-1)
    lower = (diag - offsum).amin(-1)
    frob = torch.sqrt((absa * absa).sum(dim=(-2, -1)))
    sigma = torch.clamp(-lower, min=0.0) + 0.01 * frob + 1e-30
    # upper spectral bound of the shifted matrix, for the padding diagonal
    upper = (diag + offsum).amax(-1)
    top = torch.clamp(upper, min=0.0) + sigma

    npad = _padded_n(n)
    if npad != n:
        pad = npad - n
        a = F.pad(a, (0, pad, 0, pad))
        # padding block: diagonal above every true (shifted) eigenvalue
        pdiag = torch.zeros(npad, dtype=dt, device=A.device)
        pdiag[n:] = 2.0
        a = a + torch.diag_embed(pdiag)[None] * top[:, None, None]
    a = a + sigma[:, None, None] * torch.eye(npad, dtype=dt, device=A.device)

    gt, _ = jacobi_sweep(a, max_sweeps, tol)

    # row i of G^T is lambda'_i * v_i: norms are the shifted eigenvalues,
    # directions the eigenvectors
    lam = torch.sqrt((gt * gt).sum(-1))                         # (B, npad)
    vt = gt / torch.clamp(lam, min=_eps_floor(dt))[..., None]
    if npad != n:
        # the padding rows carry eigenvalues above every true one
        order = torch.argsort(lam, dim=-1)
        vt = torch.take_along_dim(vt, order[..., None], dim=-2)
    vt = vt[:, :n, :n]
    V = vt.mT

    # polish: one Newton orthonormalisation, then Rayleigh quotients on the
    # unshifted input recover eps*|A| (instead of eps*sigma) accuracy
    V = _newton_orthonormalize(V)
    AV = dot_hi(a0, V)
    lam = (V * AV).sum(-2)
    order = torch.argsort(lam, dim=-1)
    lam = torch.take_along_dim(lam, order, dim=-1)
    V = torch.take_along_dim(V, order[:, None, :], dim=-1)
    return lam.reshape(*batch, n), V.reshape(*batch, n, n)


def _complete_null_columns(Q: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    """Replace the columns of ``Q`` (B, m, r) flagged bad by ``good``
    (B, r) bool with an orthonormal completion of the good columns.

    Numerically-zero singular values leave zero rows in the Hestenes
    panel, hence zero (or junk) columns in U and V, while the library svd
    returns orthonormal null-space completions.  Bad slots get a fixed
    quasi-random fill projected against the good columns and
    orthonormalised among themselves by a masked CholQR (twice)."""
    B, mdim, r = Q.shape
    dt = Q.dtype
    g = good.to(dt)
    iot_m = torch.arange(mdim, dtype=dt, device=Q.device)[:, None]
    iot_r = torch.arange(r, dtype=dt, device=Q.device)[None, :]
    Fm = torch.sin(iot_m * (0.7391 * iot_r + 1.137) + 0.31 * iot_r)
    Fm = (Fm / math.sqrt(mdim)).expand(B, mdim, r)
    Qg = Q * g[:, None, :]
    Fm = Fm - dot_hi(Qg, dot_hi(Qg.mT, Fm))
    b = 1.0 - g
    Fb = Fm * b[:, None, :]
    eye = torch.eye(r, dtype=dt, device=Q.device)
    ridge = 16 * float(torch.finfo(dt).eps) / mdim
    for _ in range(2):
        Gm = dot_hi(Fb.mT, Fb)
        # good slots pinned to the identity so the factorisation stays SPD
        Gm = (Gm * (b[:, :, None] * b[:, None, :]) + eye * g[:, None, :]
              + eye * ridge * b[:, None, :])
        L = torch.linalg.cholesky(Gm)
        Y = torch.linalg.solve_triangular(L, Fb.mT, upper=False)  # L^-1 Fb^T
        Fb = Y.mT
    return Qg + Fb * b[:, None, :]


def jacobi_svd(A: torch.Tensor, *, max_sweeps: int = 18,
               tol: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched real economy SVD ``A = U diag(s) V^T`` by one-sided
    (Hestenes) Jacobi: the same sweep as :func:`jacobi_eigh`, run on the
    columns of A instead of on a Gram matrix, so singular values keep
    ~eps*kappa(A) relative error and no shift is needed.

    ``A``: (*B, m, n) real.  Returns ``(U (*B, m, r), s (*B, r)
    ASCENDING, V (*B, n, r))`` with ``r = min(m, n)``.  Directions in the
    numerical null space are arbitrary but orthonormal."""
    if A.dim() < 2:
        raise ValueError("jacobi_svd expects (*B, m, n), got %s" % (tuple(A.shape),))
    if A.is_complex():
        raise NotImplementedError(
            "jacobi_svd: complex input needs the complex sweep kernel, which "
            "comes with " + _NEXT_SLICE)
    batch = A.shape[:-2]
    m_, n_ = A.shape[-2], A.shape[-1]
    if m_ < n_:
        # work on A^T (tall): A^T = U' S V'^T  =>  A = V' S U'^T
        u, s, v = jacobi_svd(A.mT, max_sweeps=max_sweeps, tol=tol)
        return v, s, u
    dt = A.dtype
    if tol is None:
        tol = float(torch.finfo(dt).eps) * 4.0 * math.sqrt(n_)
    Bflat = math.prod(batch) if batch else 1
    a = A.reshape(Bflat, m_, n_)

    # panel rows = columns of A; pad the pair axis to a multiple of 16 with
    # zero rows (dead to every rotation: gamma = 0 skips the pair)
    npad = _padded_n(n_)
    panel = a.mT
    if npad != n_:
        panel = F.pad(panel, (0, 0, 0, npad - n_))
    gt, _ = jacobi_sweep(panel.contiguous(), max_sweeps, tol)   # (B, npad, m)

    # row i of G^T is s_i * u_i; the zero pads sort first
    lam = torch.sqrt((gt * gt).sum(-1))                        # (B, npad)
    order = torch.argsort(lam, dim=-1)[..., npad - n_:]        # ascending
    gt = torch.take_along_dim(gt, order[..., None], dim=-2)    # (B, n, m)
    lam = torch.take_along_dim(lam, order, dim=-1)
    tiny = _eps_floor(dt)
    U = (gt / torch.clamp(lam, min=tiny)[..., None]).mT

    # polish: one Newton orthonormalisation of U, then V from A^T U =
    # V diag(s).  s stays the row norms, and V's columns are normalised by
    # |A^T u_i| (not divided by s): recomputing would inflate exact-zero
    # singular values to junk
    U = _newton_orthonormalize(U)
    W = dot_hi(a.mT, U)                                        # (B, n, r)
    wn = torch.sqrt((W * W).sum(-2))
    V = W / torch.clamp(wn, min=tiny)[..., None, :]
    s = lam
    good = lam > (4.0 * float(torch.finfo(dt).eps) * math.sqrt(m_)
                  * lam[..., -1:] + tiny)
    U = _complete_null_columns(U, good)
    V = _complete_null_columns(V, good)
    # V never saw the U polish: one Newton step on it as well
    V = _newton_orthonormalize(V)
    return (U.reshape(*batch, m_, n_), s.reshape(*batch, n_),
            V.reshape(*batch, n_, n_))


def use_jacobi_svd_for(A: torch.Tensor) -> bool:
    """Dispatch gate used by ``degen_svd``: a real float32 CUDA tensor
    whose small side is at least 64 and whose panel (small side padded to
    16 rows, long side wide) lies in the kernel's window.  Complex input
    waits for the complex sweep kernel."""
    if not (ENABLED and A.is_cuda and A.dim() >= 2):
        return False
    r = min(A.shape[-1], A.shape[-2])
    w = max(A.shape[-1], A.shape[-2])
    return bool(64 <= r and not A.is_complex()
                and fits_jacobi_sweep(_padded_n(r), w, A.dtype))


def use_jacobi_for(A: torch.Tensor) -> bool:
    """Dispatch gate used by ``degen_eigh``: a real float32 CUDA tensor
    (*B, n, n) with 64 <= n and the padded n inside the kernel's window
    (1024 rows).  Complex input waits for the complex sweep kernel."""
    if not (ENABLED and A.is_cuda and A.dim() >= 2
            and A.shape[-1] == A.shape[-2]):
        return False
    n = A.shape[-1]
    npad = _padded_n(n)
    return bool(64 <= n and not A.is_complex()
                and fits_jacobi_sweep(npad, npad, A.dtype))
