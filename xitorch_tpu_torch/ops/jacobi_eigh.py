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
PyTorch.  The kernel splits each matrix's columns over a thread-block
cluster of C CTAs, each holding all rows of its slice in shared memory
(C chosen on the host by :func:`sweep_cluster`), and works in the output
buffer in device memory, one block a matrix, where no cluster holds the
slices; each matrix has its own exit and sweep count, and the rows keep
their input order (the plain version moves rows as the reference does, so
its output is a row permutation of the kernel's: every consumer sorts).

Complex hermitian input and complex SVD run the same iteration on packed
real planes ``[Re G^T | Im G^T]`` (``complexpair=True``): the pair dot is
the hermitian inner product, the bottom row of a pair is phase-aligned by
``exp(-i arg gamma)`` so that the rotation itself stays real and applies
to both planes, and the gauge is the hermitian ``re^2 + im^2``.  On the
card that is the kernel in ``csrc/jacobi_sweep_complex.cu``, on the same
cluster design as the real one (each CTA holds the same columns of both
planes), with its one-block kernel as the device-memory path.

The warm start (``precondition=True``): the spectral divide-and-conquer
sort (``ops/dc_kernel.py``) hands the sweep ``G0 = Q^T A_shift`` instead of
``A_shift``, after a gap-clipped first-order correction
(:func:`_rot_correct`) and behind a per-matrix orthogonality guard
(:func:`_guard_warm_start`) that sends a matrix with a broken panel back to
the cold start.  The warm start changes how many sweeps run, never the
result.

The deflated path (``deflate=True``, opt-in): the sweep solves the blocks
of a two-level divide-and-conquer sort at window size
(``ops/_finisher_lab.py``) before the same correction, guard and finisher
sweep.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.debug.profiling import count
from xitorch_tpu_torch.ops import _build, dc_level
from xitorch_tpu_torch.ops.tridiag import check_device
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["jacobi_eigh", "jacobi_svd", "use_jacobi_for", "use_jacobi_svd_for",
           "dense_eigh", "dense_svd",
           "jacobi_sweep", "jacobi_sweep_cuda", "jacobi_sweep_plain",
           "fits_jacobi_sweep", "in_jacobi_window", "sweep_cluster",
           "cluster_smem_bytes"]

# global switch: degen_eigh / degen_svd dispatch the dense decomposition
# here when use_jacobi_for / use_jacobi_svd_for approve
ENABLED = True

_UNROLL = 6  # a sweep is ceil((n-1)/_UNROLL)*_UNROLL rounds (the reference's)

# Window of the kernel on the H100.  Rows: the device-memory path keeps the
# carried norms in a static shared-memory array of _N_MAX floats (kMaxN in
# csrc/jacobi_common.cuh).  Width: a panel whose slices no cluster holds
# works in device memory, so the width is bounded only by keeping one
# panel (n * width * 4 B <= 16 MB) well inside the 50 MB L2.
_N_MAX = 1024
_W_MAX = 4096
# the shared memory a block may opt in to on the H100 (used where the
# device does not report it)
_SMEM_BLOCK = 232448
_SM_COUNT = 132
# the cluster paths (csrc/jacobi_sweep.cu, csrc/jacobi_sweep_complex.cu):
# cluster sizes (the complex kernel's also 3: config 2's 512 KB panels on
# clusters of 3 run in two waves where clusters of 4 take three), the
# largest one the chooser grows to (16 CTAs is not portable and is taken
# only where a panel needs it), the gauge's output tile and the kernels'
# other words
_CLUSTERS = (1, 2, 4, 8, 16)
_CLUSTERS_COMPLEX = (1, 2, 3, 4, 8, 16)
_CLUSTER_GROW_MAX = 8
_SWEEP_TILE = 64
_SWEEP_MISC = 64

# Runtime guard on the warm start (see _guard_warm_start): relative
# ||G0^T G0 - A_shift^2||_F above which a matrix falls back to the cold
# sweep.  Healthy panels sit at ~eps*sqrt(n); the rank-deficiency failure
# this guards against breaks the identity by 1e-5..1e-3.
_GUARD_RTOL = 5e-6
_PER_LEVEL_ALIGN = 128  # padding of the per-level warm start's n
_ROT_EMAX = 0.1  # |E_ij| clip of the first-order rotational correction

_P = ctypes.c_void_p
_SWEEP_ARGS = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, _P]
_SIGNATURES = {"jacobi_sweep_f32": _SWEEP_ARGS,
               "jacobi_sweep_f32_clusters": [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]}
_SIGNATURES_COMPLEX = {"jacobi_sweep_c32": _SWEEP_ARGS,
                       "jacobi_sweep_c32_clusters": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                     _P]}


def _eps_floor(dtype) -> float:
    return float(torch.finfo(dtype).tiny) * 16.0


def fits_jacobi_sweep(n: int, width: int, dtype, complexpair: bool = False) -> bool:
    """Whether an (n, width) panel lies in the kernels' window: float32,
    n even and at most 1024 rows, width at most 4096 (for packed complex
    planes ``[Re | Im]`` the width is even, so the half-width is at most
    2048)."""
    return bool(dtype == torch.float32 and n >= 2 and n % 2 == 0
                and n <= _N_MAX and 1 <= width <= _W_MAX
                and not (complexpair and width % 2))


# ------------------------------------------------------------------
# the sweep: plain version, kernel wrapper, dispatcher
# ------------------------------------------------------------------

def _max_cos2(G: torch.Tensor, complexpair: bool = False) -> torch.Tensor:
    """Gram gauge of a (B, n, width) panel: per matrix, the max over i != j
    of ``|<g_i, g_j>|^2 / max(|g_i|^2 |g_j|^2, 16 tiny)``, in IEEE float32.
    With ``complexpair`` the rows are packed ``[Re | Im]`` and the inner
    product is hermitian."""
    n = G.shape[-2]
    nrm = (G * G).sum(-1)
    gram = dot_hi(G, G.mT)
    gram2 = gram * gram
    if complexpair:
        hw = G.shape[-1] // 2
        # Im <g_i, g_j> = g_i . swap(g_j) with swap = [Im | -Re]
        gsw = torch.cat([G[..., hw:], -G[..., :hw]], dim=-1)
        im = dot_hi(G, gsw.mT)
        gram2 = gram2 + im * im
    denom = torch.clamp(nrm[..., :, None] * nrm[..., None, :],
                        min=_eps_floor(G.dtype))
    ratio = gram2 / denom
    eye = torch.eye(n, dtype=torch.bool, device=G.device)
    return ratio.masked_fill(eye, 0.0).amax(dim=(-2, -1))


def _rot_coeffs(nt, nb, gam, live_thresh: float, gam2=None):
    """Jacobi rotation (c, s) for row pairs with carried squared norms
    ``nt``/``nb`` and pair dot ``gam`` (``|gamma|`` on the complex path,
    with ``gam2 = |gamma|^2`` as it was summed); pairs already orthogonal
    (or zero) get the identity.  Returns ``(c, s, live)``."""
    if gam2 is None:
        gam2 = gam * gam
    ratio = gam2 / torch.clamp(nt * nb, min=_eps_floor(gam.dtype))
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
    return c, s, live


def _shuffle(h: int, top, bot):
    """Brent-Luk tournament shuffle along the pair axis (-2):
    new_top = [top0, bot0, top1..top_{h-2}], new_bot = [bot1.., top_{h-1}]."""
    if h == 1:
        return top, bot
    new_top = torch.cat([top[..., 0:1, :], bot[..., 0:1, :], top[..., 1:h - 1, :]],
                        dim=-2)
    new_bot = torch.cat([bot[..., 1:h, :], top[..., h - 1:h, :]], dim=-2)
    return new_top, new_bot


def _one_round(h: int, top, bot, nt, nb, live_thresh: float, complexpair: bool):
    if complexpair:
        hw = top.shape[-1] // 2
        rt, it = top[..., :hw], top[..., hw:]
        rb, ib = bot[..., :hw], bot[..., hw:]
        # gamma = <g_p, g_q>, the hermitian inner product: two reductions
        g_re = (rt * rb + it * ib).sum(-1, keepdim=True)
        g_im = (rt * ib - it * rb).sum(-1, keepdim=True)
        gam2 = g_re * g_re + g_im * g_im
        gam = torch.sqrt(gam2)
        c, s, live = _rot_coeffs(nt, nb, gam, live_thresh, gam2)
        # phase-align g_q by exp(-i arg gamma), so that the rotation itself
        # is real; a pair that is not rotated (gamma ~ 0) keeps the identity
        # phase: dividing by a floored |gamma| would zero the bottom row
        floor = _eps_floor(gam.dtype)
        safe = live & (gam > floor)
        denom = torch.clamp(gam, min=floor)
        ph_c = torch.where(safe, g_re / denom, torch.ones_like(gam))
        ph_s = torch.where(safe, g_im / denom, torch.zeros_like(gam))
        bot = torch.cat([ph_c * rb + ph_s * ib, ph_c * ib - ph_s * rb], dim=-1)
    else:
        gam = (top * bot).sum(-1, keepdim=True)
        c, s, _ = _rot_coeffs(nt, nb, gam, live_thresh)
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


def _check_panel(panel: torch.Tensor, what: str, complexpair: bool = False) -> None:
    if panel.dim() != 3 or panel.shape[-2] < 2 or panel.shape[-2] % 2:
        raise RuntimeError("%s expects a (B, n, width) panel with n even, got %s"
                           % (what, tuple(panel.shape)))
    if complexpair and (panel.shape[-1] % 2 or panel.is_complex()):
        raise RuntimeError("%s: complexpair takes real packed planes [Re | Im] of "
                           "even width, got %s %s"
                           % (what, panel.dtype, tuple(panel.shape)))


def jacobi_sweep_plain(panel: torch.Tensor, max_sweeps: int, tol: float,
                       complexpair: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep kernels on a (B, n, width) panel:
    the same rotations, pairing, norm carry, per-sweep refresh and gauge
    exit, each matrix leaving on its own gauge.  ``complexpair``: the rows
    are packed real planes ``[Re g_i | Im g_i]`` of complex vectors.
    Returns ``(G, sweeps)``: the swept panel (rows in tournament order, a
    permutation of the input's) and each matrix's executed sweep count
    (B,) int32."""
    _check_panel(panel, "jacobi_sweep_plain", complexpair)
    B, n, _ = panel.shape
    h = n // 2
    tol2 = tol * tol
    live_thresh = tol2 * 0.01
    rounds = -(-(n - 1) // _UNROLL) * _UNROLL
    G = panel.clone()
    sweeps = torch.zeros(B, dtype=torch.int32, device=panel.device)
    worst = _max_cos2(G, complexpair) if B else G.new_zeros(0)
    for _ in range(max_sweeps):
        # the negated <= keeps a matrix whose gauge is NaN sweeping, as the
        # kernels' `gauge > tol^2` does not: both leave it after max_sweeps
        idx = (worst > tol2).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        g = G[idx]
        top, bot = g[:, :h], g[:, h:]
        # fresh norms once per sweep: kills the analytic-update drift
        nt = (top * top).sum(-1, keepdim=True)
        nb = (bot * bot).sum(-1, keepdim=True)
        for _r in range(rounds):
            top, bot, nt, nb = _one_round(h, top, bot, nt, nb, live_thresh,
                                          complexpair)
        g = torch.cat([top, bot], dim=1)
        G[idx] = g
        sweeps[idx] += 1
        worst[idx] = _max_cos2(g, complexpair)
    return G, sweeps


def _pad_halves(panel: torch.Tensor, hw: int, hw4: int) -> torch.Tensor:
    """[Re | Im] with each half zero-padded from hw to hw4 columns."""
    return torch.cat([F.pad(panel[..., :hw], (0, hw4 - hw)),
                      F.pad(panel[..., hw:], (0, hw4 - hw))], dim=-1)


def cluster_smem_bytes(n: int, width: int, c: int, complexpair: bool = False) -> int:
    """Shared memory one CTA of a sweep kernel's cluster path takes for an
    (n, width) panel split over ``c`` CTAs.

    Real (``cluster_smem_bytes`` in ``csrc/jacobi_sweep.cu``): its slice of
    ceil(ceil(width/4)/c) float4 columns at an odd row stride, an area that
    holds the gauge's two 64 x 64 tiles or the pair partials received from
    every CTA (2 x c x n/2), the carried norms, the round's coefficients
    (2 x n/2) and a few words.  Complex, ``complexpair`` (``complex_smem_bytes``
    in ``csrc/jacobi_sweep_complex.cu``; ``width`` the packed width
    ``[Re | Im]``): the same columns of both planes, s4 = ceil(ceil(width/8)/c)
    float4 of each, at an odd stride of 2 s4; an area that holds the gauge's
    64 x 64 tile of two planes or the partials (re, im) from every CTA
    (2 x c x n/2 x 2); the norms; 4 coefficients a pair (s, tau, the phase)
    and a few words: the least the kernel takes (it takes a second tile
    buffer where that fits too)."""
    if complexpair:
        s4 = -(-(-(-(width // 2) // 4)) // c)
        area = max(2 * _SWEEP_TILE ** 2, 2 * c * n)
        return n * ((2 * s4) | 1) * 16 + (area + 3 * n + _SWEEP_MISC) * 4
    s4 = -(-(-(-width // 4)) // c)
    area = max(2 * _SWEEP_TILE ** 2, c * n)
    return n * (s4 | 1) * 16 + (area + 2 * n + _SWEEP_MISC) * 4


def sweep_cluster(B: int, n: int, width: int, sm_count: int = _SM_COUNT,
                  smem_block: int = _SMEM_BLOCK, active_clusters=None,
                  complexpair: bool = False) -> int:
    """How many CTAs a sweep kernel splits each matrix of a (B, n, width)
    panel over (``complexpair``: packed complex planes, each CTA holding the
    same columns of both): the smallest cluster (1, 2, 4, 8 or 16; complex
    also 3) whose slices fit ``smem_block`` bytes of shared memory a block
    (:func:`cluster_smem_bytes`), then grown to the next size while it stays
    at most 8, each CTA keeps at least one float4 column (of each plane), the
    B clusters keep to one CTA an SM (B C <= ``sm_count``) and, where
    ``active_clusters(c)`` (the card's occupancy query) is given, the card
    holds B clusters of that size at once.  0: no cluster holds the slices
    (or ``smem_block`` is 0), the device-memory path.  Shapes only, so a CPU
    test can ask it."""
    sizes = _CLUSTERS_COMPLEX if complexpair else _CLUSTERS
    fit = [c for c in sizes
           if cluster_smem_bytes(n, width, c, complexpair) <= smem_block]
    if not fit:
        return 0
    w4 = -(-(width // 2) // 4) if complexpair else -(-width // 4)
    grow = [c for c in sizes if c > fit[0]]
    c = fit[0]
    for nc in grow:
        if not (nc <= _CLUSTER_GROW_MAX and nc <= w4 and B * nc <= sm_count
                and (active_clusters is None or active_clusters(nc) >= B)):
            break
        c = nc
    return c


def _card_limits(device) -> Tuple[int, int]:
    """(SM count, shared memory a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            int(getattr(props, "shared_memory_per_block_optin", _SMEM_BLOCK)))


_ACTIVE_CLUSTERS = {}


def _active_clusters(lib, device, n: int, width: int, c: int,
                     complexpair: bool = False) -> int:
    """The card's occupancy query: how many clusters of ``c`` CTAs of a
    sweep kernel (the complex one with ``complexpair``) it holds at once
    for an (n, width) panel (cached)."""
    key = (device.index, n, width, c, complexpair)
    if key not in _ACTIVE_CLUSTERS:
        out = ctypes.c_int(0)
        query = lib.jacobi_sweep_c32_clusters if complexpair else lib.jacobi_sweep_f32_clusters
        _build.check(query(n, width, c, ctypes.addressof(out)),
                     "jacobi_sweep_cuda: cluster occupancy query")
        _ACTIVE_CLUSTERS[key] = out.value
    return _ACTIVE_CLUSTERS[key]


def jacobi_sweep_cuda(panel: torch.Tensor, max_sweeps: int, tol: float,
                      return_stats: bool = False, complexpair: bool = False,
                      smem_limit: Optional[int] = None, cluster: Optional[int] = None):
    """Launch a sweep kernel on a contiguous float32 CUDA panel
    (B, n, width) inside the window of :func:`fits_jacobi_sweep`: the real
    kernel (``csrc/jacobi_sweep.cu``), or with ``complexpair`` the complex
    one (``csrc/jacobi_sweep_complex.cu``) on packed planes ``[Re | Im]``.
    Returns ``(G, sweeps)`` (rows in the input's order), and with
    ``return_stats`` also each matrix's last measured gauge (B,) float32
    and its number of rotated pairs (B,) int32 (pairs skipped as orthogonal
    do not count).  ``jacobi_sweep_cuda.launches`` counts the real kernel's
    launches, ``jacobi_sweep_cuda.launches_complex`` the complex one's.

    Either kernel's path is chosen before the launch by
    :func:`sweep_cluster` from the shapes, the card's SM count and shared
    memory (``smem_limit`` bytes a block where given; 0 forces the
    device-memory path) and its occupancy query, and is recorded in
    ``jacobi_sweep_cuda.last_cluster``: the cluster's CTAs a matrix, 0 for
    the device-memory path.  ``cluster`` (complex panels only) forces
    clusters of that many CTAs, to measure one design against another.  A
    cluster the card cannot schedule, or a launch it refuses, raises:
    nothing falls back to another path."""
    _check_panel(panel, "jacobi_sweep_cuda", complexpair)
    if not panel.is_cuda or panel.dtype != torch.float32 or not panel.is_contiguous():
        raise RuntimeError("jacobi_sweep_cuda: expected a contiguous float32 CUDA "
                           "panel (B, n, width)")
    B, n, width = panel.shape
    if B == 0 or not fits_jacobi_sweep(n, width, panel.dtype, complexpair):
        raise RuntimeError(
            "jacobi_sweep_cuda: a (%d, %d, %d) panel is outside the kernel's "
            "window (1 <= B, n even <= %d, width <= %d%s)"
            % (B, n, width, _N_MAX, _W_MAX, ", even" if complexpair else ""))
    if cluster is not None and not complexpair:
        raise RuntimeError("jacobi_sweep_cuda: cluster is taken for complex panels only")
    # the kernels read rows (each half of a packed row) as float4: zero
    # columns change no dot product
    if complexpair:
        hw = width // 2
        hw4 = -(-hw // 4) * 4
        a = _pad_halves(panel, hw, hw4) if hw4 != hw else panel
    else:
        w4 = -(-width // 4) * 4
        a = F.pad(panel, (0, w4 - width)) if w4 != width else panel
    g = torch.empty_like(a)
    sweeps = torch.empty(B, dtype=torch.int32, device=panel.device)
    gauge = torch.empty(B, dtype=torch.float32, device=panel.device)
    rotations = torch.empty(B, dtype=torch.int32, device=panel.device)
    tol2 = tol * tol
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (a.data_ptr(), g.data_ptr(), sweeps.data_ptr(), gauge.data_ptr(),
                rotations.data_ptr(), B, n, a.shape[-1], int(max_sweeps), tol2,
                tol2 * 0.01)
        if complexpair:
            lib = _build.load("jacobi_sweep_complex", _SIGNATURES_COMPLEX)
        else:
            lib = _build.load("jacobi_sweep", _SIGNATURES)
        sms, smem = _card_limits(panel.device)
        if smem_limit is not None:
            smem = min(smem, int(smem_limit))
        wa = a.shape[-1]
        dev = torch.device("cuda", torch.cuda.current_device())
        c = cluster
        if c is None:
            c = sweep_cluster(B, n, wa, sms, smem,
                              lambda cc: _active_clusters(lib, dev, n, wa, cc, complexpair),
                              complexpair)
        elif c not in _CLUSTERS_COMPLEX or cluster_smem_bytes(n, wa, c, True) > smem:
            raise RuntimeError(
                "jacobi_sweep_cuda: a cluster of %r CTAs does not hold a (%d, %d) panel "
                "in %d bytes a block" % (cluster, n, wa, smem))
        if c and _active_clusters(lib, dev, n, wa, c, complexpair) < 1:
            raise RuntimeError(
                "jacobi_sweep_cuda: the card cannot schedule a cluster of %d "
                "CTAs with %d bytes of shared memory each for a (%d, %d) panel"
                % (c, cluster_smem_bytes(n, wa, c, complexpair), n, wa))
        jacobi_sweep_cuda.last_cluster = c
        entry = lib.jacobi_sweep_c32 if complexpair else lib.jacobi_sweep_f32
        rc = entry(*args, c, stream)
    _build.check(rc, "jacobi_sweep_cuda")
    if complexpair:
        jacobi_sweep_cuda.launches_complex += 1
        if hw4 != hw:
            g = torch.cat([g[..., :hw], g[..., hw4:hw4 + hw]], dim=-1)
    else:
        jacobi_sweep_cuda.launches += 1
        if w4 != width:
            g = g[..., :width].contiguous()
    return (g, sweeps, gauge, rotations) if return_stats else (g, sweeps)


jacobi_sweep_cuda.launches = 0
jacobi_sweep_cuda.launches_complex = 0
jacobi_sweep_cuda.last_cluster = None


@torch.library.custom_op("xitorch_tpu_torch::jacobi_sweep", mutates_args=(),
                         device_types="cpu")
def _sweep_op(panel: torch.Tensor, max_sweeps: int, tol: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The real sweep as an operator, ``(G, sweeps, drift)``: the kernel on
    CUDA tensors, the plain version on CPU tensors, so that ``torch.export``
    can trace through a launch.  ``drift`` (B,) int32 is the number of
    sweeps whose tournament permutation the rows of G still carry: each
    matrix's sweep count for the plain version, 0 for the kernel (its rows
    keep the input's order)."""
    G, sweeps = jacobi_sweep_plain(panel, max_sweeps, tol)
    return G, sweeps, sweeps.clone()


@_sweep_op.register_kernel("cuda")
def _(panel, max_sweeps, tol):
    G, sweeps = jacobi_sweep_cuda(panel, max_sweeps, tol)
    return G, sweeps, torch.zeros_like(sweeps)


@torch.library.custom_op("xitorch_tpu_torch::jacobi_sweep_complex", mutates_args=(),
                         device_types="cpu")
def _sweep_complex_op(panel: torch.Tensor, max_sweeps: int, tol: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The complex sweep on packed planes ``[Re | Im]`` as an operator,
    outputs as :func:`_sweep_op`'s."""
    G, sweeps = jacobi_sweep_plain(panel, max_sweeps, tol, complexpair=True)
    return G, sweeps, sweeps.clone()


@_sweep_complex_op.register_kernel("cuda")
def _(panel, max_sweeps, tol):
    G, sweeps = jacobi_sweep_cuda(panel, max_sweeps, tol, complexpair=True)
    return G, sweeps, torch.zeros_like(sweeps)


@_sweep_op.register_fake
@_sweep_complex_op.register_fake
def _(panel, max_sweeps, tol):
    counts = panel.new_empty(panel.shape[0], dtype=torch.int32)
    return torch.empty_like(panel), counts, torch.empty_like(counts)


def jacobi_sweep(panel: torch.Tensor, max_sweeps: int, tol: float,
                 complexpair: bool = False, return_drift: bool = False):
    """Sweep a (B, n, width) panel: the kernel for a CUDA tensor (or an
    error), the plain version for a CPU tensor.  Counterpart of
    ``_pallas_g_panel``; returns ``(G, sweeps)``, and with ``return_drift``
    also the sweeps of tournament drift the rows carry (see
    :func:`_sweep_op`)."""
    check_device(panel)
    op = _sweep_complex_op if complexpair else _sweep_op
    G, sweeps, drift = op(panel.contiguous(), int(max_sweeps), float(tol))
    count("jacobi_sweep_complex" if complexpair else "jacobi_sweep", sweeps)
    return (G, sweeps, drift) if return_drift else (G, sweeps)


# ------------------------------------------------------------------
# host side
# ------------------------------------------------------------------

def _padded_n(n: int, precondition: bool = False, deflate: bool = False) -> int:
    """Working size for an (n, n) input: a multiple of 16, as the
    reference's sweep kernel takes, and at least 64 on the deflated path;
    on the preconditioned path past the single-shot warm start's window (a
    16-multiple above 448) a multiple of 128, as the reference pads for its
    per-level kernel, so that both run the same size and the same number of
    levels (n = 700 works at 768, 10 levels).  Padding eigenvalues are
    placed above the spectrum and sliced off after the sort."""
    npad = max(16, -(-n // 16) * 16)
    if deflate:
        npad = max(64, npad)
    elif precondition and npad > dc_level._PER_LEVEL_MIN_N:
        npad = -(-n // _PER_LEVEL_ALIGN) * _PER_LEVEL_ALIGN
    return npad


def _newton_orthonormalize(V: torch.Tensor) -> torch.Tensor:
    """One Newton step ``V (3 I - V^H V) / 2``: squares the orthogonality
    drift away."""
    eye = torch.eye(V.shape[-1], dtype=V.dtype, device=V.device)
    return dot_hi(V, 1.5 * eye - 0.5 * dot_hi(V.mH, V))


def _guard_warm_start(a_shift: torch.Tensor, g0: torch.Tensor,
                      rtol: float = _GUARD_RTOL
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-matrix orthogonality guard on the warm panel.

    The sweep rests on the G-invariant: its input panel must be
    ``R^T A_shift`` for an orthogonal R (then the rows of G at convergence
    are scaled eigenvectors).  A healthy warm panel is ``Q^T A_shift`` with Q
    orthogonal to float32, so ``G0^T G0 == A_shift^2``; a rank-deficient Q
    (a wrongly rounded slot split that the polar ramp cannot repair) breaks
    that identity by 1e-5..1e-3 against a healthy ~eps*sqrt(n).  A matrix
    above ``rtol`` falls back to the cold start ``A_shift`` itself (R = I):
    correctness never depends on the preconditioner.  Two batched products.
    Returns ``(panel, bad)`` with ``bad`` (B,) bool."""
    gtg = dot_hi(g0.mT, g0)
    a2 = dot_hi(a_shift, a_shift)
    num = torch.sqrt(((gtg - a2) ** 2).sum(dim=(-2, -1)))
    den = torch.sqrt((a2 * a2).sum(dim=(-2, -1)))
    # negated <= so that a NaN-poisoned panel (NaN compares False both ways)
    # is flagged and falls back to the cold start
    bad = ~(num <= rtol * den)
    return torch.where(bad[:, None, None], a_shift, g0), bad


def _rot_correct(g0: torch.Tensor, passes: int = 2,
                 emax: float = _ROT_EMAX) -> torch.Tensor:
    """Gap-clipped first-order rotational correction of a warm panel:
    products in place of sweeps for the well-gapped leftover couplings.

    The warm panel is ``P = Q^T A_shift`` with Q near the eigenbasis, so
    ``T = P P^T = Q^T A^2 Q`` is nearly diagonal.  The first-order rotation
    that zeroes coupling (i, j) of T is ``R = I + E`` with antisymmetric
    ``E_ij = T_ij / (t_j - t_i)``.  Entries with ``|E_ij| > emax``
    (couplings between near-degenerate pairs, where first order is invalid)
    are clipped to zero and left to the sweep, whose 2x2 rotations solve
    them exactly.  R is made orthogonal by 3 Newton-Schulz polar steps, so
    the G-invariant survives to rounding and a bad correction costs sweeps,
    never correctness; the guard runs after this correction."""
    n = g0.shape[-1]
    dt = g0.dtype
    eye = torch.eye(n, dtype=dt, device=g0.device)
    tiny = _eps_floor(dt)
    for _ in range(passes):
        T = dot_hi(g0, g0.mT)
        t = torch.diagonal(T, dim1=-2, dim2=-1)
        denom = t[..., None, :] - t[..., :, None]           # t_j - t_i
        # denom == 0 is excluded explicitly: an exactly degenerate uncoupled
        # pair (T_ij = 0: identical padding rows, or the zero rows of a
        # broken preconditioner) passes the clip test, and 0/0 would
        # NaN-poison the panel before the guard can catch it
        live = (T.abs() <= emax * denom.abs()) & (denom.abs() > tiny)
        E = torch.where(live, T / torch.where(live, denom, torch.ones_like(denom)),
                        torch.zeros_like(T))
        R = eye + E
        for _ns in range(3):
            R = dot_hi(R, 1.5 * eye - 0.5 * dot_hi(R.mT, R))
        g0 = dot_hi(R.mT, g0)
    return g0


def _shift_pad(a: torch.Tensor, npad: int) -> torch.Tensor:
    """The matrix the sweep works on for a (B, n, n) hermitian ``a``: shifted
    positive definite by its one-sided Gershgorin bound plus 1% of its
    Frobenius norm (the eigenvector extraction divides by the shifted
    eigenvalues), and padded to (B, npad, npad) with a diagonal above every
    shifted eigenvalue."""
    n = a.shape[-1]
    dt = a.real.dtype if a.is_complex() else a.dtype
    absa = a.abs()
    diag = torch.diagonal(a, dim1=-2, dim2=-1).real
    offsum = absa.sum(-1) - torch.diagonal(absa, dim1=-2, dim2=-1)
    lower = (diag - offsum).amin(-1)
    frob = torch.sqrt((absa * absa).sum(dim=(-2, -1)))
    sigma = torch.clamp(-lower, min=0.0) + 0.01 * frob + 1e-30
    if npad != n:
        # upper spectral bound of the shifted matrix, for the padding diagonal
        top = torch.clamp((diag + offsum).amax(-1), min=0.0) + sigma
        pad = npad - n
        a = F.pad(a, (0, pad, 0, pad))
        pdiag = torch.zeros(npad, dtype=dt, device=a.device)
        pdiag[n:] = 2.0
        a = a + torch.diag_embed(pdiag)[None] * top[:, None, None]
    return a + sigma[:, None, None] * torch.eye(npad, dtype=dt, device=a.device)


def _resolve_precondition(precondition: Optional[bool], A: torch.Tensor) -> bool:
    # None is the cold sweep at every size: on the H100 the warm start is
    # slower wherever it was measured (see jacobi_eigh's docstring)
    if precondition and A.is_complex():
        raise ValueError(
            "jacobi_eigh: precondition=True is not supported for complex input "
            "(the DC kernel operates on real symmetric matrices; the complex "
            "path packs [Re|Im] planes, which the segment bookkeeping does not "
            "model): leave precondition=None or False")
    return bool(precondition)


def jacobi_eigh(A: torch.Tensor, *, max_sweeps: int = 18,
                tol: Optional[float] = None,
                precondition: Optional[bool] = None,
                deflate: Optional[bool] = None,
                return_info: bool = False):
    """Batched symmetric/hermitian eigendecomposition, ``torch.linalg.eigh``
    contract.

    ``A``: (*B, n, n) real symmetric or complex hermitian.  Returns
    ascending (real) eigenvalues (*B, n) and column eigenvectors
    (*B, n, n).  Raw entry without derivatives; ``degen_eigh`` wraps it with
    the degeneracy-safe gradient.  Pads n to a multiple of 16 internally
    (of 128 on the per-level warm start, see :func:`_padded_n`).

    ``precondition=True`` (real input only) runs the spectral
    divide-and-conquer sort first (split down to pairs: in one launch,
    ``ops/dc_kernel.py``, up to a padded n of 448, one launch a level,
    ``ops/dc_level.py``, above) and hands the sweep ``G0 = Q^T A_shift``
    instead of ``A_shift``, after :func:`_rot_correct` and behind
    :func:`_guard_warm_start`.  The sweep's G-invariant makes this
    transparent: extraction, polish and sorting are unchanged, and a bad
    preconditioner costs sweeps, never correctness.  ``precondition=None``
    means ``False``: on the card the warm start does not pay yet.  On an
    NVIDIA H100 80GB HBM3 (700 W), printed by ``chip_smoke.py``, figures
    rounded: at 64 matrices of 256 x 256 the warm start lowers the sweeps
    from 8.8 to 2.5 a matrix, but ``jacobi_eigh`` takes about 30 ms warm
    against 7 ms cold: the single-shot DC kernel alone takes about 21 ms,
    and the sweeps left still take 6 ms, as long as most of a cold sweep
    (every matrix has its own exit, so the launch lasts as long as its
    slowest matrix, and the guard sent 4 of the 64 back to the cold
    start).  At 8 matrices of 512 x 512 (9 levels) the warm call takes
    about 46 ms against 17 ms cold; at 700 x 700 (768 padded, 10 levels)
    146 ms against 67 ms, the per-level kernel about 66 ms of it.  At both
    sizes the guard sent all 8 back to the cold start (the rotational
    correction breaks these panels' G-invariant).  Until the kernels are
    made faster, ``precondition=True`` pays that for fewer sweeps and no
    time.

    ``deflate=True`` (real input, padded n up to 448; ``None`` means
    ``False``, as in the reference) runs the deflated path instead
    (``ops/_finisher_lab.py``): a two-level divide-and-conquer sort, the
    sweep on its blocks at window size, then the same correction, guard and
    finisher sweep, and after the polish a Rayleigh-Ritz rotation on the
    unshifted input.  It is slower than the cold call on the card and is not
    a default: on an NVIDIA H100 80GB HBM3 (700 W), printed by
    ``chip_smoke.py``, figures rounded, 31 ms against 7 ms cold at 64
    matrices of 256 x 256, the DC kernel alone 12 ms.

    ``return_info`` also returns a dictionary with each matrix's executed
    sweep count (``sweeps``, (Bflat,) int32; the finisher's on the deflated
    path) and, on the warm and deflated paths, the guard's fall-back flags
    (``guard_bad``, (Bflat,) bool).
    """
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError("jacobi_eigh expects (*B, n, n), got %s" % (tuple(A.shape),))
    iscomplex = A.is_complex()
    precondition = _resolve_precondition(precondition, A)
    n = A.shape[-1]
    if deflate and iscomplex:
        raise ValueError(
            "jacobi_eigh: deflate=True is not supported for complex input (the DC "
            "kernel operates on real symmetric matrices): leave deflate=None or False")
    if deflate and _padded_n(n, deflate=True) > dc_level._PER_LEVEL_MIN_N:
        # the deflated path needs the single-shot DC kernel's return_t,
        # return_seg and refine, which the per-level path does not give
        raise ValueError(
            "jacobi_eigh: deflate=True is only supported for n <= %d (the single-shot "
            "DC window); use precondition=True or the default cold sweep for larger n"
            % dc_level._PER_LEVEL_MIN_N)
    deflate = bool(deflate)
    if deflate:
        precondition = False  # the deflated path runs its own DC
    batch = A.shape[:-2]
    dt = A.real.dtype if iscomplex else A.dtype
    if tol is None:
        # the reachable floor: after a rotation, rounding leaves pair
        # cosines at ~eps*sqrt(n), so a tolerance below that can never be
        # met; 4*eps*sqrt(n) sits above the noise floor
        tol = float(torch.finfo(dt).eps) * 4.0 * math.sqrt(n)
    Bflat = math.prod(batch) if batch else 1
    a0 = A.reshape(Bflat, n, n)
    # a multiple of 16; 128 on the per-level warm start (see _padded_n)
    npad = _padded_n(n, precondition, deflate)
    a = _shift_pad(a0, npad)

    info = {}
    if iscomplex:
        # the panel's rows must hold g_i = column i of G = A; A hermitian
        # means column i = conj(row i), so the planes are (Re A, -Im A)
        planes = torch.cat([a.real, -a.imag], dim=-1)
        gt2, sweeps = jacobi_sweep(planes, max_sweeps, tol, complexpair=True)
        gt = torch.complex(gt2[..., :npad], gt2[..., npad:])
    elif deflate:
        from xitorch_tpu_torch.ops._finisher_lab import deflated_panel
        # the DC sort's decoupled blocks solved at window size, then the
        # warm path's correction and guard; the finisher sweep certifies
        # convergence, so a soft split costs sweeps, never correctness (no
        # sort of the fall-backs: every matrix has its own exit, see below)
        g0 = _rot_correct(deflated_panel(a, max_sweeps=max_sweeps))
        g_in, bad = _guard_warm_start(a, g0)
        gt, sweeps = jacobi_sweep(g_in, max_sweeps, tol)
        info["guard_bad"] = bad
    elif precondition:
        from xitorch_tpu_torch.ops.dc_kernel import dc_precondition
        # depth: split every segment down to pairs; a 2-block is solved
        # exactly by its first tournament rotation.  Past a padded n of 448
        # dc_precondition runs one level a launch (ops/dc_level.py)
        levels = max(3, math.ceil(math.log2(npad)))
        g0 = dc_precondition(a, levels=levels, min_seg=2)
        # kills the well-gapped leftover couplings (the rank-safety blend's
        # global floor among them) with products; near-degenerate pairs are
        # clipped out and left to the sweep's 2x2 rotations
        g0 = _rot_correct(g0)
        # any matrix whose warm panel fails the G-invariant (a rank failure
        # of the sort, or a divergent correction) falls back to the cold
        # start.  The reference then sorts the fall-backs together, because
        # its kernel stacks several matrices in one program with a common
        # exit; here every matrix has its own exit (its own thread-block
        # cluster, or its own block on the device-memory path), so there is
        # nothing to sort.
        g_in, bad = _guard_warm_start(a, g0)
        gt, sweeps = jacobi_sweep(g_in, max_sweeps, tol)
        info["guard_bad"] = bad
    else:
        gt, sweeps = jacobi_sweep(a, max_sweeps, tol)
    info["sweeps"] = sweeps

    # row i of G^T is lambda'_i * v_i: norms are the shifted eigenvalues,
    # directions the eigenvectors
    lam = torch.sqrt((gt.abs() ** 2).sum(-1))                   # (B, npad)
    vt = gt / torch.clamp(lam, min=_eps_floor(dt))[..., None]
    if npad != n:
        # the padding rows carry eigenvalues above every true one
        order = torch.argsort(lam, dim=-1)
        vt = torch.take_along_dim(vt, order[..., None], dim=-2)
    vt = vt[:, :n, :n]
    # row i of the panel holds g_i itself, so a plain transpose puts the
    # eigenvectors in columns (no conjugation, also for complex input)
    V = vt.mT

    # polish: one Newton orthonormalisation, then Rayleigh quotients on the
    # unshifted input recover eps*|A| (instead of eps*sigma) accuracy
    V = _newton_orthonormalize(V)
    AV = dot_hi(a0, V)
    lam = (V.conj() * AV).sum(-2).real
    if deflate:
        from xitorch_tpu_torch.ops._finisher_lab import deflate_refine
        # the deflated panel enters the finisher just under tol instead of
        # overshooting below it: one Rayleigh-Ritz pass on the unshifted input
        lam, V = deflate_refine(a0, V, AV, lam)
    order = torch.argsort(lam, dim=-1)
    lam = torch.take_along_dim(lam, order, dim=-1)
    V = torch.take_along_dim(V, order[:, None, :], dim=-1)
    out = (lam.reshape(*batch, n), V.reshape(*batch, n, n))
    return out + (info,) if return_info else out


def _complete_null_columns(Q: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    """Replace the columns of ``Q`` (B, m, r) flagged bad by ``good``
    (B, r) bool with an orthonormal completion of the good columns.

    Numerically-zero singular values leave zero rows in the Hestenes
    panel, hence zero (or junk) columns in U and V, while the library svd
    returns orthonormal null-space completions.  Bad slots get a fixed
    quasi-random fill (real: full rank against complex good columns too)
    projected against the good columns and orthonormalised among
    themselves by a masked CholQR (twice)."""
    B, mdim, r = Q.shape
    dt = Q.dtype
    rdt = Q.real.dtype if Q.is_complex() else dt
    g = good.to(dt)
    iot_m = torch.arange(mdim, dtype=rdt, device=Q.device)[:, None]
    iot_r = torch.arange(r, dtype=rdt, device=Q.device)[None, :]
    Fm = torch.sin(iot_m * (0.7391 * iot_r + 1.137) + 0.31 * iot_r)
    Fm = (Fm / math.sqrt(mdim)).to(dt).expand(B, mdim, r)
    Qg = Q * g[:, None, :]
    Fm = Fm - dot_hi(Qg, dot_hi(Qg.mH, Fm))
    b = 1.0 - g
    Fb = Fm * b[:, None, :]
    eye = torch.eye(r, dtype=dt, device=Q.device)
    ridge = 16 * float(torch.finfo(rdt).eps) / mdim
    for _ in range(2):
        Gm = dot_hi(Fb.mH, Fb)
        # good slots pinned to the identity so the factorisation stays SPD
        Gm = (Gm * (b[:, :, None] * b[:, None, :]) + eye * g[:, None, :]
              + eye * ridge * b[:, None, :])
        L = torch.linalg.cholesky(Gm)
        Y = torch.linalg.solve_triangular(L, Fb.mH, upper=False)  # L^-1 Fb^H
        Fb = Y.mH
    return Qg + Fb * b[:, None, :]


def jacobi_svd(A: torch.Tensor, *, max_sweeps: int = 18,
               tol: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched economy SVD ``A = U diag(s) V^H`` by one-sided (Hestenes)
    Jacobi: the same sweep as :func:`jacobi_eigh`, run on the columns of A
    instead of on a Gram matrix, so singular values keep ~eps*kappa(A)
    relative error and no shift is needed.

    ``A``: (*B, m, n) real or complex.  Returns ``(U (*B, m, r), s (*B, r)
    ASCENDING, V (*B, n, r))`` with ``r = min(m, n)``.  Complex input runs
    the complex-pair sweep on the packed planes ``[Re col_i | Im col_i]``.
    Directions in the numerical null space are arbitrary but orthonormal."""
    if A.dim() < 2:
        raise ValueError("jacobi_svd expects (*B, m, n), got %s" % (tuple(A.shape),))
    iscomplex = A.is_complex()
    batch = A.shape[:-2]
    m_, n_ = A.shape[-2], A.shape[-1]
    if m_ < n_:
        # work on A^H (tall): A^H = U' S V'^H  =>  A = V' S U'^H
        u, s, v = jacobi_svd(A.mH, max_sweeps=max_sweeps, tol=tol)
        return v, s, u
    dt = A.dtype
    rdt = A.real.dtype if iscomplex else dt
    if tol is None:
        tol = float(torch.finfo(rdt).eps) * 4.0 * math.sqrt(n_)
    Bflat = math.prod(batch) if batch else 1
    a = A.reshape(Bflat, m_, n_)

    # panel rows = columns of A; pad the pair axis to a multiple of 16 with
    # zero rows (dead to every rotation: gamma = 0 skips the pair)
    npad = _padded_n(n_)
    panel = a.mT
    if npad != n_:
        panel = F.pad(panel, (0, 0, 0, npad - n_))
    if iscomplex:
        planes = torch.cat([panel.real, panel.imag], dim=-1)   # (B, npad, 2m)
        gt2, _ = jacobi_sweep(planes, max_sweeps, tol, complexpair=True)
        gt = torch.complex(gt2[..., :m_], gt2[..., m_:])
    else:
        gt, _ = jacobi_sweep(panel.contiguous(), max_sweeps, tol)  # (B, npad, m)

    # row i of G^T is s_i * u_i; the zero pads sort first
    lam = torch.sqrt((gt.abs() ** 2).sum(-1))                  # (B, npad)
    order = torch.argsort(lam, dim=-1)[..., npad - n_:]        # ascending
    gt = torch.take_along_dim(gt, order[..., None], dim=-2)    # (B, n, m)
    lam = torch.take_along_dim(lam, order, dim=-1)
    tiny = _eps_floor(rdt)
    U = (gt / torch.clamp(lam, min=tiny)[..., None]).mT

    # polish: one Newton orthonormalisation of U, then V from A^H U =
    # V diag(s).  s stays the row norms, and V's columns are normalised by
    # |A^H u_i| (not divided by s): recomputing would inflate exact-zero
    # singular values to junk
    U = _newton_orthonormalize(U)
    W = dot_hi(a.mH, U)                                        # (B, n, r)
    wn = torch.sqrt((W.abs() ** 2).sum(-2))
    V = W / torch.clamp(wn, min=tiny)[..., None, :]
    s = lam
    good = lam > (4.0 * float(torch.finfo(rdt).eps) * math.sqrt(m_)
                  * lam[..., -1:] + tiny)
    U = _complete_null_columns(U, good)
    V = _complete_null_columns(V, good)
    # V never saw the U polish: one Newton step on it as well
    V = _newton_orthonormalize(V)
    return (U.reshape(*batch, m_, n_), s.reshape(*batch, n_),
            V.reshape(*batch, n_, n_))


def _sweep_dtype(dtype):
    """(real dtype the sweep kernel would see, packed-width factor) for
    float32 and complex64, else None."""
    if dtype == torch.float32:
        return torch.float32, 1
    if dtype == torch.complex64:
        return torch.float32, 2
    return None


def in_jacobi_window(n: int, dtype) -> bool:
    """Whether an (n, n) matrix of ``dtype`` lies in the sweep kernels'
    window on the card: float32 or complex64, 64 <= n, and the padded n at
    most 1024 rows (the packed complex panel is then 2 n <= 2048 wide,
    inside the 4096 columns).  Shape and type only: ``linalg.symeig``'s
    default routing asks this of an operator before it builds the matrix."""
    kind = _sweep_dtype(dtype)
    if kind is None or n < 64:
        return False
    npad = _padded_n(n)
    return fits_jacobi_sweep(npad, kind[1] * npad, kind[0], kind[1] == 2)


# Where the sweep kernels beat the library on the card, by batch: for each
# tabulated n (rows of the panel), the smallest batch at which the kernel's
# whole function (jacobi_eigh cold, jacobi_svd) was faster than the gate's
# library side (library_eigh / library_svd) of the same batch, None where it
# lost at every batch measured (1 to 32).  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W by chip_smoke.py's sweep_gate_table (n = 64 to 512 in every
# run of the script, n = 768 and 1024 by ``chip_smoke.py --gate-sizes
# 768,1024``).  The float32 rows since the real kernel splits a matrix over
# a cluster of CTAs: it wins from batch 1 at n = 256 (4.8 ms against 5.4)
# and from batch 2 up to 768 (svd at n = 64 from batch 4: below that both
# sides take a few ms of host time); at n = 768 a cluster of 16 CTAs runs
# eight matrices in two waves (the card holds seven such clusters at once),
# and at 1024 no cluster holds the panel, so the kernel works in device
# memory (0.8-1.1 s a launch against torch.linalg.eigh's 12-360 ms).  The
# complex rows since the complex kernel splits a matrix over a cluster too
# (up to n = 512; at 768 and 1024 its device-memory path, one block a
# matrix): eigh from batch 2 up to n = 128, 4 at 256 and 32 at 512, where
# the library's complex eigh is fast at small batch (6.4 ms at batch 1
# against the kernel's 27); svd from batch 1 at n = 128 and 256 and 2 at
# 512.  An n between rows takes the next larger row.
_GATE_N = (64, 128, 256, 512, 768, 1024)
_GATE_MIN_BATCH = {
    "eigh": (2, 2, 1, 2, 16, None),             # float32 symmetric
    "complex": (2, 2, 4, 32, None, None),       # complex64 hermitian
    "svd": (4, 2, 1, 2, 2, 32),                 # float32 general, by its small side
    "complex_svd": (4, 1, 1, 2, 32, None),      # complex64 general, by its small side
}


def _gate_min_batch(kind: str, n: int) -> Optional[int]:
    row = next((i for i, gn in enumerate(_GATE_N) if n <= gn), len(_GATE_N) - 1)
    return _GATE_MIN_BATCH[kind][row]


def _kernel_wins(kind: str, batch_shape, n: int) -> bool:
    need = _gate_min_batch(kind, n)
    return need is not None and math.prod(batch_shape) >= need


def use_jacobi_svd_for(A: torch.Tensor) -> bool:
    """Dispatch gate used by ``degen_svd``: a float32 or complex64 CUDA
    tensor whose small side is at least 64, whose panel (small side padded
    to 16 rows, long side wide, twice as wide when packed complex) lies in
    the kernels' window, and whose batch is at least the measured crossover
    for its type and small side (``_GATE_MIN_BATCH``)."""
    if not (ENABLED and _in_svd_window(A)):
        return False
    kind = "complex_svd" if A.is_complex() else "svd"
    return _kernel_wins(kind, A.shape[:-2], _padded_n(min(A.shape[-2:])))


def _in_svd_window(A: torch.Tensor) -> bool:
    """A float32 or complex64 CUDA tensor whose small side is at least 64
    and whose panel lies in the sweep kernels' window."""
    kind = _sweep_dtype(A.dtype)
    if not (A.is_cuda and A.dim() >= 2) or kind is None:
        return False
    r, w = min(A.shape[-2:]), max(A.shape[-2:])
    return bool(64 <= r and fits_jacobi_sweep(_padded_n(r), kind[1] * w, kind[0],
                                              kind[1] == 2))


def use_jacobi_for(A: torch.Tensor) -> bool:
    """Dispatch gate used by ``degen_eigh``: a CUDA tensor (*B, n, n) inside
    :func:`in_jacobi_window` whose batch is at least the measured crossover
    for its type and padded n (``_GATE_MIN_BATCH``)."""
    if not (ENABLED and A.is_cuda and A.dim() >= 2 and A.shape[-1] == A.shape[-2]
            and in_jacobi_window(A.shape[-1], A.dtype)):
        return False
    kind = "complex" if A.is_complex() else "eigh"
    return _kernel_wins(kind, A.shape[:-2], _padded_n(A.shape[-1]))


def library_eigh(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The library side of :func:`dense_eigh`: ``torch.linalg.eigh``, and on
    a CUDA matrix inside :func:`in_jacobi_window` (a batch the gate kept
    from the kernel) the kernel route's last step, one Newton
    orthonormalisation: float32 library vectors drift from orthonormal by
    ~n eps / gap, and both sides of the gate meet the same orthogonality."""
    evals, evecs = torch.linalg.eigh(A)
    if A.is_cuda and in_jacobi_window(A.shape[-1], A.dtype):
        evecs = _newton_orthonormalize(evecs)
    return evals, evecs


def library_svd(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The library side of :func:`dense_svd`: ``torch.linalg.svd`` in
    :func:`jacobi_svd`'s contract (``(U, s, V)``, ascending), with the same
    Newton step on U and V for a CUDA matrix inside the kernels' window."""
    uu, ss, vh = torch.linalg.svd(A, full_matrices=False)
    u, s, v = uu.flip(-1), ss.flip(-1), vh.mH.flip(-1)
    if _in_svd_window(A):
        u, v = _newton_orthonormalize(u), _newton_orthonormalize(v)
    return u, s, v


def dense_eigh(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a dense (*B, n, n) matrix on the side the gate
    picks: :func:`jacobi_eigh` (cold) where :func:`use_jacobi_for` says the
    sweep kernel wins, else :func:`library_eigh`.  ``degen_eigh`` and the
    solvers' Rayleigh-Ritz steps call this."""
    return jacobi_eigh(A) if use_jacobi_for(A) else library_eigh(A)


def dense_svd(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Economy SVD ``(U, s, V)``, ascending, on the side the gate picks:
    :func:`jacobi_svd` where :func:`use_jacobi_svd_for` says the sweep
    kernel wins, else :func:`library_svd`."""
    return jacobi_svd(A) if use_jacobi_svd_for(A) else library_svd(A)
