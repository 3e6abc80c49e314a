#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xitorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the main paths from ``xitorch_tpu_torch/csrc``
with ``nvcc`` (one compiler process per source, all started together),
holds each kernel against its plain PyTorch version at the shapes the main
paths give it, and drives these configurations through the public API:

* BASELINE config 3: a batch of 512 ``TridiagLowRankOperator`` systems,
  n = 1024, rank 4, float32, solved by
  ``linalg.solve(method="structured_cg")``, forward and implicit gradient
  (the structured-CG kernel's register design, its shared-memory design
  held and timed beside it), and with ``V = None`` forward and gradient
  (the Thomas kernel, beside a probe of its recurrence's chain alone);
* BASELINE config 2: 64 dense symmetric matrices of 256 x 256, float32,
  ``linalg.symeig(A, 8, "lowest")`` by exacteig, davidson, chebfsi and
  the default routing (which must be exacteig through the sweep kernel,
  converged and silent), ``linalg.svd`` of 64 general matrices, and the
  gradient to the dense A (the one-sided Jacobi sweep kernel, which must
  take its cluster path with 2 CTAs a matrix);
* the default routing outside the sweep kernel's window: ``method=None``,
  ``"exacteig"`` and ``"chebfsi"`` timed at 8 x 1536 x 1536, neig 8;
* config 2 with the warm start: the divide-and-conquer kernel against its
  plain version at (64, 256, 256), 8 levels, entry by entry one level at a
  time from the kernel's own state and by the invariants of the two free
  runs (and the same 592 products as ``torch.bmm``),
  ``jacobi_eigh(precondition=True)`` and ``symeig`` with the
  warm start forced against the cold route (quality gates, sweeps per
  matrix, guard fall-backs, decomps/s, device idle share);
* the per-level warm start past a padded n of 448: the level kernel
  against ``dc_level_plain`` one launch (one level) at a time from the
  kernel's own state at 8 x 700 x 700 (padded to 768, 10 levels) and
  8 x 512 x 512 (9 levels), the invariants at full depth, the real sweep
  kernel against its plain version on the cold panel at both sizes, then
  ``jacobi_eigh(precondition=True)`` against the cold sweep (quality gates,
  sweeps, guard fall-backs, one launch a level) and the level's products
  as ``torch.bmm``;
* config 2 with complex input: the complex sweep kernel against its plain
  version on (64, 256, 512) packed planes and one rectangular panel, 64
  hermitian complex64 matrices through ``linalg.symeig`` (default
  routing), ``linalg.svd`` of 64 complex general matrices, and the
  gradient of a phase-invariant loss against complex128
  ``torch.linalg.eigh`` autograd;
* the table behind the sweep kernels' gate: ``jacobi_eigh`` and
  ``jacobi_svd`` (float32, complex64) against the gate's library side
  (``torch.linalg.eigh`` and ``svd`` with one Newton step) at batches 1 to
  32 and n = 64 to 512, with the gate's choice;
* dense operators (path A): the fused dense CG kernel against its plain
  version at (64, 700, 700) with 50 right-hand sides and at the nine points
  of the upstream solve benchmark's grid that go through it, each with its
  design (clusters, columns a CTA, waves), timed in turns beside its
  device-memory path and, at the batched shape, against Cholesky over four
  eigenvalue ranges; then that grid (hermitian or not, four
  eigenvalue ranges, n = 100, 350, 700, 50 right-hand sides, float32)
  through ``linalg.solve`` by fused_cg, cg, cg_ir, bicgstab, gmres and the
  default routing (the non-hermitian float32 points held to the residual
  that float32 ``torch.linalg.solve`` leaves on the same system), and the
  batched point forward and gradient;
* Kron operators (path B): the real sweep kernel against its plain version
  on one 128 x 128 and one 64 x 64 factor panel (the shapes this path gives
  it), then a ``KronSumOperator`` of two shifted 128-point Laplacians
  (N = 16,384) and of three 64-point ones (N = 262,144) through
  ``linalg.solve`` (default routing: kron_direct) beside cg, with and
  without shifts E, ``linalg.symeig`` (default routing: kron_exact) against
  the analytic spectrum, and the gradients to the factors (the factors
  decompose where the gate sends them; ``kron_direct`` is also timed with
  every factor forced through the sweep kernel);
* BASELINE config 1: the README's 2 x 2 tanh root with first- and
  second-order implicit gradients, then ``benchmarks/bench_optimize.py``'s
  512 systems of n = 32 as one joint system through ``rootfinder``
  (broyden1), ``equilibrium`` (anderson_acc) and ``minimize`` (lbfgs),
  forward and gradient; no kernel of the package is on this path;
* BASELINE config 5: the SCF loop of ``models.scf`` (symeig nested in
  equilibrium) at n = 256, nocc = 8, in float32 with exacteig (each step
  decomposes the Hamiltonian through the real sweep kernel, which is also
  held against its plain version on that panel) and in float64 with
  davidson, forward and the energy's gradient against the float64
  ``torch.linalg.eigh`` route; then the DEQ model at
  ``benchmarks/bench_deq.py``'s shape, a few ``torch.optim.Adam`` steps;
* BASELINE config 4: ``benchmarks/bench_ivp.py``'s 512 chains through
  ``solve_ivp`` rk45 under ``torch.func.vmap``, the
  ``examples/02-molecular-dynamics`` problem's gradient to v0 by autodiff
  and by backsolve, and the neural ODE; then ``quad`` and ``mcquad``
  against closed forms (no kernel on these paths);
* interpolation and sampled quadrature at ``benchmarks/
  bench_quad_interp.py``'s workload (512 curves on 1,000 knots, 2,048
  queries, float32): ``interpolate.Interp1D`` (cspline natural and
  clamped, whose slopes solve through the Thomas kernel; not-a-knot,
  linear, pchip) and ``integrate.SQuad`` (cspline, trapz, simpson),
  forward and gradient, against scipy's float64 splines, with the Thomas
  kernel held against its plain version on the spline's system.

It reads the kernels' launch counters to show that each main path went
through its kernels, and times kernels, forward and gradient with CUDA
events.  Each kernel's record carries its time, its plain version's time,
the least time the card could take for the same work (``bound_ms``: bytes
moved once over 3.35 TB/s, or float32 operations over 67 TFLOP/s,
whichever is larger) and, where one PyTorch call computes the same
function, that call's time (``library_ms``).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and the line before
that the per-kernel JSON record.  Any failed check raises, so the script
exits non-zero and prints no result.  Without a CUDA device it exits 2.

    python3 chip_smoke.py --gate-sizes 768,1024

only builds the kernels and measures the gate's table at those sizes (the
gate's rows above 512 come from this), without holding the gate to it.

    python3 chip_smoke.py --only solve
    python3 chip_smoke.py --only dc
    python3 chip_smoke.py --only dc_level
    python3 chip_smoke.py --only sweep
    python3 chip_smoke.py --only complex
    python3 chip_smoke.py --only models
    python3 chip_smoke.py --only integrate
    python3 chip_smoke.py --only interpolate

build the kernels and run only config 3's phase (the structured CG and
Thomas kernels, their designs, the replaced Thomas kernel and the chain
floor), only config 2's warm start phase (the single-shot DC kernel),
only the per-level warm start's phase, only config 2's phase (the real
sweep kernel, its path and cluster size) and the sweep gate's table, or
only config 2's complex phase (the complex
sweep kernel, its path, cluster size, waves and designs) and the sweep
gate's table, only config 5 and the DEQ model, only config 4 with
quad and mcquad, or only Interp1D and SQuad, with the same last lines:
development switches for work on those paths.  The default run is the full script.
"""
from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# BASELINE config 3 (bench.py): batch, size, rank, solver tolerances, and
# the residual gate the benchmark asserts before timing
BATCH, N, RANK = 512, 1024, 4
RTOL, ATOL = 1e-6, 1e-8
RESID_GATE = 5e-4
SEED = 0
REPS = 5    # timed repetitions; the median is reported
INNER = 10  # back-to-back calls per timed repetition

# BASELINE config 2 (benchmarks/bench_symeig.py): batch, size, eigenpairs
B2, N2, NEIG = 64, 256, 8
CHEBFSI_OPTS = {"min_eps": 1e-3, "max_niter": 40, "nguess": 32, "degree": 24}
DAVIDSON_OPTS = {"min_eps": 2e-3, "max_niter": 800}

# the card's published peaks (H100 SXM data sheet): device memory
# bandwidth and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# a shape outside the sweep kernels' window, where the default routing's
# gate is measured; and the sizes beyond config 2 where the warm start is
# held to the quality gates (batch 8)
ROUTE_SHAPE = (8, 1536)
WARM_BIG = (512, 700)

# the sweep-kernel gate's table (sweep_gate_table): batches and sizes, and
# the ratio past which the gate must pick the faster side
GATE_BATCHES = (1, 2, 4, 8, 16, 32)
GATE_SIZES = (64, 128, 256, 512)
GATE_CLEAR = 1.5

# the DC kernel against its plain version, one level at a time (see
# dc_level_by_level): largest entrywise difference of G0 and T after a level,
# as a share of their largest entry; a level that amplifies rounding may
# differ by up to DC_LEVEL_F64 times what the plain version's own float64
# run of that level differs from it
DC_LEVEL_TOL = 1e-4
DC_LEVEL_F64 = 4.0


# the device time of the Thomas kernel the present design replaced (one
# thread a system), at config 3 on an NVIDIA H100 80GB HBM3 at 700 W,
# timed in turns with the present one while both were built (PERF.md)
THOMAS_REPLACED_MS = 0.5844

# path A: the upstream solve benchmark's grid (benchmarks/benchmarks_solve.py)
# and one batched point at full width
GRID_SIZES = (100, 350, 700)
GRID_RANGES = ((-1.0, 1.0), (0.0, 1.0), (0.2, 1.0), (0.5, 1.0))
GRID_NCOLS, GRID_SEED, GRID_MINABS = 50, 12, 0.1
GRID_RTOL, GRID_ATOL = 1e-5, 1e-7
DENSE_BATCH, DENSE_N, DENSE_RANGE = 64, 700, (0.2, 1.0)
# cluster sizes the fused CG kernel is also timed on at the grid point
GRID_CLUSTERS = (7, 10, 13, 16)
# the fused kernel stops on the recurrence residual; the measured residual
# differs from it by the rounding of the steps taken (about
# steps * eps * |A| |x|, a few percent of the stop at these shapes)
RESID_DRIFT = 1.1
# a non-hermitian float32 point that does not reach rtol must come within
# this multiple of the residual float32 torch.linalg.solve leaves there
FLOOR_MULT = 10.0

# config 1: benchmarks/bench_optimize.py's forward workload (systems, n) and
# its per-system tolerance
OPT_SHAPE = (512, 32)
OPT_TOL = 5e-5
# the one config-1 route whose idle share torch.profiler reads
PROFILED_OPT = "rootfinder broyden1"

# path B: benchmarks/bench_kron.py's operator, and the 3-factor size that
# cannot be materialised
KRON_POINTS = ((128, 128), (64, 64, 64))
KRON_NCOLS, KRON_NEIG = 4, 8
KRON_CG = {"rtol": 1e-5, "atol": 1e-6, "max_niter": 600}


# BASELINE config 5 (models/scf.py on tests/test_scf.py's recipe): the
# Hamiltonian's size (the largest n at which the gate sends one matrix to
# the sweep kernel), occupied orbitals and coupling; the float32 run's f_tol
# and x_tol: the sweep kernel's eigenvectors (gauge tolerance 4 eps sqrt(n))
# leave ~2e-5 in the density's residual on the card, far out of reach of
# the module's float64 defaults
SCF_N, SCF_NOCC, SCF_G = 256, 8, 0.3
SCF_TOL32 = 1e-4
# the DEQ model at benchmarks/bench_deq.py's shape (batch, d_in, hidden,
# d_out) and its train steps
DEQ_SHAPE = (256, 64, 256, 8)
DEQ_STEPS = 5
# BASELINE config 4 (benchmarks/bench_ivp.py): trajectories, masses a chain,
# output times over 6 s; the neural ODE's batch, d_in, hidden, d_out
IVP_B, IVP_M, IVP_NT = 512, 32, 64
NODE_SHAPE = (256, 16, 64, 4)
# interpolation and sampled quadrature (benchmarks/bench_quad_interp.py's
# workload, uncut): curves on shared knots, knots, queries; the benchmark's
# accuracy gate (max abs error over the first GATE_CURVES curves against
# scipy's float64 spline, relative to max(1, max |ref|)) and the float32
# gradients' limit against the same path in float64
NCURVE, NKNOT, NQ = 512, 1000, 2048
INTERP_GATE, GATE_CURVES = 2e-4, 16
INTERP_GRAD_TOL = 1e-3
# queries outside [0, 1] for the clamped spline's mirror extrapolation
MIRROR_QUERIES = (-0.2, -0.05, 1.05, 1.3)
# examples/02-molecular-dynamics's start: jax.random.normal(PRNGKey(0),
# (4, 2)) * 1.5 as the example draws it, written out here (the port and
# this script import no JAX)
EXAMPLE_POS0 = ((2.4339632987976074, 3.0378971099853516),
                (-0.6503916382789612, -0.11792602390050888),
                (0.26413634419441223, -1.4581338167190552),
                (-0.7429481148719788, 0.7415679097175598))
# the JAX package's float64 gradients of examples/02's loss to v0 = 0 at
# that start (rk45, atol 1e-8, rtol 1e-7), by each adjoint; tests/
# test_torch_integrate.py holds these values against JAX and the port's
# float64 backsolve against JAX's backsolve
EXAMPLE_GRAD = {
    "autodiff": ((0.6691269801861585, 0.9338990998552227),
                 (-4.0637429356801835, -4.555981070577187),
                 (0.9103032217718112, 2.7905592772681005),
                 (3.1366926543601195, 1.9332252665780107)),
    "backsolve": ((0.669567289316317, 0.9332363770228173),
                  (-4.481839826339452, -1.7765987385130764),
                  (0.9367823636102668, 2.7687837781081983),
                  (3.527870111002663, -0.8237188386186441)),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def print_device(torch) -> None:
    """The last two lines of a run that passed: the card's name and power
    limit, then the result line."""
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed_ms(torch, fn, reps: int = REPS, inner: int = INNER, warmup: bool = True) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls of ``fn()``, per call, after one warm-up call (``warmup=False``:
    none, for a function that already ran at these shapes)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / inner)
    return statistics.median(ts)


PROFILE_TRIES = 3
# where the profiler keeps losing the card, the whole call timed by CUDA
# events stands under this name
EVENTS_KEY = "(CUDA events: the whole call)"


def device_ms_by_name(torch, fn, calls: int = REPS, warmup: bool = True,
                      expect=()) -> dict:
    """Device time of each kernel ``fn()`` launches, ms per call by name,
    from ``torch.profiler`` over ``calls`` calls after one warm-up call
    (``warmup=False``: none, for a function that already ran at these
    shapes).
    Only events on the card count (the profiler also files module loading
    under device time).  Now and then a trace comes back with no event on
    the card at all, or, late in a long process, without the kernels of
    this package's libraries (launched through ``ctypes``) while PyTorch's
    own still show: a trace with no event on the card, or with no event
    whose name holds each part in ``expect``, is taken again, up to
    ``PROFILE_TRIES`` times in all, and each retake is printed.  If every
    trace lost them, the call is timed by CUDA events instead (printed),
    and the result is ``{EVENTS_KEY: ms a call}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key: e.self_device_time_total / calls / 1e3
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        missing = [part for part in expect if not any(part in k for k in by_name)]
        if by_name and not missing:
            return by_name
        print("  profiler: trace %d of %d held %s; taking it again"
              % (attempt, PROFILE_TRIES, "no event of %s" % missing if by_name
                 else "no event on the card"))
    # back to back, so that a short kernel's time is not its launch's
    ms = timed_ms(torch, fn, reps=max(calls, 1), inner=INNER if calls > 1 else 1,
                  warmup=False)
    print("  profiler: no trace of %d held the card's events%s; the call timed by CUDA "
          "events instead: %.4f ms (device time by name not measured here)"
          % (PROFILE_TRIES, " of %s" % list(expect) if expect else "", ms))
    return {EVENTS_KEY: ms}


def device_busy_ms(torch, fn, calls: int = REPS, top: int = 0, warmup: bool = True,
                   expect=()):
    """Summed device time of the kernels ``fn()`` launches, per call (see
    :func:`device_ms_by_name`; ``expect``: name parts of kernels ``fn()``
    launches).  With ``top``, also the ``top`` largest entries as ``(name,
    ms per call)``.  Where the profiler lost the card, the call's time by
    CUDA events (an upper bound: idle share 0)."""
    by_name = device_ms_by_name(torch, fn, calls, warmup, expect)
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    if not top:
        return busy
    return busy, sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def kernel_device_ms(torch, fn, part: str, calls: int = REPS) -> float:
    """Device time (ms a call) of the one kernel ``fn()`` launches whose
    name holds ``part`` (:func:`device_ms_by_name`, :func:`kernel_ms`)."""
    return kernel_ms(device_ms_by_name(torch, fn, calls, expect=(part,)), part)


def bound(nbytes: float, flops: float):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and IEEE float32 operations over their peak rate, and which
    it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bound(B: int, n: int, sweeps, rotations):
    """The real sweep kernel's bound on a run's data, B square panels of n:
    the panels read once and written once; per matrix the pair dots of
    every round played (2 width operations each), the rotations that were
    applied (8 width), and one gauge (upper triangle) and norm refresh
    before the first sweep and after each.  ``sweeps``, ``rotations``: the
    kernel's per-matrix counts."""
    rounds = -(-(n - 1) // 6) * 6
    sweeps_total, rot_total = float(sweeps.sum()), float(rotations.sum())
    flops = (sweeps_total * rounds * (n // 2) * 2 * n + rot_total * 8 * n
             + (sweeps_total + B) * (n * (n - 1) // 2 + n) * 2 * n)
    return bound(2 * B * n * n * 4, flops)


def timed_once(torch, fn):
    """``(fn(), ms)``: one call timed by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def rel_l2_all(got, ref) -> float:
    """Relative L2 distance of a sequence of tensors from a reference
    sequence, over all of them together."""
    num = sum(float(((g.double() - r.double()) ** 2).sum()) for g, r in zip(got, ref))
    den = sum(float((r.double() ** 2).sum()) for r in ref)
    return math.sqrt(num / den)


def tile_operations(torch, seg, tile):
    """Operations one product of a DC level runs on its ``tile``-wide output
    tiles, summed over the (B, n, 1) ids ``seg`` the level starts from:
    each tile multiplies over the k-range that
    ``ops/dc_level.py::band_ranges`` gives it (the rule of
    ``csrc/dc_level.cu`` and ``csrc/dc_kernel.cu``).  Returns
    ``(block-diagonal product, row band: op(A) block-diagonal and B dense,
    column band: A dense and B block-diagonal)``."""
    from xitorch_tpu_torch.ops.dc_level import band_ranges

    n = seg.shape[1]
    lo, hi = (v.double() for v in band_ranges(seg, tile))
    h = torch.tensor([float(min(tile, n - r)) for r in range(0, n, tile)],
                     dtype=torch.float64, device=lo.device)
    k = (torch.minimum(hi[:, :, None], hi[:, None, :])
         - torch.maximum(lo[:, :, None], lo[:, None, :])).clamp(min=0)
    diag = 2.0 * float((h[:, None] * h[None, :] * k).sum())
    rows = 2.0 * float((h[None, :, None] * h[None, None, :] * (hi - lo)[:, :, None]).sum())
    cols = 2.0 * float((h[None, :, None] * h[None, None, :] * (hi - lo)[:, None, :]).sum())
    return diag, rows, cols


def level_tile_operations(torch, seg):
    """Operations one product of a per-level DC level runs on its 128 x 128
    tiles (:func:`tile_operations`).  Returns ``(block-diagonal product,
    G0 <- Q^T G0)``."""
    from xitorch_tpu_torch.ops.dc_level import _TILE

    return tile_operations(torch, seg, _TILE)[:2]


def kernel_ms(by_name: dict, part: str) -> float:
    """Device time (ms a call) of the one kernel whose name holds ``part``
    in a :func:`device_ms_by_name` table (or the events time that stands
    in for it where the profiler lost the card)."""
    if EVENTS_KEY in by_name:
        return by_name[EVENTS_KEY]
    hits = [v for k, v in by_name.items() if part in k]
    check(len(hits) == 1, "%d kernels named like %r: %s" % (len(hits), part, sorted(by_name)))
    return hits[0]


# The Thomas recurrence's chain alone (the "chain floor"): the forward and
# back steps of csrc/tridiag.cu on rows held in registers (eight a lane,
# reused), one lane a system and one warp a block of 32 systems, as the
# kernel runs them, with no memory in the chain.
CHAIN_PROBE = r"""
#include <cuda_runtime.h>
template <typename T>
__global__ void chain_kernel(const T* __restrict__ rows, T* __restrict__ out, int n, T eps) {
  const int k = blockIdx.x * 32 + threadIdx.x;
  T l[8], dd[8], u[8], bb[8];
  for (int j = 0; j < 8; ++j) {
    l[j] = rows[(0 * 8 + j) * 32 + threadIdx.x];
    dd[j] = rows[(1 * 8 + j) * 32 + threadIdx.x];
    u[j] = rows[(2 * 8 + j) * 32 + threadIdx.x];
    bb[j] = rows[(3 * 8 + j) * 32 + threadIdx.x];
  }
  T cprev = T(0), yprev = T(0);
  int i = 0;
  for (; i + 8 <= n; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T m = dd[j] - l[j] * cprev;
      if (m == T(0)) m = eps;
      cprev = u[j] / m;
      yprev = (bb[j] - l[j] * yprev) / m;
    }
  }
  T xn = yprev;
  i = 0;
  for (; i + 8 <= n - 1; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) xn = bb[j] - u[j] * xn;
  }
  for (; i < n - 1; ++i) xn = bb[0] - u[0] * xn;
  out[k] = xn + cprev;
}
extern "C" int chain_f32(const float* rows, float* out, int n, int K, float eps, void* s) {
  chain_kernel<float><<<(K + 31) / 32, 32, 0, (cudaStream_t)s>>>(rows, out, n, eps);
  return (int)cudaGetLastError();
}
"""


def start_chain_probe():
    """Start compiling the chain probe beside the kernels; returns a
    function that waits for the build and returns the loaded library."""
    import ctypes

    from xitorch_tpu_torch.ops import _build

    os.makedirs(_build._BUILD, exist_ok=True)
    src = os.path.join(_build._BUILD, "chain_probe.cu")
    lib = os.path.join(_build._BUILD, "chain_probe.%d.so" % os.getpid())
    with open(src, "w") as f:
        f.write(CHAIN_PROBE)
    cmd = [_build._nvcc(), *_build._FLAGS, "-o", lib, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        check(proc.returncode == 0, "the chain probe did not build:\n%s" % log)
        cdll = ctypes.CDLL(lib)
        P = ctypes.c_void_p
        cdll.chain_f32.argtypes = [P, P, ctypes.c_int, ctypes.c_int, ctypes.c_float, P]
        cdll.chain_f32.restype = ctypes.c_int
        return cdll

    return finish


def config3_arrays(np, rng):
    """bench.py's config-3 operator recipe, drawn with numpy."""
    d = 4.0 + 2.0 * rng.uniform(size=(BATCH, N))
    V = rng.standard_normal((BATCH, N, RANK)) / math.sqrt(N)
    b = rng.standard_normal((BATCH, N, 1))
    return d, V, b


def shifted_panel(torch, mats):
    """The panel ``jacobi_eigh`` hands the sweep kernel for symmetric
    ``mats`` (B, n, n) with n a multiple of 16: the input shifted positive
    definite by its one-sided Gershgorin bound plus 1% of its Frobenius norm."""
    diag = torch.diagonal(mats, dim1=-2, dim2=-1)
    lower = (diag - (mats.abs().sum(-1) - diag.abs())).amin(-1)
    sigma = torch.clamp(-lower, min=0.0) + 0.01 * torch.linalg.norm(mats, dim=(-2, -1))
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)
    return (mats + sigma[:, None, None] * eye).contiguous()


def sweep_checks(torch, name, P, Gk, Gp, sk, sp, gk, tol, spectrum, complexpair=False,
                 cluster=None):
    """Hold a sweep kernel's output ``Gk`` against the plain version's
    ``Gp`` on the panel ``P`` (neither promises a row order, so everything
    compared is invariant under one).  ``spectrum``: the float64 row norms
    expected at convergence, ascending.  With ``complexpair`` the panels are
    packed planes ``[Re | Im]`` and the invariant is the hermitian
    ``G^H G``.  ``cluster``: the real kernel's path for this launch
    (``jacobi_sweep_cuda.last_cluster``), printed.  Returns the max abs
    difference of the sorted row norms."""
    from xitorch_tpu_torch.ops.jacobi_eigh import _max_cos2

    def wide(G):
        G = G.double()
        if not complexpair:
            return G
        hw = G.shape[-1] // 2
        return torch.complex(G[..., :hw], G[..., hw:])

    check(bool(torch.isfinite(Gk).all()), "%s: kernel returned non-finite values" % name)
    tol2 = tol * tol
    gauges = [float(_max_cos2(G, complexpair).max()) for G in (Gk, Gp)]
    check(max(gauges) <= tol2 and float(gk.max()) <= tol2,
          "%s: gauge above tol^2: kernel %.3e (its own reading %.3e), plain %.3e, "
          "tol^2 %.3e" % (name, gauges[0], float(gk.max()), gauges[1], tol2))
    # the sweep only rotates rows: G^T G keeps the input's
    ref = wide(P).mH @ wide(P)
    invs = [float(torch.linalg.norm(wide(G).mH @ wide(G) - ref)
                  / torch.linalg.norm(ref)) for G in (Gk, Gp)]
    nk, npl = (torch.sort(torch.linalg.norm(G.double(), dim=-1), dim=-1).values
               for G in (Gk, Gp))
    scale = float(spectrum.max())
    rel = float((nk - npl).abs().max()) / scale
    dsweeps = int((sk - sp).abs().max())
    spec = float((nk - spectrum).abs().max()) / scale
    path = ("" if cluster is None else ", path: cluster of %d CTAs a matrix" % cluster
            if cluster else ", path: device memory")
    print("%s kernel vs plain: gauge %.2e / %.2e (tol^2 %.2e), G-invariant %.2e / "
          "%.2e, sorted row norms rel diff %.2e, vs float64 spectrum %.2e, sweeps "
          "%d..%d (mean %.2f, max |diff| %d)%s"
          % (name, gauges[0], gauges[1], tol2, invs[0], invs[1], rel, spec,
             int(sk.min()), int(sk.max()), float(sk.float().mean()), dsweeps, path))
    # float32 rounding of ~n rotations per row and sweep
    check(max(invs) <= 1e-5, "%s: G-invariant broken: %s" % (name, invs))
    # sums in another order; both left on a measured gauge
    check(rel <= 1e-5, "%s: row norms disagree with plain: %.3e" % (name, rel))
    check(dsweeps <= 1, "%s: sweep counts differ by %d" % (name, dsweeps))
    check(spec <= 1e-4, "%s: row norms off the float64 spectrum: %.3e" % (name, spec))
    return float((nk - npl).abs().max())


def config2_batch(torch, np, device):
    """Config 2's SPD batch (``bench_symeig.py``'s recipe, drawn with numpy
    from ``SEED``), the panel ``jacobi_eigh`` hands the sweep kernel (the
    Gershgorin-shifted input) and the sweep tolerance.  Returns
    ``(rng, mats, mats_np, panel, tol)``; ``rng`` goes on to draw the
    general batch."""
    rng = np.random.default_rng(SEED)
    a_np = rng.standard_normal((B2, N2, N2)) / math.sqrt(N2)
    mats = torch.as_tensor(a_np @ a_np.transpose(0, 2, 1) + 2.0 * np.eye(N2),
                           dtype=torch.float32, device=device)
    tol = float(torch.finfo(torch.float32).eps) * 4.0 * math.sqrt(N2)
    return rng, mats, mats.double().cpu().numpy(), shifted_panel(torch, mats), tol


def config2(torch, np, xt, device, card):
    """BASELINE config 2 on the card: the Jacobi sweep kernel against its
    plain version, symeig/svd forward and gradient through the public API,
    and timings.  Returns the kernel's record for the JSON line and what the
    later phases share (the batch, its shifted panel, the cold numbers)."""
    import warnings

    from xitorch_tpu_torch.ops import jacobi_eigh as jmod
    from xitorch_tpu_torch.ops.jacobi_eigh import (
        jacobi_eigh, jacobi_svd, jacobi_sweep_cuda, jacobi_sweep_plain,
    )
    from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning

    f32 = torch.float32

    def dev(a, dtype=f32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    # bench_symeig.py's recipes, drawn with numpy: an SPD batch and a
    # general batch
    rng, mats, mats_np, panel, tol = config2_batch(torch, np, device)
    gmats_np = rng.standard_normal((B2, N2, N2)) / math.sqrt(N2)
    gmats = dev(gmats_np)
    gmats_np = gmats.double().cpu().numpy()
    max_sweeps = 18

    # ---- kernel vs plain at the config-2 panel and one rectangular panel ----
    Gk, sk, gk, rk = jacobi_sweep_cuda(panel, max_sweeps, tol, return_stats=True)
    cluster = jacobi_sweep_cuda.last_cluster
    Gp, sp = jacobi_sweep_plain(panel, max_sweeps, tol)
    torch.cuda.synchronize()
    spectrum = torch.linalg.eigvalsh(panel.double())
    sq_err = sweep_checks(torch, "jacobi_sweep (%d, %d, %d)" % (B2, N2, N2), panel, Gk,
                          Gp, sk, sp, gk, tol, spectrum, cluster=cluster)
    # config 2's 256 KB panels: two 128 KB column slices a matrix, 128 CTAs
    check(cluster == 2, "config 2: the sweep kernel took path %s, not a cluster of 2"
          % cluster)
    # rows = the first 128 columns of the general batch: Hestenes' SVD
    rect = gmats[:, :, :N2 // 2].mT.contiguous()
    tol_r = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(N2 // 2)
    Rk, rsk, rgk, _ = jacobi_sweep_cuda(rect, max_sweeps, tol_r, return_stats=True)
    r_cluster = jacobi_sweep_cuda.last_cluster
    Rp, rsp = jacobi_sweep_plain(rect, max_sweeps, tol_r)
    torch.cuda.synchronize()
    sweep_checks(torch, "jacobi_sweep (%d, %d, %d)" % (B2, N2 // 2, N2), rect, Rk, Rp,
                 rsk, rsp, rgk, tol_r,
                 torch.linalg.svdvals(rect.double()).flip(-1), cluster=r_cluster)

    counts = {"fwd": 0, "default": 0, "svd": 0, "grad": 0}

    def driven(key, fn):
        """Run one main path with the counter at 0 just before it and read
        just after."""
        jacobi_sweep_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[key] += jacobi_sweep_cuda.launches
        return out

    # ---- config 2, forward ----
    A = xt.LinearOperator.m(mats, is_hermitian=True)
    e0 = np.linalg.eigvalsh(mats_np)[:, :NEIG]
    scale = np.abs(np.linalg.eigvalsh(mats_np)).max(-1, keepdims=True)
    anorm = np.linalg.norm(mats_np, axis=(1, 2))[:, None]

    def quality(evals, evecs):
        lam = evals.double().cpu().numpy()
        V = evecs.double().cpu().numpy()
        err = float(np.max(np.abs(lam - e0) / scale))
        colres = float((np.linalg.norm(mats_np @ V - V * lam[:, None, :], axis=1)
                        / anorm).max())
        orth = float(np.abs(V.transpose(0, 2, 1) @ V - np.eye(NEIG)).max())
        return err, colres, orth

    evals, evecs = driven("fwd", lambda: xt.linalg.symeig(A, NEIG, "lowest",
                                                          method="exacteig"))
    err, colres, orth = quality(evals, evecs)
    print("config 2 exacteig: evals rel err %.2e, residual/|A| %.2e, |X^T X - I|_max "
          "%.2e, jacobi launches %d" % (err, colres, orth, counts["fwd"]))
    check(tuple(evals.shape) == (B2, NEIG) and tuple(evecs.shape) == (B2, N2, NEIG),
          "exacteig: bad shapes")
    # the float32 gates of the reference's Jacobi tests
    check(err <= 1e-5 and colres < 2e-5 and orth < 5e-5, "exacteig: outside the gates")
    check(counts["fwd"] >= 1, "exacteig: the jacobi kernel was not launched")

    for method, opts in (("chebfsi", CHEBFSI_OPTS), ("davidson", DAVIDSON_OPTS)):
        ev, X, info = xt.linalg.symeig(A, NEIG, "lowest", method=method,
                                       return_info=True, **opts)
        err, colres, orth = quality(ev, X)
        print("config 2 %s: converged %.0f after %.0f iterations, evals rel err %.2e, "
              "residual/|A| %.2e, |X^T X - I|_max %.2e"
              % (method, float(info["converged"]), float(info["iterations"]), err,
                 colres, orth))
        check(float(info["converged"]) == 1.0, "%s did not converge" % method)
        # the residual target is min_eps (absolute, on ||A|| ~ 6): values are
        # bounded by the residual norm, vectors orthonormal to float32
        check(err <= 1e-3 and orth < 5e-5, "%s: outside the gates" % method)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ev, X, info = driven("default", lambda: xt.linalg.symeig(
            A, NEIG, "lowest", return_info=True))
    from xitorch_tpu_torch.linalg.symeig import _auto_symeig_method
    err, colres, orth = quality(ev, X)
    route = _auto_symeig_method(A, NEIG, None)
    print("config 2 default routing (%s): converged %.0f, evals rel err %.2e, "
          "residual/|A| %.2e, |X^T X - I|_max %.2e, jacobi launches %d, warnings: %s"
          % (route, float(info["converged"]), err, colres, orth, counts["default"],
             [w.category.__name__ for w in caught]))
    # inside the sweep kernel's window the default is the dense route
    check(route == "exacteig", "default routing is not exacteig")
    check(float(info["converged"]) == 1.0, "default routing did not converge")
    check(not caught, "default routing warned: %s" % [str(w.message) for w in caught])
    check(counts["default"] >= 1, "default routing did not launch the jacobi kernel")
    check(err <= 1e-5 and colres < 2e-5 and orth < 5e-5,
          "default routing: outside the gates")

    G = xt.LinearOperator.m(gmats, is_hermitian=False)
    s0 = np.linalg.svd(gmats_np, compute_uv=False)[:, :NEIG][:, ::-1]
    u, sv, vh = driven("svd", lambda: xt.linalg.svd(G, NEIG, method="exacteig"))
    serr = float(np.max(np.abs(sv.double().cpu().numpy() - s0) / s0[:, -1:]))
    rec = float(((u * sv[..., None, :]) @ vh - gmats @ vh.mT @ vh).abs().max())
    print("config 2 svd (exacteig route): top-%d singular values rel err %.2e, "
          "|U S V^T - A V V^T|_max %.2e, jacobi launches %d"
          % (NEIG, serr, rec, counts["svd"]))
    check(tuple(u.shape) == (B2, N2, NEIG) and tuple(vh.shape) == (B2, NEIG, N2),
          "svd: bad shapes")
    check(serr <= 1e-4 and rec <= 1e-4, "svd: outside the gates")
    check(counts["svd"] >= 1, "svd: the jacobi kernel was not launched")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, sv_d, _ = xt.linalg.svd(G, NEIG)   # top-k: Gram + chebfsi
    serr_d = float(np.max(np.abs(sv_d.double().cpu().numpy() - s0) / s0[:, -1:]))
    print("config 2 svd (default routing): rel err %.2e, warnings: %s"
          % (serr_d, [w.category.__name__ for w in caught]))
    # the gate bench_symeig.py asserts before timing
    check(serr_d < 5e-3, "svd default routing: singular values off by %.3e" % serr_d)

    # ---- config 2, gradient: gap-controlled spectrum (lowest-8 gaps 0.2) ----
    lam = np.concatenate([np.linspace(0.2, 1.6, NEIG), np.linspace(2.0, 6.0, N2 - NEIG)])
    q = np.linalg.qr(rng.standard_normal((B2, N2, N2)))[0]
    gap_np = (q * lam) @ q.transpose(0, 2, 1)
    gap = dev((gap_np + gap_np.transpose(0, 2, 1)) / 2)
    w_e = dev(rng.standard_normal((B2, NEIG)))
    w_p = dev(rng.standard_normal((B2, N2, N2)))

    def loss_of(evals, X):
        # eigenvalues and the projector X X^T: invariant under rotations
        # inside a degenerate cluster
        return (evals * w_e.to(evals.dtype)).sum() \
            + ((X @ X.mT) * w_p.to(X.dtype)).sum()

    def grad_route(method, **opts):
        leaf = gap.detach().clone().requires_grad_()
        Ag = xt.LinearOperator.m((leaf + leaf.mT) / 2, is_hermitian=True)
        ev, X = xt.linalg.symeig(Ag, NEIG, "lowest", method=method, **opts)
        (g,) = torch.autograd.grad(loss_of(ev, X), leaf)
        return g

    def rel_l2(a, b):
        return float(torch.linalg.norm(a.double() - b.double())
                     / torch.linalg.norm(b.double()))

    leaf64 = gap.double().requires_grad_()
    ev64, X64 = torch.linalg.eigh((leaf64 + leaf64.mT) / 2)
    (g64,) = torch.autograd.grad(loss_of(ev64[:, :NEIG], X64[:, :, :NEIG]), leaf64)

    g_exact = driven("grad", lambda: grad_route("exacteig"))
    real_kernel = jmod.jacobi_sweep_cuda
    jmod.jacobi_sweep_cuda = lambda p, ms, t, complexpair=False: \
        jacobi_sweep_plain(p, ms, t, complexpair)
    cheb_grad_opts = dict(CHEBFSI_OPTS, min_eps=1e-4)
    try:
        g_exact_plain = grad_route("exacteig")
        g_cheb_plain = grad_route("chebfsi", **cheb_grad_opts)
    finally:
        jmod.jacobi_sweep_cuda = real_kernel
    g_cheb = grad_route("chebfsi", **cheb_grad_opts)
    torch.cuda.synchronize()
    r_plain, r_64 = rel_l2(g_exact, g_exact_plain), rel_l2(g_exact, g64)
    r_cheb_same = rel_l2(g_cheb, g_cheb_plain)
    r_cheb, r_cheb64 = rel_l2(g_cheb, g_exact_plain), rel_l2(g_cheb, g64)
    print("config 2 gradient to the dense A: exacteig rel L2 vs the plain sweep %.2e, "
          "vs float64 torch.linalg.eigh autograd %.2e; chebfsi route vs itself on the "
          "plain sweep %.2e, vs the plain-sweep exacteig %.2e, vs float64 %.2e; jacobi "
          "launches %d" % (r_plain, r_64, r_cheb_same, r_cheb, r_cheb64, counts["grad"]))
    check(bool(torch.isfinite(g_exact).all()) and bool(torch.isfinite(g_cheb).all()),
          "gradient: non-finite values")
    check(counts["grad"] >= 1, "gradient: the jacobi kernel was not launched")
    # float32 eigenvectors at gaps of 0.2: eps*||A||/gap per vector, summed
    # over a 256 x 256 projector
    check(r_plain <= 1e-3, "exacteig gradient disagrees with the plain sweep")
    check(r_64 <= 5e-3, "exacteig gradient disagrees with float64 eigh")
    # the chebfsi route's Rayleigh-Ritz matrices are below the kernel's
    # window, so swapping the plain sweep in changes nothing for it; against
    # the dense route its residual target (1e-4) over gaps of 0.2 bounds the
    # error of the vectors, so it is held to the same limits
    check(r_cheb_same <= 1e-3 and r_cheb <= 1e-3 and r_cheb64 <= 5e-3,
          "chebfsi gradient disagrees")

    # ---- timing ----
    def once(fn, reps=3, warmup=True):
        return timed_ms(torch, fn, reps=reps, inner=1, warmup=warmup)

    k_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(panel, max_sweeps, tol), inner=3)
    gauge_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(panel, 0, tol), inner=3)
    copy_ms = timed_ms(torch, lambda: panel.clone(), inner=3)
    # the plain sweep (seconds a call) already ran on this panel above
    plain_ms = once(lambda: jacobi_sweep_plain(panel, max_sweeps, tol), reps=1, warmup=False)
    lib_eigh_panel_ms = once(lambda: torch.linalg.eigh(panel))
    je_ms = timed_ms(torch, lambda: jacobi_eigh(mats), inner=3)
    js_ms = timed_ms(torch, lambda: jacobi_svd(gmats), inner=3)
    svd_ms = once(lambda: torch.linalg.svd(gmats, full_matrices=False))
    # a Rayleigh-Ritz size: the library call beside the sweep kernel (below
    # the window that use_jacobi_for opens; called directly)
    T = mats[:, :32, :32].contiguous()
    small_lib_ms = timed_ms(torch, lambda: torch.linalg.eigh(T))
    small_kernel_ms = timed_ms(torch, lambda: jacobi_eigh(T))

    def fwd(method, **opts):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ConvergenceWarning)
            return xt.linalg.symeig(A, NEIG, "lowest", method=method, **opts)

    exact_ms = timed_ms(torch, lambda: fwd("exacteig"), inner=3)
    default_ms = once(lambda: fwd(None))
    cheb_ms = once(lambda: fwd("chebfsi", **CHEBFSI_OPTS))
    dav_ms = once(lambda: fwd("davidson", **DAVIDSON_OPTS), reps=2)
    svd_exact_ms = timed_ms(torch, lambda: xt.linalg.svd(G, NEIG, method="exacteig"),
                            inner=3)
    svd_default_ms = once(lambda: xt.linalg.svd(G, NEIG))
    grad_exact_ms = timed_ms(torch, lambda: grad_route("exacteig"), inner=3)
    grad_cheb_ms = once(lambda: grad_route("chebfsi", **cheb_grad_opts))
    exact_busy, exact_top = device_busy_ms(torch, lambda: fwd("exacteig"), top=4,
                                           expect=("jacobi_sweep",))
    cheb_busy, cheb_top = device_busy_ms(
        torch, lambda: fwd("chebfsi", **CHEBFSI_OPTS), top=4)

    rounds = -(-(N2 - 1) // 6) * 6
    sweeps_total, rot_total = float(sk.sum()), float(rk.sum())
    k_bound, k_by = sweep_bound(B2, N2, sk, rk)
    gauge_share = (gauge_ms - copy_ms) * (sweeps_total / B2 + 1) / k_ms

    def rate(ms):
        return B2 / ms * 1e3

    print("timing, config 2 [%s], CUDA events after warm-up (median):" % card)
    print("  jacobi_sweep kernel %.3f ms (cluster of %d CTAs a matrix), plain %.3f ms, "
          "bound %.4f ms (%s), torch.linalg.eigh of the same panel %.3f ms; mean sweeps "
          "per matrix %.2f, rotations applied %.0f of %.0f pair visits (B=%d, n=%d) [%s]"
          % (k_ms, cluster, plain_ms, k_bound, k_by, lib_eigh_panel_ms,
             sweeps_total / B2, rot_total, sweeps_total * rounds * (N2 // 2), B2, N2, card))
    print("  the tiled gauge alone (max_sweeps=0, its diagonal tiles refresh the norms; "
          "panel copy of %.3f ms taken off) %.3f ms a time: %.0f%% of the kernel's time "
          "[%s]" % (copy_ms, gauge_ms - copy_ms, 100 * gauge_share, card))
    print("  jacobi_eigh %.3f ms vs torch.linalg.eigh (of the panel, above: same shape) "
          "%.3f ms; jacobi_svd %.3f ms vs torch.linalg.svd %.3f ms (%d x %d x %d) [%s]"
          % (je_ms, lib_eigh_panel_ms, js_ms, svd_ms, B2, N2, N2, card))
    print("  at a Rayleigh-Ritz size (64 x 32 x 32): torch.linalg.eigh %.3f ms vs "
          "jacobi_eigh (the sweep kernel) %.3f ms [%s]"
          % (small_lib_ms, small_kernel_ms, card))
    print("  symeig decomps/s: exacteig %.1f (%.3f ms), default %.1f (%.3f ms), chebfsi "
          "%.1f (%.3f ms), davidson %.1f (%.3f ms) [%s]"
          % (rate(exact_ms), exact_ms, rate(default_ms), default_ms, rate(cheb_ms),
             cheb_ms, rate(dav_ms), dav_ms, card))
    print("  svd decomps/s: exacteig route %.1f (%.3f ms), default routing %.1f "
          "(%.3f ms) [%s]" % (rate(svd_exact_ms), svd_exact_ms, rate(svd_default_ms),
                              svd_default_ms, card))
    print("  symeig grads/s (forward + backward to the dense A): exacteig route %.1f "
          "(%.3f ms), chebfsi route %.1f (%.3f ms) [%s]"
          % (rate(grad_exact_ms), grad_exact_ms, rate(grad_cheb_ms), grad_cheb_ms, card))
    print("  exacteig forward: device busy %.3f ms per call (torch.profiler), idle "
          "share %.0f%% [%s]"
          % (exact_busy, 100 * max(0.0, 1 - exact_busy / exact_ms), card))
    print("    of which: " + "; ".join("%s %.3f ms" % (name[:60], ms)
                                         for name, ms in exact_top))
    print("  chebfsi forward: device busy %.3f ms per call, idle share %.0f%% [%s]"
          % (cheb_busy, 100 * max(0.0, 1 - cheb_busy / cheb_ms), card))
    print("    of which: " + "; ".join("%s %.3f ms" % (name[:60], ms)
                                         for name, ms in cheb_top))

    record = {"name": "jacobi_sweep", "path": "config 2: %d x %d^2, with the warm, per-level "
              "warm and Kron paths' launches" % (B2, N2), "route": "cuda",
              "source": "xitorch_tpu_torch/csrc/jacobi_sweep.cu",
              "replaces": "xitorch_tpu/ops/jacobi_eigh.py:308",
              "launches": sum(counts.values()), "max_abs_err": sq_err,
              "ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound, "bound_by": k_by,
              "library_ms": lib_eigh_panel_ms}
    shared = {"mats": mats, "mats_np": mats_np, "panel": panel, "tol": tol,
              "cold_kernel_ms": k_ms, "rng": rng}
    return record, shared


def routing_outside_window(torch, np, xt, device, card):
    """The measurement behind ``_auto_symeig_method``'s gate outside the
    sweep kernels' window: ``method=None``, ``"exacteig"`` (there
    ``torch.linalg.eigh``) and ``"chebfsi"`` once each at 8 x 1536 x 1536
    float32 SPD (config 2's recipe), neig = 8."""
    import warnings

    from xitorch_tpu_torch.linalg.symeig import _auto_symeig_method
    from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning

    Bo, No = ROUTE_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED)
    a = torch.randn((Bo, No, No), generator=gen, device=device) / math.sqrt(No)
    mats = a @ a.mT + 2.0 * torch.eye(No, device=device)
    A = xt.LinearOperator.m(mats, is_hermitian=True)
    e0 = torch.linalg.eigvalsh(mats.double())
    route = _auto_symeig_method(A, NEIG, None)
    times, errs, notes = {}, {}, {}
    for method in (None, "exacteig", "chebfsi"):
        opts = {"min_eps": None} if method == "chebfsi" else {}

        def run():
            return xt.linalg.symeig(A, NEIG, "lowest", method=method,
                                    return_info=True, **opts)

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ev, _, info = run()
            times[method] = timed_ms(torch, run, reps=1, inner=1)
        errs[method] = float(((ev.double() - e0[:, :NEIG]).abs()
                              / e0[:, -1:]).max())
        notes[method] = "converged %.0f after %.0f" % (float(info["converged"]),
                                                       float(info["iterations"]))
        check(all(issubclass(w.category, ConvergenceWarning) for w in caught),
              "routing outside the window: another warning than non-convergence")
        # the scale-aware residual target bounds the value error
        check(errs[method] <= 1e-3, "routing outside the window: %s evals off by %.3e"
              % (method, errs[method]))
    faster = "chebfsi" if times["chebfsi"] < times["exacteig"] else "exacteig"
    print("default routing outside the window (%d x %d x %d float32 SPD, neig %d): "
          "method=None (-> %s) %.3f ms, exacteig (torch.linalg.eigh) %.3f ms [%s; evals "
          "rel err %.2e], chebfsi %.3f ms [%s; %.2e]; faster here: %s; the gate %s [%s]"
          % (Bo, No, No, NEIG, route, times[None], times["exacteig"], notes["exacteig"],
             errs["exacteig"], times["chebfsi"], notes["chebfsi"], errs["chebfsi"],
             faster, "agrees" if faster == route else "DISAGREES", card))


def dc_level_by_level(torch, a, levels, min_seg, refine=0, per_level=False):
    """Hold the DC kernel against its plain version one level at a time, from
    the kernel's own state, on the (B, n, n) float32 CUDA batch ``a``; with
    ``per_level`` the per-level kernel (``dc_level_cuda``, one launch a
    level) against ``dc_level_plain`` in float32 and in float64, both with
    the kernel's products in IEEE arithmetic, so that the float64 run's
    distance measures accumulation rounding and its amplification.

    The sort is chaotic over its levels: a level whose projector is soft, or
    whose probe block has a tiny singular value, amplifies rounding (on
    config 2's batch the plain version's float32 and float64 runs of one
    level from one state differ by up to 7e-2 of the largest entry), so two
    free runs of 8 levels differ by O(1) on some matrices and cannot be
    compared entry by entry.  One level from the same state can.  For
    ``level = 1 .. levels`` the kernel runs ``level`` levels from the input
    (its output after ``level - 1`` levels is the state; the per-level
    kernel runs the one level from that state), and the plain
    version runs that one level from the kernel's state, in float32 and in
    float64.  Checked for every matrix and level, frozen segments and deep
    bookkeeping included:

    * the segment ids after the level are equal;
    * ``G0`` and ``T`` agree entrywise to ``DC_LEVEL_TOL`` of their largest
      entry, or, where the level amplifies rounding, to ``DC_LEVEL_F64``
      times the distance of the float32 plain version from its own float64
      run (the measure of that amplification);
    * the kernel's level loses the G-invariant ``G0^T G0 = A^2`` (a rank
      failure of the slot split, which the guard of the warm start catches)
      only where the plain version's level from the same state loses it.

    Returns the kernel's full-depth ``(g, t, seg)``, the largest absolute
    ``|G0_kernel - G0_plain|`` over the levels, and the printed summary's
    rows."""
    from xitorch_tpu_torch.ops.dc_kernel import dc_precondition_cuda, dc_precondition_plain
    from xitorch_tpu_torch.ops.dc_level import dc_level_cuda, dc_level_plain
    from xitorch_tpu_torch.ops.spectral_dc import default_probe

    n = a.shape[-1]
    om64 = default_probe(n, torch.float32, a.device).double()
    a64 = a.double()
    a2 = a64 @ a64
    a2norm = torch.linalg.norm(a2, dim=(-2, -1))
    kw = dict(min_seg=min_seg, refine=refine, return_t=True, return_seg=True)

    def rel(x, y, ref):
        return ((x.double() - y.double()).abs().amax(dim=(-2, -1))
                / ref.abs().amax(dim=(-2, -1)).double())

    def inv(g):
        g = g.double()
        return torch.linalg.norm(g.mT @ g - a2, dim=(-2, -1)) / a2norm

    g_prev, state, rows, max_abs = a, None, [], 0.0
    for level in range(1, levels + 1):
        if per_level:
            # one launch is one level: the kernel runs from its own state
            t_prev, s_prev = state if state is not None else (
                0.5 * (a + a.mT), torch.zeros_like(a[..., :1], dtype=torch.int32))
            sk, tk, gk = dc_level_cuda(s_prev, t_prev, g_prev, min_seg=min_seg)
            sp, tp, gp = dc_level_plain(s_prev, t_prev, g_prev, min_seg=min_seg)
            _, t6, g6 = dc_level_plain(s_prev, t_prev.double(), g_prev.double(), om=om64,
                                       min_seg=min_seg)
        else:
            gk, tk, sk = dc_precondition_cuda(a, levels=level, **kw)
            gp, tp, sp = dc_precondition_plain(g_prev, levels=1, state=state, **kw)
            state64 = None if state is None else (state[0].double(), state[1])
            g6, t6, _ = dc_precondition_plain(g_prev.double(), levels=1, state=state64,
                                              om=om64, **kw)
        check(bool(torch.isfinite(gk).all()) and bool(torch.isfinite(tk).all()),
              "dc kernel returned non-finite values at level %d" % level)
        dg, dg64 = rel(gk, gp, gk), rel(gp, g6, gk)
        dt, dt64 = rel(tk, tp, tk), rel(tp, t6, tk)
        inv_k, inv_p = inv(gk), inv(gp)
        seg_differ = int((sk != sp).sum())
        amplified = (dg > DC_LEVEL_TOL) | (dt > DC_LEVEL_TOL)
        sizes = (sk == sk.mT).sum(-1)
        rows.append("  level %d (segments of %d..%d): |G0_k - G0_p| / max|G0| median %.1e, "
                    "max %.1e; T %.1e, %.1e; plain float32 against its float64 run: G0 max "
                    "%.1e, T max %.1e; above %.0e: %d of %d matrices; segment ids differ at "
                    "%d positions; G-invariant worst kernel %.1e, plain %.1e"
                    % (level, int(sizes.min()), int(sizes.max()), float(dg.median()),
                       float(dg.max()), float(dt.median()), float(dt.max()),
                       float(dg64.max()), float(dt64.max()), DC_LEVEL_TOL,
                       int(amplified.sum()), a.shape[0], seg_differ, float(inv_k.max()),
                       float(inv_p.max())))
        check(seg_differ == 0, "dc: segment ids differ from the plain version's at %d "
              "positions after level %d" % (seg_differ, level))
        for what, d, d64 in (("G0", dg, dg64), ("T", dt, dt64)):
            ok = d <= torch.clamp(DC_LEVEL_F64 * d64, min=DC_LEVEL_TOL)
            check(bool(ok.all()), "dc: %s of the kernel and of the plain version differ "
                  "after level %d: %s (plain against its float64 run: %s)"
                  % (what, level, d[~ok].tolist(), d64[~ok].tolist()))
        ok = inv_k <= 1.5 * inv_p + 1e-6
        check(bool(ok.all()), "dc: the kernel's level %d loses the G-invariant where the "
              "plain version's does not: %s against %s"
              % (level, inv_k[~ok].tolist(), inv_p[~ok].tolist()))
        max_abs = max(max_abs, float((gk - gp).abs().max()))
        g_prev, state = gk, (tk, sk)
    return (gk, tk, sk), max_abs, rows


def config2_warm(torch, np, xt, device, card, shared):
    """Config 2 with the spectral divide-and-conquer warm start: the DC
    kernel against its plain version on the panel ``jacobi_eigh`` hands it,
    then the warm route against the cold one through ``jacobi_eigh`` and
    ``linalg.symeig``.  Returns the kernel's record for the JSON line and
    the sweep kernel's launches on the warm paths."""
    from xitorch_tpu_torch.ops import jacobi_eigh as jmod
    from xitorch_tpu_torch.ops.dc_kernel import (
        _PRODUCTS_PER_LEVEL, _TILE, dc_precondition_cuda, dc_precondition_plain,
    )
    from xitorch_tpu_torch.ops.jacobi_eigh import jacobi_eigh, jacobi_sweep_cuda
    from xitorch_tpu_torch.ops.spectral_dc import default_probe

    mats, mats_np, panel = shared["mats"], shared["mats_np"], shared["panel"]
    levels = max(3, math.ceil(math.log2(N2)))
    kw = dict(levels=levels, min_seg=2, return_t=True, return_seg=True)

    # ---- kernel vs plain ----
    # entry by entry, one level at a time from the kernel's own state
    (gk, tk, segk), dc_abs, rows = dc_level_by_level(torch, panel, levels, 2)
    # and the two free runs of all the levels: once in some tens of matrices
    # of this recipe the rounded rank of a soft projector is wrong and the
    # block loses rank (in float64 too; that is what the guard of the warm
    # start is for), and which matrices those are depends on the last bit of
    # the levels before.  Held here: the kernel loses at most one panel more
    # than the plain version, and its healthy panels concentrate and export
    # T as the plain version's do.  A lost panel has a rank-deficient Q and
    # none of these invariants; the level-by-level check above holds the
    # kernel's step on it to the plain version's.
    gp, tp, segp = dc_precondition_plain(panel, **kw)
    torch.cuda.synchronize()
    gmax = float(gp.abs().max())
    dc_free = float((gk - gp).abs().max())
    a64 = panel.double()
    a2 = a64 @ a64
    a2norm = torch.linalg.norm(a2, dim=(-2, -1))
    lam_a = torch.linalg.eigvalsh(a64)
    scale = lam_a.abs().amax(-1)
    stats = []
    for g, t in ((gk, tk), (gp, tp)):
        g, t = g.double(), t.double()
        inv = torch.linalg.norm(g.mT @ g - a2, dim=(-2, -1)) / a2norm
        healthy = inv <= 1e-4
        gg = g @ g.mT
        off = gg - torch.diag_embed(torch.diagonal(gg, dim1=-2, dim2=-1))
        off2 = a2 - torch.diag_embed(torch.diagonal(a2, dim1=-2, dim2=-1))
        conc = torch.linalg.norm(off, dim=(-2, -1)) / torch.linalg.norm(off2, dim=(-2, -1))
        tsym = (t - t.mT).abs().amax(dim=(-2, -1))
        tspec = (torch.linalg.eigvalsh((t + t.mT) / 2) - lam_a).abs().amax(-1) / scale
        tt = (gg - t @ t).abs().amax(dim=(-2, -1)) / scale ** 2
        stats.append({
            "median": float(inv.median()), "healthy": int(healthy.sum()),
            "lost": torch.nonzero(~healthy).flatten().tolist(),
            "worst_healthy": float(inv[healthy].max()), "worst": float(inv.max()),
            "conc": float(conc[healthy].max()), "conc_all": float(conc.max()),
            "tsym": float(tsym.max()), "tspec": float(tspec[healthy].max()),
            "tt": float(tt[healthy].max())})
    n_seg_diff = int((segk != segp).sum())
    k_st, p_st = stats
    print("dc kernel vs plain (%d, %d, %d), min_seg 2, level by level from the kernel's "
          "own state:" % (B2, N2, N2))
    print("\n".join(rows))
    print("dc kernel vs plain, free runs of %d levels: max |G0_k - G0_p| %.2e (max |G0| "
          "%.2f; chaotic, not held), segment ids differ at %d of %d positions"
          % (levels, dc_free, gmax, n_seg_diff, segk.numel()))
    for name, st in (("kernel", k_st), ("plain", p_st)):
        print("  %s: |G0^T G0 - A^2|/|A^2| per matrix median %.2e, healthy (<= 1e-4) %d "
              "of %d with worst %.2e (lost: matrices %s, worst %.2e); off-diagonal mass of "
              "G0 G0^T over A^2's <= %.3f over the healthy (%.3f over all), T asymmetry "
              "%.1e over all; over the healthy: T spectrum rel %.1e, |G0 G0^T - T^2| rel %.1e"
              % (name, st["median"], st["healthy"], B2, st["worst_healthy"], st["lost"],
                 st["worst"], st["conc"], st["conc_all"], st["tsym"], st["tspec"],
                 st["tt"]))
    for name, st in (("kernel", k_st), ("plain", p_st)):
        # the reference's gates (tests/test_spectral_dc.py: 1e-4 and 0.25); a
        # healthy panel sits at ~1e-6, the T invariants at ~5e-6
        check(st["median"] <= 1e-5, "dc %s: the median panel is unhealthy" % name)
        check(st["conc"] < 0.25, "dc %s: a panel does not concentrate" % name)
        check(st["tsym"] < 1e-5 and st["tspec"] < 2e-5 and st["tt"] < 2e-5,
              "dc %s: T export invariants broken" % name)
    check(k_st["conc"] <= 1.5 * p_st["conc"],
          "dc: the kernel's panels concentrate less than the plain version's: %.3f "
          "against %.3f" % (k_st["conc"], p_st["conc"]))
    check(k_st["healthy"] >= p_st["healthy"] - 1,
          "dc: the kernel loses more panels than the plain version: %d of %d (plain %d)"
          % (B2 - k_st["healthy"], B2, B2 - p_st["healthy"]))

    # ---- the main path: warm against cold ----
    e_all = np.linalg.eigvalsh(mats_np)
    scale_np = np.abs(e_all).max(-1, keepdims=True)
    anorm = np.linalg.norm(mats_np, axis=(1, 2))[:, None]

    def quality(lam, V, k=None):
        lam = lam.double().cpu().numpy()
        V = V.double().cpu().numpy()
        ref = e_all if k is None else e_all[:, :k]
        err = float(np.max(np.abs(lam - ref) / scale_np))
        colres = float((np.linalg.norm(mats_np @ V - V * lam[:, None, :], axis=1)
                        / anorm).max())
        orth = float(np.abs(V.transpose(0, 2, 1) @ V - np.eye(V.shape[-1])).max())
        return err, colres, orth

    launches = {"dc": 0, "sweep": 0}

    def driven(fn):
        dc_precondition_cuda.launches = jacobi_sweep_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        check(dc_precondition_cuda.launches >= 1, "warm path: the dc kernel was not launched")
        check(jacobi_sweep_cuda.launches >= 1, "warm path: the sweep kernel was not launched")
        launches["dc"] += dc_precondition_cuda.launches
        launches["sweep"] += jacobi_sweep_cuda.launches
        return out

    lw, Vw, iw = driven(lambda: jacobi_eigh(mats, precondition=True, return_info=True))
    lc, Vc, ic = jacobi_eigh(mats, precondition=False, return_info=True)
    qw, qc = quality(lw, Vw), quality(lc, Vc)
    sw, sc = iw["sweeps"].float(), ic["sweeps"].float()
    n_bad = int(iw["guard_bad"].sum())
    print("config 2 jacobi_eigh warm / cold: evals rel err %.2e / %.2e, residual/|A| "
          "%.2e / %.2e, |X^T X - I|_max %.2e / %.2e; sweeps per matrix warm %d..%d (mean "
          "%.2f), cold %d..%d (mean %.2f); guard fall-backs %d of %d; max |lam_w - lam_c| "
          "%.2e" % (qw[0], qc[0], qw[1], qc[1], qw[2], qc[2], int(sw.min()), int(sw.max()),
                    float(sw.mean()), int(sc.min()), int(sc.max()), float(sc.mean()),
                    n_bad, B2, float((lw - lc).abs().max())))
    for q, name in ((qw, "warm"), (qc, "cold")):
        check(q[0] <= 1e-5 and q[1] < 2e-5 and q[2] < 5e-5,
              "%s jacobi_eigh: outside the gates: %s" % (name, q))
    check(float(sw.mean()) < float(sc.mean()), "the warm start did not save sweeps")
    # what the kernel's panel is for: after the same correction and guard it
    # leaves the sweep as little to do as the plain version's panel
    left = []
    for g0 in (gk, gp):
        g_in, bad = jmod._guard_warm_start(panel, jmod._rot_correct(g0))
        _, s_left = jacobi_sweep_cuda(g_in.contiguous(), 18, shared["tol"])
        left.append((float(s_left.float().mean()), int(bad.sum())))
    print("sweeps left after the warm panel: kernel's %.2f a matrix (guard fall-backs "
          "%d), plain version's %.2f (%d)" % (left[0][0], left[0][1], left[1][0], left[1][1]))
    check(abs(left[0][0] - left[1][0]) <= 0.5,
          "dc: the kernel's panel leaves the sweep more to do than the plain version's")

    A = xt.LinearOperator.m(mats, is_hermitian=True)

    def symeig_forced(warm):
        # exacteig has no options; its dense decomposition is jacobi_eigh
        # with the defaults, so the warm start is forced by standing in for it
        jmod.jacobi_eigh = functools.partial(jacobi_eigh, precondition=warm)
        try:
            return xt.linalg.symeig(A, NEIG, "lowest", method="exacteig")
        finally:
            jmod.jacobi_eigh = jacobi_eigh

    ev, X = driven(lambda: symeig_forced(True))
    qs = quality(ev, X, NEIG)
    print("config 2 symeig exacteig, warm start forced: evals rel err %.2e, residual/|A| "
          "%.2e, |X^T X - I|_max %.2e; dc launches %d, sweep launches %d on the warm paths"
          % (qs[0], qs[1], qs[2], launches["dc"], launches["sweep"]))
    check(qs[0] <= 1e-5 and qs[1] < 2e-5 and qs[2] < 5e-5,
          "warm symeig: outside the gates: %s" % (qs,))

    # ---- timing ----
    # as jacobi_eigh calls it (the default probe, drawn once a size and
    # device), and with the probe given
    dc_kw = dict(levels=levels, min_seg=2)
    om = default_probe(N2, torch.float32, device)
    k_ms = timed_ms(torch, lambda: dc_precondition_cuda(panel, **dc_kw), reps=3, inner=1)
    given_ms = timed_ms(torch, lambda: dc_precondition_cuda(panel, om=om, **dc_kw), reps=3,
                        inner=1)
    plain_ms = timed_ms(torch, lambda: dc_precondition_plain(panel, **dc_kw), reps=3, inner=1)
    by_name = device_ms_by_name(torch, lambda: dc_precondition_cuda(panel, **dc_kw), calls=3)
    prod_ms = sum(ms for nm, ms in by_name.items() if "dc_gemm" in nm)
    pass_ms = sum(by_name.values()) - prod_ms
    n_products = _PRODUCTS_PER_LEVEL * levels
    out = torch.empty_like(panel)

    def products_as_bmm():
        for _ in range(n_products):
            torch.bmm(panel, panel, out=out)

    bmm_ms = timed_ms(torch, products_as_bmm, reps=3, inner=1)
    warm_ms = timed_ms(torch, lambda: jacobi_eigh(mats, precondition=True), reps=3, inner=1)
    cold_ms = timed_ms(torch, lambda: jacobi_eigh(mats, precondition=False), reps=3, inner=3)
    g_in = jmod._guard_warm_start(panel, jmod._rot_correct(gk))[0].contiguous()
    tol = shared["tol"]
    tail_ms = timed_ms(torch, lambda: jmod._guard_warm_start(panel, jmod._rot_correct(gk)),
                       reps=3, inner=3)
    warm_sweep_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(g_in, 18, tol), reps=3, inner=3)
    sym_warm_ms = timed_ms(torch, lambda: symeig_forced(True), reps=3, inner=1)
    sym_cold_ms = timed_ms(torch, lambda: symeig_forced(False), reps=3, inner=3)
    warm_busy, warm_top = device_busy_ms(torch, lambda: symeig_forced(True),
                                         calls=3, top=5)
    cold_busy = device_busy_ms(torch, lambda: symeig_forced(False), calls=3)
    # the operations this run's data needs: a level's sign, probe and polar
    # products (71) act on operands block-diagonal over the segments the
    # level starts from, 2 m^3 a segment of m rows; its tail (T Q, T not
    # masked, Q^T times that, and Q^T G0) 2 m^2 n a product.  Per matrix,
    # summed over rows: 142 sum(m^2) + 6 n sum(m), on the kernel's own
    # segments (its extra launches here are outside the counted runs).  And
    # the operations the kernel's 32-wide tiles run (tile_operations): the
    # band overlap for the 71, the column band for T Q, the row band for the
    # other two
    flops = run_ops = 0.0
    for lv in range(levels):
        s_ = torch.zeros_like(panel[..., :1], dtype=torch.int32) if lv == 0 else \
            dc_precondition_cuda(panel, levels=lv, min_seg=2, return_t=True,
                                 return_seg=True)[2]
        m = (s_ == s_.mT).sum(-1).double()
        flops += float(142.0 * (m * m).sum() + 6.0 * N2 * m.sum())
        diag, rows, cols = tile_operations(torch, s_, _TILE)
        run_ops += (_PRODUCTS_PER_LEVEL - 3) * diag + 2 * rows + cols
    dense = float(B2) * n_products * 2.0 * N2 ** 3
    k_bound, k_by = bound((2 * B2 * N2 * N2 + N2 * N2) * 4, flops)
    print("timing, config 2 warm start [%s], CUDA events after warm-up (median):" % card)
    print("  dc kernel %.3f ms a call as jacobi_eigh calls it (%.3f with the probe given), "
          "plain %.3f ms, bound %.4f ms (%s: %.4f TFLOP on this run's segments, the kernel "
          "at %.1fx its bound, %.1f TFLOP/s of the needed work); its %d products run %.4f "
          "TFLOP on %d-wide tiles (%.1f TFLOP/s), dense they would be %.3f TFLOP; the same "
          "%d dense products as torch.bmm %.3f ms (B=%d, n=%d, %d levels) [%s]"
          % (k_ms, given_ms, plain_ms, k_bound, k_by, flops / 1e12, k_ms / k_bound,
             flops / k_ms / 1e9, n_products, run_ops / 1e12, _TILE,
             run_ops / prod_ms / 1e9, dense / 1e12, n_products, bmm_ms, B2, N2, levels,
             card))
    print("  dc kernel device time by name (profiler): products %.3f ms a call (%d "
          "product kernels), passes and bookkeeping %.3f ms [%s]"
          % (prod_ms, n_products, pass_ms, card))
    print("  jacobi_eigh warm %.3f ms (dc %.3f + correction and guard %.3f + sweeps left "
          "%.3f, mean %.2f a matrix) vs cold %.3f ms (sweep kernel %.3f, mean %.2f) [%s]"
          % (warm_ms, k_ms, tail_ms, warm_sweep_ms, float(sw.mean()), cold_ms,
             shared["cold_kernel_ms"], float(sc.mean()), card))
    print("  symeig exacteig decomps/s: warm %.1f (%.3f ms, device busy %.3f ms, idle "
          "share %.0f%%), cold %.1f (%.3f ms, device busy %.3f ms, idle share %.0f%%) [%s]"
          % (B2 / sym_warm_ms * 1e3, sym_warm_ms, warm_busy,
             100 * max(0.0, 1 - warm_busy / sym_warm_ms), B2 / sym_cold_ms * 1e3,
             sym_cold_ms, cold_busy, 100 * max(0.0, 1 - cold_busy / sym_cold_ms), card))
    print("    warm, of which: " + "; ".join("%s %.3f ms" % (name[:60], ms)
                                               for name, ms in warm_top))
    print("  precondition=None is the cold sweep; faster in this run: %s"
          % ("warm" if warm_ms < cold_ms else "cold"))
    return {"name": "dc_precondition", "route": "cuda",
            "source": "xitorch_tpu_torch/csrc/dc_kernel.cu",
            "replaces": "xitorch_tpu/ops/dc_kernel.py:72",
            "launches": launches["dc"], "max_abs_err": dc_abs,
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": None}, launches["sweep"]


def per_level_warm(torch, np, xt, device, card):
    """The per-level DC kernel (one launch a level) on the path that runs it,
    ``jacobi_eigh(precondition=True)`` past a padded n of 448: 8 SPD
    matrices of 700 x 700 (padded to 768, 10 levels) and of 512 x 512 (9
    levels), config 2's recipe.  At each size: the kernel against
    ``dc_level_plain`` one level at a time from the kernel's own state on
    the panel ``jacobi_eigh`` builds, the G-invariant and concentration of
    the kernel's and the plain version's full-depth panels, warm against
    cold through ``jacobi_eigh`` (quality gates, sweeps a matrix, guard
    fall-backs, the counter at one launch a level) and timings.  Returns the
    kernel's record for the JSON line (times at 768) and the sweep kernel's
    launches on these warm paths."""
    from xitorch_tpu_torch.ops import jacobi_eigh as jmod
    from xitorch_tpu_torch.ops.dc_level import (
        _PRODUCTS_PER_LEVEL, dc_level_cuda, dc_level_plain,
        dc_precondition_per_level,
    )
    from xitorch_tpu_torch.ops.jacobi_eigh import (
        jacobi_eigh, jacobi_sweep_cuda, jacobi_sweep_plain,
    )
    from xitorch_tpu_torch.ops.spectral_dc import default_probe

    bsz = 8
    sweep_launches, record, max_abs = 0, None, 0.0
    for n_user in sorted(WARM_BIG, reverse=True):
        npad = jmod._padded_n(n_user, True)
        levels = max(3, math.ceil(math.log2(npad)))
        gen = torch.Generator(device=device).manual_seed(n_user)
        a = torch.randn((bsz, n_user, n_user), generator=gen, device=device) \
            / math.sqrt(n_user)
        big = a @ a.mT + 2.0 * torch.eye(n_user, device=device)
        panel = jmod._shift_pad(big, npad).contiguous()
        tag = "(%d, %d, %d), padded to %d, %d levels" % (bsz, n_user, n_user, npad, levels)

        # ---- kernel vs plain, one level a launch from the kernel's state ----
        (gk, _, _), d_abs, rows = dc_level_by_level(torch, panel, levels, 2, per_level=True)
        max_abs = max(max_abs, d_abs)
        print("per-level dc kernel vs plain %s, min_seg 2, level by level from the "
              "kernel's own state:" % tag)
        print("\n".join(rows))

        def plain_levels():
            s_, t_, g_ = torch.zeros_like(panel[..., :1], dtype=torch.int32), \
                0.5 * (panel + panel.mT), panel
            for _ in range(levels):
                s_, t_, g_ = dc_level_plain(s_, t_, g_)
            return g_

        gp = plain_levels()

        # the operations this run's data needs.  After level l the operands
        # are block-diagonal over the segments the level starts from, so 71
        # of a level's products need 2 m^3 a segment of m rows and
        # G0 <- Q^T G0 needs 2 m^2 n: per matrix, summed over rows,
        # 142 sum(m^2) + 2 n sum(m), all IEEE float32.  And the operations
        # the kernel's tiles run,
        # from the band ranges (level_tile_operations).
        # The kernel's own segments at each level are counted (its extra
        # launches here precede the counted run); frozen segments, at most 2
        # wide, are counted as live
        s_, t_, g_ = torch.zeros_like(panel[..., :1], dtype=torch.int32), \
            0.5 * (panel + panel.mT), panel
        flops = run_ops = 0.0
        for _ in range(levels):
            m = (s_ == s_.mT).sum(-1).double()
            flops += ((_PRODUCTS_PER_LEVEL - 1) * 2.0 * float((m * m).sum())
                      + 2.0 * npad * float(m.sum()))
            diag, rows = level_tile_operations(torch, s_)
            run_ops += (_PRODUCTS_PER_LEVEL - 1) * diag + rows
            s_, t_, g_ = dc_level_cuda(s_, t_, g_, min_seg=2)
        del s_, t_, g_
        a64 = panel.double()
        a2 = a64 @ a64
        off2 = a2 - torch.diag_embed(torch.diagonal(a2, dim1=-2, dim2=-1))
        stats = []
        for g in (gk, gp):
            g = g.double()
            inv = torch.linalg.norm(g.mT @ g - a2, dim=(-2, -1)) / torch.linalg.norm(
                a2, dim=(-2, -1))
            healthy = inv <= 1e-4
            gg = g @ g.mT
            off = gg - torch.diag_embed(torch.diagonal(gg, dim1=-2, dim2=-1))
            conc = torch.linalg.norm(off, dim=(-2, -1)) / torch.linalg.norm(off2, dim=(-2, -1))
            stats.append({"median": float(inv.median()), "healthy": int(healthy.sum()),
                          "worst": float(inv.max()),
                          "conc": float(conc[healthy].max()) if bool(healthy.any())
                          else float("inf")})
        k_st, p_st = stats
        for name, st in (("kernel", k_st), ("plain", p_st)):
            print("  full depth, %s: |G0^T G0 - A^2|/|A^2| median %.2e, worst %.2e, healthy "
                  "(<= 1e-4) %d of %d; off-diagonal mass of G0 G0^T over A^2's <= %.3f over "
                  "the healthy" % (name, st["median"], st["worst"], st["healthy"], bsz,
                                   st["conc"]))
        # where the warm start's fall-backs come from: the guard on the panel as
        # the sort leaves it, and after the first-order rotational correction
        bad_raw = int(jmod._guard_warm_start(panel, gk)[1].sum())
        bad_cor = int(jmod._guard_warm_start(panel, jmod._rot_correct(gk))[1].sum())
        print("  the guard on the kernel's full-depth panel: %d of %d fall back as the "
              "sort leaves it, %d after the rotational correction" % (bad_raw, bsz, bad_cor))
        # the reference's G-invariant gate (tests/test_spectral_dc.py: 1e-4); its
        # concentration gate (0.3) is for an unpadded matrix: the padding
        # diagonal lies far above the spectrum, so the blend's leak across a
        # split (cos ~ beta) costs off-diagonal mass of the padding's size
        # there, and the kernel is held to the plain version's instead
        check(k_st["median"] <= 1e-4, "per-level dc kernel at %s: the median panel is "
              "unhealthy" % tag)
        check(k_st["conc"] <= 1.5 * p_st["conc"] + 1e-3,
              "per-level dc kernel at %s: its panels concentrate less than the plain "
              "version's: %.3f against %.3f" % (tag, k_st["conc"], p_st["conc"]))
        check(k_st["healthy"] >= p_st["healthy"] - 1,
              "per-level dc kernel at %s: loses more panels than the plain version: %d "
              "(plain %d)" % (tag, bsz - k_st["healthy"], bsz - p_st["healthy"]))

        # ---- the main path: warm against cold through jacobi_eigh ----
        dc_level_cuda.launches = jacobi_sweep_cuda.launches = 0
        lw, Vw, iw = jacobi_eigh(big, precondition=True, return_info=True)
        torch.cuda.synchronize()
        n_lv, n_sw = dc_level_cuda.launches, jacobi_sweep_cuda.launches
        check(n_lv == levels, "warm jacobi_eigh at %s: %d per-level launches, not %d"
              % (tag, n_lv, levels))
        check(n_sw >= 1, "warm jacobi_eigh at %s: the sweep kernel was not launched" % tag)
        if record is None:
            record = {"launches": 0}
        record["launches"] += n_lv
        sweep_launches += n_sw
        lc, Vc, ic = jacobi_eigh(big, precondition=False, return_info=True)
        l0 = torch.linalg.eigvalsh(big.double())
        bnorm = torch.linalg.norm(big.double(), dim=(1, 2))[:, None]
        eye = torch.eye(n_user, device=device)
        qual = []
        for lam, V in ((lw, Vw), (lc, Vc)):
            qual.append((
                float(((lam.double() - l0).abs() / l0[:, -1:]).max()),
                float((torch.linalg.norm((big @ V - V * lam[:, None, :]).double(), dim=1)
                       / bnorm).max()),
                float((V.mT @ V - eye).abs().max())))
        sw, sc = iw["sweeps"].float(), ic["sweeps"].float()
        n_bad = int(iw["guard_bad"].sum())
        print("  jacobi_eigh warm / cold: evals rel err %.2e / %.2e, residual/|A| %.2e / "
              "%.2e, |X^T X - I|_max %.2e / %.2e; sweeps a matrix warm %d..%d (mean %.2f), "
              "cold %d..%d (mean %.2f); guard fall-backs %d of %d; per-level launches %d, "
              "sweep launches %d" % (qual[0][0], qual[1][0], qual[0][1], qual[1][1],
                                     qual[0][2], qual[1][2], int(sw.min()), int(sw.max()),
                                     float(sw.mean()), int(sc.min()), int(sc.max()),
                                     float(sc.mean()), n_bad, bsz, n_lv, n_sw))
        for q, name in zip(qual, ("warm", "cold")):
            check(q[0] <= 1e-5 and q[1] < 2e-5 and q[2] < 5e-5,
                  "%s jacobi_eigh at %s: outside the gates: %s" % (name, tag, q))

        # ---- the sweep kernel against its plain version on the panel of the
        # cold sweep, which the guard also hands it for every fall-back ----
        tol_s = float(torch.finfo(torch.float32).eps) * 4.0 * math.sqrt(n_user)
        Gs, ss, gs, _ = jacobi_sweep_cuda(panel, 18, tol_s, return_stats=True)
        cl = jacobi_sweep_cuda.last_cluster
        Gq, sq = jacobi_sweep_plain(panel, 18, tol_s)
        torch.cuda.synchronize()
        sweep_checks(torch, "jacobi_sweep (%d, %d, %d)" % (bsz, npad, npad), panel, Gs, Gq,
                     ss, sq, gs, tol_s, torch.linalg.eigvalsh(panel.double()), cluster=cl)
        del Gs, Gq
        sweep_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(panel, 18, tol_s), reps=3,
                            inner=1)
        print("  sweep kernel on the cold panel %s [%s]: %.3f ms a call, cluster of %d CTAs "
              "a matrix, sweeps %d..%d" % (tag, card, sweep_ms, cl, int(ss.min()),
                                           int(ss.max())))

        # ---- timing ----
        warm_ms = timed_ms(torch, lambda: jacobi_eigh(big, precondition=True), reps=3,
                           inner=1)
        cold_ms = timed_ms(torch, lambda: jacobi_eigh(big, precondition=False), reps=3,
                           inner=1)
        # the kernel with its probe given, and the call as jacobi_eigh makes it
        # (the default probe, drawn once a size and device)
        om = default_probe(npad, torch.float32, device)
        k_ms = timed_ms(torch, lambda: dc_precondition_per_level(panel, levels=levels, om=om),
                        reps=3, inner=1)
        call_ms = timed_ms(torch, lambda: dc_precondition_per_level(panel, levels=levels),
                           reps=3, inner=1)
        plain_ms = timed_ms(torch, plain_levels, reps=2, inner=1)
        n_products = _PRODUCTS_PER_LEVEL * levels
        out = torch.empty_like(panel)

        def products_as_bmm():
            for _ in range(n_products):
                torch.bmm(panel, panel, out=out)

        bmm_ms = timed_ms(torch, products_as_bmm, reps=2, inner=1)
        dense = float(bsz) * n_products * 2.0 * npad ** 3
        # a read once, the probe read once, G0 written once; the operations
        # in IEEE float32
        nbytes = (2 * bsz * npad * npad + npad * npad) * 4
        k_bound, k_by = bound(nbytes, flops)
        by_name = device_ms_by_name(
            torch, lambda: dc_precondition_per_level(panel, levels=levels, om=om), calls=2)
        prod_ms = sum(ms for nm, ms in by_name.items() if "level_gemm" in nm)
        pass_ms = sum(by_name.values()) - prod_ms
        print("  timing %s [%s], CUDA events after warm-up (median): per-level dc kernel "
              "%.3f ms a call with the probe given, %.3f ms a level (%.3f ms a call as "
              "jacobi_eigh calls it, the default probe drawn once); plain %.3f ms; device "
              "time by name "
              "(profiler): products %.3f ms a call (%.3f a level), passes and "
              "bookkeeping %.3f ms (%.3f a level)"
              % (tag, card, k_ms, k_ms / levels, call_ms, plain_ms, prod_ms,
                 prod_ms / levels, pass_ms, pass_ms / levels))
        print("  operations %s [%s]: needed by this run's segments %.4f TFLOP, run by the "
              "tiles (band ranges) %.4f, all %d products dense %.3f TFLOP, all IEEE "
              "float32; bound %.4f ms (%s; the kernel %.1fx it, %.1f TFLOP/s of the needed "
              "work); the same dense products as torch.bmm %.3f ms"
              % (tag, card, flops / 1e12, run_ops / 1e12, n_products, dense / 1e12,
                 k_bound, k_by, k_ms / k_bound, flops / k_ms / 1e9, bmm_ms))
        print("  jacobi_eigh %s [%s]: warm %.3f ms, cold %.3f ms; faster: %s"
              % (tag, card, warm_ms, cold_ms, "warm" if warm_ms < cold_ms else "cold"))
        if npad == 768:
            busy, top = device_busy_ms(torch, lambda: jacobi_eigh(big, precondition=True),
                                       calls=2, top=5)
            print("  warm jacobi_eigh at %s: device busy %.3f ms a call, idle share %.0f%%; "
                  "of which: %s" % (tag, busy, 100 * max(0.0, 1 - busy / warm_ms),
                                    "; ".join("%s %.3f ms" % (nm[:50], ms) for nm, ms in top)))
            record.update({"ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound,
                           "bound_by": k_by})
    record.update({"name": "dc_level", "route": "cuda",
                   "source": "xitorch_tpu_torch/csrc/dc_level.cu",
                   "replaces": "xitorch_tpu/ops/dc_kernel.py:318",
                   "max_abs_err": max_abs, "library_ms": None})
    return record, sweep_launches


def sweep_gate_table(torch, device, card, batches=None, sizes=None, hold=True):
    """The measurement behind ``use_jacobi_for`` and ``use_jacobi_svd_for``:
    the two sides of ``dense_eigh`` and ``dense_svd`` (the sweep kernels'
    whole functions, ``jacobi_eigh`` cold on float32 SPD and on complex64
    hermitian batches and ``jacobi_svd`` on general float32 and complex64
    ones, against ``library_eigh`` and ``library_svd``, the library calls
    with the Newton step the gate's library side adds) on the same inputs,
    over batches ``GATE_BATCHES`` and sizes ``GATE_SIZES``, CUDA events, one
    timed call a side and cell (every function already ran at smaller
    shapes).  Prints the table and each gate's choice beside it.  With
    ``hold``, a cell that contradicts the gate is timed again (the median of
    five calls after a warm-up, marked ``*``), and the gate is held to the
    faster side wherever one side is ``GATE_CLEAR`` times faster than the
    other; without it the table is only measured (``--gate-sizes``)."""
    from xitorch_tpu_torch.ops import jacobi_eigh as jmod

    batches = GATE_BATCHES if batches is None else batches
    sizes = GATE_SIZES if sizes is None else sizes
    print("sweep-kernel gate [%s]: ms a call, kernel / library (gate: K kernel, L "
          "library; *: timed again, median of 5)" % card)
    print("      n  batch  eigh float32          svd float32           eigh complex64"
          "        svd complex64")
    rows, wrong = [], []
    for n in sizes:
        for bsz in batches:
            gen = torch.Generator(device=device).manual_seed(1000 * n + bsz)

            def draw():
                return torch.randn((bsz, n, n), generator=gen, device=device) / math.sqrt(n)

            a = draw()
            eye = torch.eye(n, device=device)
            spd = a @ a.mT + 2.0 * eye
            z = torch.complex(a, draw()) / math.sqrt(2.0)
            herm = (z @ z.mH + 2.0 * eye).contiguous()
            gmat = draw()
            cgmat = torch.complex(draw(), draw()) / math.sqrt(2.0)
            cases = (
                ("eigh", spd, jmod.jacobi_eigh, jmod.library_eigh, jmod.use_jacobi_for),
                ("svd", gmat, jmod.jacobi_svd, jmod.library_svd, jmod.use_jacobi_svd_for),
                ("complex", herm, jmod.jacobi_eigh, jmod.library_eigh, jmod.use_jacobi_for),
                ("complex_svd", cgmat, jmod.jacobi_svd, jmod.library_svd,
                 jmod.use_jacobi_svd_for))
            row = {"n": n, "batch": bsz}
            cells = []
            for name, x, kern, lib, gate in cases:
                g = bool(gate(x))

                def against_gate(reps):
                    k_ms = timed_ms(torch, lambda: kern(x), reps=reps, inner=1,
                                    warmup=reps > 1)
                    l_ms = timed_ms(torch, lambda: lib(x), reps=reps, inner=1,
                                    warmup=reps > 1)
                    return k_ms, l_ms, hold and ((g and k_ms > GATE_CLEAR * l_ms)
                                                 or (not g and l_ms > GATE_CLEAR * k_ms))

                k_ms, l_ms, against = against_gate(1)
                mark = " "
                if against:
                    # one call can be an outlier: the median of five decides
                    k_ms, l_ms, against = against_gate(5)
                    mark = "*"
                if against:
                    wrong.append((name, n, bsz, k_ms, l_ms, g))
                row[name] = {"kernel_ms": k_ms, "library_ms": l_ms, "gate": "K" if g else "L",
                             "retimed": mark == "*"}
                cells.append("%8.3f / %8.3f %s%s" % (k_ms, l_ms, "K" if g else "L", mark))
            rows.append(row)
            print("  %5d  %5d  %s" % (n, bsz, "  ".join(cells)))
    print(json.dumps({"phase": "sweep_gate", "card": card, "rows": rows}))
    check(not wrong, "the sweep-kernel gate picks the clearly slower side at: %s" % wrong)
    return rows


def config2_rng(np):
    """The generator as config 2's phase leaves it (``config2_batch``'s SPD
    batch, then ``config2``'s general batch, its gradient's rotation and its
    two weights drawn and dropped): ``--only complex`` draws the complex
    batches from the same state as the full run."""
    rng = np.random.default_rng(SEED)
    for shape in ((B2, N2, N2), (B2, N2, N2), (B2, N2, N2), (B2, NEIG), (B2, N2, N2)):
        rng.standard_normal(shape)
    return rng


def complex_waves(torch, B, n, width, cluster):
    """(clusters the card holds at once, waves) of the complex sweep kernel
    for a (B, n, width) panel on clusters of ``cluster`` CTAs (the
    occupancy query); (0, 1) for the device-memory path."""
    from xitorch_tpu_torch.ops import _build
    from xitorch_tpu_torch.ops import jacobi_eigh as jmod

    if not cluster:
        return 0, 1
    lib = _build.load("jacobi_sweep_complex", jmod._SIGNATURES_COMPLEX)
    dev = torch.device("cuda", torch.cuda.current_device())
    held = jmod._active_clusters(lib, dev, n, width, cluster, True)
    return held, -(-B // held)


def config2_complex(torch, np, xt, device, card, shared):
    """Config 2 with complex64 input: the complex sweep kernel against its
    plain version at config 2's panel, the Hestenes rectangle, batch 1, a
    (8, 512, 1024) panel and the forced device-memory path, each with its
    path, cluster size and waves; at each shape the cluster sizes and the
    device-memory path timed on the same panel, the chooser's held to the
    fastest; then hermitian ``symeig`` (default routing), complex ``svd``
    and the gradient through the public API.  Returns the kernel's record
    for the JSON line."""
    import warnings

    from xitorch_tpu_torch.linalg.symeig import _auto_symeig_method
    from xitorch_tpu_torch.ops.jacobi_eigh import (
        jacobi_eigh, jacobi_sweep_cuda, jacobi_sweep_plain,
    )

    rng = shared["rng"]
    c64, f32 = torch.complex64, torch.float32

    def cdev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=c64, device=device)

    # config 2's recipes with complex normals of unit variance
    z = (rng.standard_normal((B2, N2, N2)) + 1j * rng.standard_normal((B2, N2, N2))) \
        / math.sqrt(2 * N2)
    herm = cdev(z @ z.conj().transpose(0, 2, 1) + 2.0 * np.eye(N2))
    herm = (herm + herm.mH) / 2
    gen_c = cdev((rng.standard_normal((B2, N2, N2)) + 1j * rng.standard_normal((B2, N2, N2)))
                 / math.sqrt(2 * N2))
    herm_np = herm.to(torch.complex128).cpu().numpy()
    gen_np = gen_c.to(torch.complex128).cpu().numpy()
    tol = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(N2)
    max_sweeps = 18

    def hermitian_panel(h):
        """The packed panel jacobi_eigh hands the complex kernel, and the
        shifted matrix (the one-sided Gershgorin shift plus 1%)."""
        absa = h.abs()
        diag = torch.diagonal(h, dim1=-2, dim2=-1).real
        lower = (diag - (absa.sum(-1) - diag.abs())).amin(-1)
        sigma = torch.clamp(-lower, min=0.0) + 0.01 * torch.linalg.norm(h, dim=(-2, -1))
        sh = h + sigma[:, None, None] * torch.eye(h.shape[-1], device=device)
        # the panel's rows hold the columns of A: (Re A, -Im A)
        return torch.cat([sh.real, -sh.imag], dim=-1).contiguous(), sh

    def held(name, P, tol_p, spectrum, smem_limit=None):
        """The kernel against plain on the packed panel P, its path and
        waves printed; returns (kernel outputs, cluster, waves)."""
        out = jacobi_sweep_cuda(P, max_sweeps, tol_p, return_stats=True, complexpair=True,
                                smem_limit=smem_limit)
        cl = jacobi_sweep_cuda.last_cluster
        Gp, sp = jacobi_sweep_plain(P, max_sweeps, tol_p, complexpair=True)
        torch.cuda.synchronize()
        at_once, waves = complex_waves(torch, *P.shape, cl)
        err = sweep_checks(torch, "jacobi_sweep_complex %s %s" % (name, tuple(P.shape)), P,
                           out[0], Gp, out[1], sp, out[2], tol_p, spectrum, complexpair=True,
                           cluster=cl)
        if cl:
            print("  (%d clusters held at once: %d wave%s)" % (at_once, waves,
                                                               "s" if waves > 1 else ""))
        return out, cl, waves, err

    # ---- kernel vs plain: config 2's hermitian panel, the rectangle, batch 1,
    # the device-memory path, n = 512 ----
    panel, shifted = hermitian_panel(herm)                                   # (B, n, 2n)
    spectrum = torch.linalg.eigvalsh(shifted.to(torch.complex128))
    (Gk, sk, gk, rk), cl2, waves2, sq_err = held("config 2", panel, tol, spectrum)
    check(cl2 >= 1, "config 2: the complex kernel took the device-memory path, not a "
          "cluster")
    # rows = the first 128 columns of the general batch: Hestenes' complex SVD
    cols = gen_c[:, :, :N2 // 2].mT
    rect = torch.cat([cols.real, cols.imag], dim=-1).contiguous()           # (B, 128, 512)
    tol_r = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(N2 // 2)
    held("rectangle", rect, tol_r, torch.linalg.svdvals(cols.to(torch.complex128)).flip(-1))
    # batch 1, and the forced device-memory path (one block a matrix)
    held("batch 1", panel[:1].contiguous(), tol, spectrum[:1])
    held("device memory", panel[:4].contiguous(), tol, spectrum[:4], smem_limit=0)
    # n = 512: the clusters of 16 CTAs
    gen5 = torch.Generator(device=device).manual_seed(512)
    z5 = torch.complex(torch.randn((8, 512, 512), generator=gen5, device=device),
                       torch.randn((8, 512, 512), generator=gen5, device=device)) \
        / math.sqrt(2 * 512)
    panel5, shifted5 = hermitian_panel(z5 @ z5.mH + 2.0 * torch.eye(512, device=device))
    tol5 = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(512)
    held("n = 512", panel5, tol5, torch.linalg.eigvalsh(shifted5.to(torch.complex128)))

    # ---- the designs at each shape, the device-memory path (one block a matrix)
    # among them: the chooser's is the fastest within the spread of one call
    # to the next ----
    def designs_at(name, P, tol_p, clusters):
        times = {}
        for c in clusters + (0,):
            at_once, waves = complex_waves(torch, *P.shape, c)
            if c and not at_once:
                continue
            ms = timed_ms(torch, lambda: jacobi_sweep_cuda(
                P, max_sweeps, tol_p, complexpair=True, cluster=c or None,
                smem_limit=None if c else 0), reps=3, inner=1)
            times[c] = (ms, at_once, waves)
        jacobi_sweep_cuda(P, max_sweeps, tol_p, complexpair=True)
        chosen = jacobi_sweep_cuda.last_cluster
        print("complex kernel designs, %s %s [%s], CUDA events (median of 3): %s; the "
              "chooser's: %d CTAs" % (name, tuple(P.shape), card, "; ".join(
                  "%s %.3f ms (%s)" % ("%d CTAs" % c if c else "device memory", ms,
                                       "%d clusters at once, %d wave%s"
                                       % (at_once, waves, "s" if waves > 1 else "")
                                       if c else "one block a matrix")
                  for c, (ms, at_once, waves) in times.items()), chosen))
        best = min(ms for ms, _, _ in times.values())
        check(chosen in times and times[chosen][0] <= 1.1 * best,
              "complex kernel at %s: the chooser's cluster of %d CTAs is not the fastest "
              "design (%.3f ms)" % (name, chosen, best))

    designs_at("config 2", panel, tol, (3, 4, 8))
    designs_at("batch 1", panel[:1].contiguous(), tol, (3, 4, 8))
    designs_at("rectangle", rect, tol_r, (2, 3, 4))
    designs_at("n = 512", panel5, tol5, (16,))

    counts = {"fwd": 0, "svd": 0, "grad": 0}

    def driven(key, fn):
        jacobi_sweep_cuda.launches_complex = 0
        out = fn()
        torch.cuda.synchronize()
        counts[key] += jacobi_sweep_cuda.launches_complex
        return out

    # ---- the complex configuration through the public API ----
    A = xt.LinearOperator.m(herm, is_hermitian=True)
    e_all = np.linalg.eigvalsh(herm_np)
    scale = np.abs(e_all).max(-1, keepdims=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ev, X, info = driven("fwd", lambda: xt.linalg.symeig(A, NEIG, "lowest",
                                                             return_info=True))
    route = _auto_symeig_method(A, NEIG, None)
    lam = ev.double().cpu().numpy()
    V = X.to(torch.complex128).cpu().numpy()
    err = float(np.max(np.abs(lam - e_all[:, :NEIG]) / scale))
    colres = float((np.linalg.norm(herm_np @ V - V * lam[:, None, :], axis=1)
                    / np.linalg.norm(herm_np, axis=(1, 2))[:, None]).max())
    orth = float(np.abs(V.conj().transpose(0, 2, 1) @ V - np.eye(NEIG)).max())
    print("complex config symeig (default routing: %s): converged %.0f, evals rel err "
          "%.2e, residual/|A| %.2e, |X^H X - I|_max %.2e, complex sweep launches %d, "
          "warnings: %s" % (route, float(info["converged"]), err, colres, orth,
                            counts["fwd"], [w.category.__name__ for w in caught]))
    check(route == "exacteig" and not caught and float(info["converged"]) == 1.0,
          "complex symeig: the default routing is not the silent dense route")
    check(ev.dtype == f32 and X.dtype == c64 and tuple(X.shape) == (B2, N2, NEIG),
          "complex symeig: bad types or shapes")
    # the reference's complex64 gate (tests/test_jacobi_eigh.py): 3e-5
    check(err <= 3e-5 and colres < 3e-5 and orth < 5e-5,
          "complex symeig: outside the gates")
    check(counts["fwd"] >= 1, "complex symeig: the complex kernel was not launched")

    G = xt.LinearOperator.m(gen_c, is_hermitian=False)
    s0 = np.linalg.svd(gen_np, compute_uv=False)[:, :NEIG][:, ::-1]
    u, sv, vh = driven("svd", lambda: xt.linalg.svd(G, NEIG))
    serr = float(np.max(np.abs(sv.double().cpu().numpy() - s0) / s0[:, -1:]))
    rec = float((gen_c @ vh.mH - u * sv[..., None, :]).abs().max())
    print("complex config svd: top-%d singular values rel err %.2e, |A V - U S|_max %.2e, "
          "complex sweep launches %d" % (NEIG, serr, rec, counts["svd"]))
    check(tuple(u.shape) == (B2, N2, NEIG) and tuple(vh.shape) == (B2, NEIG, N2),
          "complex svd: bad shapes")
    check(serr <= 3e-5 and rec <= 1e-4, "complex svd: outside the gates")
    check(counts["svd"] >= 1, "complex svd: the complex kernel was not launched")

    # ---- gradient of a phase-invariant loss, gap-controlled spectrum ----
    lamg = np.concatenate([np.linspace(0.2, 1.6, NEIG), np.linspace(2.0, 6.0, N2 - NEIG)])
    q = np.linalg.qr(rng.standard_normal((B2, N2, N2))
                     + 1j * rng.standard_normal((B2, N2, N2)))[0]
    gap = cdev((q * lamg) @ q.conj().transpose(0, 2, 1))
    w_e = torch.as_tensor(rng.standard_normal((B2, NEIG)), dtype=f32, device=device)
    w_p = torch.as_tensor(rng.standard_normal((B2, N2, N2)), dtype=f32, device=device)

    def loss_of(evals, Xv):
        # eigenvalues and the projector X X^H: invariant under the phases of
        # the eigenvectors and under rotations inside a degenerate cluster
        return (evals * w_e.to(evals.dtype)).sum() \
            + ((Xv @ Xv.mH).real * w_p.to(evals.dtype)).sum()

    def grad_route():
        re = gap.real.detach().clone().requires_grad_()
        im = gap.imag.detach().clone().requires_grad_()
        x = torch.complex(re, im)
        Ag = xt.LinearOperator.m((x + x.mH) / 2, is_hermitian=True)
        e, Xv = xt.linalg.symeig(Ag, NEIG, "lowest")
        return torch.autograd.grad(loss_of(e, Xv), (re, im))

    g_re, g_im = driven("grad", grad_route)
    re64 = gap.real.double().requires_grad_()
    im64 = gap.imag.double().requires_grad_()
    x64 = torch.complex(re64, im64)
    e64, X64 = torch.linalg.eigh((x64 + x64.mH) / 2)
    r_re, r_im = torch.autograd.grad(loss_of(e64[:, :NEIG], X64[:, :, :NEIG]), (re64, im64))
    rels = [float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
            for a, b in ((g_re, r_re), (g_im, r_im))]
    print("complex config gradient to Re A and Im A: rel L2 vs complex128 "
          "torch.linalg.eigh autograd %.2e / %.2e, complex sweep launches %d"
          % (rels[0], rels[1], counts["grad"]))
    check(bool(torch.isfinite(g_re).all()) and bool(torch.isfinite(g_im).all()),
          "complex gradient: non-finite values")
    # float32 eigenvectors at gaps of 0.2, as for the real gradient
    check(max(rels) <= 5e-3, "complex gradient disagrees with complex128 eigh")
    check(counts["grad"] >= 1, "complex gradient: the complex kernel was not launched")

    # ---- timing ----
    k_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(panel, max_sweeps, tol,
                                                     complexpair=True), reps=3, inner=3)
    # the plain sweep (seconds a call) already ran on this panel above
    plain_ms = timed_ms(torch, lambda: jacobi_sweep_plain(panel, max_sweeps, tol,
                                                          complexpair=True), reps=1, inner=1,
                        warmup=False)
    lib_ms = timed_ms(torch, lambda: torch.linalg.eigh(shifted), reps=2, inner=1)
    je_ms = timed_ms(torch, lambda: jacobi_eigh(herm), reps=3, inner=3)
    sym_ms = timed_ms(torch, lambda: xt.linalg.symeig(A, NEIG, "lowest"), reps=3, inner=3)
    svd_ms = timed_ms(torch, lambda: xt.linalg.svd(G, NEIG), reps=3, inner=3)
    svd_lib_ms = timed_ms(torch, lambda: torch.linalg.svd(gen_c, full_matrices=False),
                          reps=2, inner=1)
    grad_ms = timed_ms(torch, grad_route, reps=3, inner=3)
    sym_busy = device_busy_ms(torch, lambda: xt.linalg.symeig(A, NEIG, "lowest"), calls=3)
    # the bound on this run's data: the packed panel read once and written
    # once; per pair visit the two reductions (4 W operations, W = 2 n the
    # packed width), per applied rotation the phase and the rotation on both
    # planes (11 W), and one hermitian gauge (upper triangle, 4 W a pair) and
    # norm refresh (2 W a row) before the first sweep and after each
    W = 2 * N2
    rounds = -(-(N2 - 1) // 6) * 6
    sweeps_total, rot_total = float(sk.sum()), float(rk.sum())
    flops = (sweeps_total * rounds * (N2 // 2) * 4 * W + rot_total * 11 * W
             + (sweeps_total + B2) * ((N2 * (N2 - 1) // 2) * 4 * W + N2 * 2 * W))
    k_bound, k_by = bound(2 * B2 * N2 * W * 4, flops)
    print("timing, complex config [%s], CUDA events after warm-up (median):" % card)
    print("  jacobi_sweep_complex kernel %.3f ms, plain %.3f ms, bound %.4f ms (%s), "
          "torch.linalg.eigh of the same complex64 batch %.3f ms; mean sweeps per matrix "
          "%.2f, rotations applied %.0f of %.0f pair visits (B=%d, n=%d, packed width %d) "
          "[%s]" % (k_ms, plain_ms, k_bound, k_by, lib_ms, sweeps_total / B2, rot_total,
                    sweeps_total * rounds * (N2 // 2), B2, N2, W, card))
    print("  jacobi_eigh (complex64) %.3f ms; symeig default %.1f decomps/s (%.3f ms, "
          "device busy %.3f ms, idle share %.0f%%); svd %.1f decomps/s (%.3f ms) vs "
          "torch.linalg.svd %.3f ms; gradient %.1f grads/s (%.3f ms) [%s]"
          % (je_ms, B2 / sym_ms * 1e3, sym_ms, sym_busy,
             100 * max(0.0, 1 - sym_busy / sym_ms), B2 / svd_ms * 1e3, svd_ms, svd_lib_ms,
             B2 / grad_ms * 1e3, grad_ms, card))
    return {"name": "jacobi_sweep_complex", "route": "cuda",
            "source": "xitorch_tpu_torch/csrc/jacobi_sweep_complex.cu",
            "replaces": "xitorch_tpu/ops/jacobi_eigh.py:420",
            "launches": sum(counts.values()), "max_abs_err": sq_err,
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": lib_ms}


def grid_matrix(xt, n, is_hermitian, lo, hi, dtype, device):
    """The upstream benchmark's matrix factory: eigenvalues
    ``linspace(lo, hi, n)`` pushed out to ``|.| >= GRID_MINABS``, under a
    random orthogonal (hermitian) or column-normalised general similarity,
    drawn from GRID_SEED (the port's ``create_random_square_matrix``)."""
    return xt.utils.create_random_square_matrix(n, is_hermitian, lo, hi, GRID_MINABS,
                                                 GRID_SEED, dtype=dtype, device=device)


def dense_batch(torch, np, device, lo=DENSE_RANGE[0]):
    """The batched dense point: 64 hermitian matrices of the benchmark's
    recipe (eigenvalues ``linspace(0.2, 1, 700)``, or from ``lo``), the
    normals drawn with numpy and the float64 QR and products done on the
    card, then cast."""
    rng = np.random.default_rng(GRID_SEED)
    g = torch.as_tensor(rng.standard_normal((DENSE_BATCH, DENSE_N, DENSE_N)), device=device)
    q = torch.linalg.qr(g)[0]
    ev = torch.linspace(lo, DENSE_RANGE[1], DENSE_N, dtype=torch.float64, device=device)
    mats = (q * ev) @ q.mT
    mats = ((mats + mats.mT) * 0.5).float().contiguous()
    B = torch.as_tensor(rng.standard_normal((DENSE_BATCH, DENSE_N, GRID_NCOLS)),
                        dtype=torch.float32, device=device)
    w = torch.as_tensor(rng.standard_normal((DENSE_BATCH, DENSE_N, GRID_NCOLS)),
                        dtype=torch.float32, device=device)
    return mats, B, w


def resid_over_stop(torch, A, x, B, rtol=GRID_RTOL, atol=GRID_ATOL):
    """Largest measured ``|A x - b| / max(rtol |b|, atol)`` over the columns,
    in float64."""
    A, x, B = A.double(), x.double(), B.double()
    r = torch.linalg.norm(A @ x - B, dim=-2)
    stop = torch.clamp(rtol * torch.linalg.norm(B, dim=-2), min=atol)
    return float((r / stop).max())


def design_text(d, waves):
    if not d.cluster:
        return "the device-memory path: blocks of %d columns" % d.cols
    return ("clusters of %d CTAs, up to %d columns a CTA, stop groups of %d columns, %d "
            "column groups x %d halves of k (bands of %d rows), %d stages, r and x %s, %d "
            "wave(s)" % (d.cluster, d.cols, d.group, d.cgroups, d.khalves,
                         64 // (d.cgroups * d.khalves), d.stages,
               "on chip" if d.rx else "in the scratch", waves))


def fused_cg_flops(d, it, nc, n):
    """2 n^2 operations a column and step, for the steps each stop group
    took (every column of a group runs its group's steps)."""
    widths = [sum(g) for g in d.cta_columns(nc)]
    return sum(float(it[:, j].sum()) * w for j, w in enumerate(widths)) * 2.0 * n * n


def fused_cg_kernel_phase(torch, np, xt, device, card):
    """The fused dense CG kernel against its plain version (the same stop
    groups: the reference's joint rule where one cluster holds a system's
    columns) at the batched point and at every point of the grid that path
    A sends through it, each with its design; the device-memory path
    (forced, the design the cluster path replaced) timed in turns with the chosen one at the
    batched point and at a grid point; the kernel against Cholesky +
    ``cholesky_solve`` at the batched shape over four eigenvalue ranges; and
    its time beside its bound and the PyTorch calls for the same function
    (``library_ms``: the faster of the two).  Returns the kernel's record and
    the batched point's tensors."""
    from xitorch_tpu_torch.ops.fused_cg import fused_cg_cuda, fused_cg_plain

    mats, B, w = dense_batch(torch, np, device)
    # every shape path A hands the kernel: the batched point, and the grid's
    # hermitian points with lo >= 0 (one matrix a call)
    points = [("batched", mats, B)]
    rng = np.random.default_rng(0)
    for lo, hi in GRID_RANGES:
        for n in GRID_SIZES:
            if lo >= 0:
                one = grid_matrix(xt, n, True, lo, hi, torch.float32, device)[None].contiguous()
                B1 = torch.as_tensor(rng.standard_normal((1, n, GRID_NCOLS)),
                                     dtype=torch.float32, device=device)
                points.append(("grid (%g, %g) n=%d" % (lo, hi, n), one, B1))
    results = {}
    for name, A3, B3 in points:
        nb, n, nc = B3.shape
        kw = dict(rtol=GRID_RTOL, atol=GRID_ATOL, max_niter=int(1.5 * n))
        a_idx = torch.arange(nb, device=device)
        xk, itk = fused_cg_cuda(A3, a_idx, B3, **kw)
        d, waves = fused_cg_cuda.last_design, fused_cg_cuda.last_waves
        xp, itp = fused_cg_plain(A3, B3, group=None if d.group >= nc else d.group, **kw)
        torch.cuda.synchronize()
        rel = float((xk - xp).abs().max() / xp.abs().max())
        dsteps = int((itk - itp).abs().max())
        rk, rp = resid_over_stop(torch, A3, xk, B3), resid_over_stop(torch, A3, xp, B3)
        print("fused_cg kernel vs plain, %s (%d, %d, %d, nc %d), %s: max |x_k - x_p| / max "
              "|x| %.2e, steps %d..%d (max |diff| %d), measured |Ax-b| / max(rtol |b|, atol) "
              "kernel %.3f, plain %.3f"
              % (name, nb, n, n, nc, design_text(d, waves), rel, int(itk.min()),
                 int(itk.max()), dsteps, rk, rp))
        check(bool(torch.isfinite(xk).all()), "fused_cg kernel returned non-finite values")
        # sums in another order (shuffles and warps vs cuBLAS), so the
        # iterates drift apart by a few ulps a step
        check(rel <= 1e-4, "fused_cg kernel disagrees with plain at %s: %.3e" % (name, rel))
        check(dsteps <= 2, "fused_cg step counts differ by %d at %s" % (dsteps, name))
        check(max(rk, rp) <= RESID_DRIFT, "fused_cg measured residual above the stop at %s: "
              "kernel %.3f, plain %.3f" % (name, rk, rp))
        check(d.cluster >= 1, "fused_cg took the device-memory path at %s" % name)
        results[name] = (A3, a_idx, B3, kw, itk, float((xk - xp).abs().max()), d)
    # timed below: the widest range at the middle size
    n_mid = GRID_SIZES[len(GRID_SIZES) // 2]
    results["grid"] = results["grid (0, 1) n=%d" % n_mid]

    A3, a_idx, B3, kw, itk, _, d = results["batched"]
    abs_err = max(r[5] for r in results.values())
    nb, n, nc = B3.shape
    # the chosen design and the device-memory path, in turns
    turns = {"new": [], "dm": []}
    for which in ("new", "dm", "dm", "new"):
        turns[which].append(timed_ms(
            torch, lambda: fused_cg_cuda(A3, a_idx, B3, cluster=0 if which == "dm" else None,
                                         **kw), reps=3, inner=3))
    k_ms, dm_ms = statistics.median(turns["new"]), statistics.median(turns["dm"])
    plain_ms = timed_ms(torch, lambda: fused_cg_plain(A3, B3, **kw), reps=3, inner=1)
    solve_ms = timed_ms(torch, lambda: torch.linalg.solve(A3, B3), reps=3, inner=1)
    chol_ms = timed_ms(torch, lambda: torch.cholesky_solve(B3, torch.linalg.cholesky(A3)),
                       reps=3, inner=1)
    A_op = xt.LinearOperator.m(A3, is_hermitian=True)
    cg_ms = timed_ms(torch, lambda: xt.linalg.solve(A_op, B3, method="cg", rtol=GRID_RTOL,
                                                    atol=GRID_ATOL), reps=3, inner=1)
    g1, a1, b1, kw1 = results["grid"][:4]
    gturns = {"new": [], "dm": []}
    for which in ("new", "dm", "dm", "new"):
        gturns[which].append(timed_ms(
            torch, lambda: fused_cg_cuda(g1, a1, b1, cluster=0 if which == "dm" else None,
                                         **kw1), reps=3, inner=3))
    grid_ms, grid_dm_ms = statistics.median(gturns["new"]), statistics.median(gturns["dm"])
    grid_lib_ms = timed_ms(torch, lambda: torch.linalg.solve(g1, b1), reps=3, inner=3)
    # the grid point on other cluster sizes (the chooser's columns-a-CTA rule)
    grid_sizes = {}
    for c in GRID_CLUSTERS:
        grid_sizes[c] = timed_ms(torch, lambda: fused_cg_cuda(g1, a1, b1, cluster=c, **kw1),
                                 reps=3, inner=3)
        grid_sizes[c] = (grid_sizes[c], fused_cg_cuda.last_design.cols)
    # the bound on this run's data: every matrix and B read once, x written
    # once; 2 n^2 operations a column and step, for the steps each stop
    # group took
    flops = fused_cg_flops(d, itk, nc, n)
    k_bound, k_by = bound((nb * n * n + 2 * nb * n * nc) * 4, flops)
    print("timing, fused dense CG [%s], CUDA events after warm-up (median):" % card)
    print("  fused_cg kernel %.3f ms (%s), the device-memory path %.3f ms, in turns (new %s, "
          "device memory %s); "
          "plain %.3f ms, bound %.4f ms (%s: %.1f GFLOP over the steps taken, %.1f MB); "
          "torch.linalg.solve %.3f ms, torch.linalg.cholesky + cholesky_solve %.3f ms, the "
          "port's cg (Python loop) %.3f ms (%d x %d x %d, nc %d) [%s]"
          % (k_ms, design_text(d, 1), dm_ms, ["%.3f" % t for t in turns["new"]],
             ["%.3f" % t for t in turns["dm"]], plain_ms, k_bound, k_by, flops / 1e9,
             (nb * n * n + 2 * nb * n * nc) * 4 / 1e6, solve_ms, chol_ms, cg_ms, nb, n, n,
             nc, card))
    print("  at the grid point (1 x %d x %d, nc %d, %s): kernel %.3f ms, the device-memory "
          "path %.3f ms, in turns (new %s, device memory %s); torch.linalg.solve %.3f ms; on "
          "clusters of %s "
          "[%s]"
          % (n_mid, n_mid, nc, design_text(results["grid"][6], 1), grid_ms, grid_dm_ms,
             ["%.3f" % t for t in gturns["new"]], ["%.3f" % t for t in gturns["dm"]],
             grid_lib_ms, ", ".join("%d CTAs (%d columns a CTA) %.3f ms" % (c, g, t)
                                     for c, (t, g) in grid_sizes.items()), card))
    check(grid_ms <= 1.05 * grid_dm_ms, "fused_cg: the new design (%.3f ms) is more than 5%% "
          "slower than the device-memory path (%.3f ms) at the grid point"
          % (grid_ms, grid_dm_ms))
    check(k_ms < dm_ms, "fused_cg: the new design (%.3f ms) is not faster than the "
          "device-memory path (%.3f ms) at the batched point" % (k_ms, dm_ms))
    # where the kernel's lead over a direct solve ends: the batched shape
    # over harder eigenvalue ranges (one timed call a side and range)
    ranges = []
    for lo in (0.2, 0.05, 0.01, 0.001):
        Ar, Br = mats, B
        if lo != DENSE_RANGE[0]:
            Ar, Br, _ = dense_batch(torch, np, device, lo=lo)
        xr, itr = fused_cg_cuda(Ar, a_idx, Br, **kw)
        rk = resid_over_stop(torch, Ar, xr, Br)
        kr = timed_ms(torch, lambda: fused_cg_cuda(Ar, a_idx, Br, **kw), reps=1, inner=1)
        cr = timed_ms(torch, lambda: torch.cholesky_solve(Br, torch.linalg.cholesky(Ar)),
                      reps=1, inner=1)
        ranges.append({"range": [lo, 1.0], "kernel_ms": kr, "cholesky_solve_ms": cr,
                       "steps_max": int(itr.max()), "resid_over_stop": rk})
        print("  range (%g, 1): kernel %.3f ms (%d steps, measured residual %.3f of the "
              "stop), Cholesky + cholesky_solve %.3f ms [%s]"
              % (lo, kr, int(itr.max()), rk, cr, card))
        # float32 CG's recurrence residual parts from the measured one as the
        # condition number grows (about eps * kappa); past the main path's
        # range the residual is reported, not held
        check(bool(torch.isfinite(xr).all()), "fused_cg returned non-finite values at range "
              "(%g, 1)" % lo)
    print(json.dumps({"phase": "fused_cg_kernel", "card": card, "shape": [nb, n, n, nc],
                      "design": list(d), "kernel_ms": k_ms, "device_memory_design_ms": dm_ms,
                      "plain_ms": plain_ms, "bound_ms": k_bound, "bound_by": k_by,
                      "linalg_solve_ms": solve_ms, "cholesky_solve_ms": chol_ms,
                      "port_cg_ms": cg_ms, "grid_point_kernel_ms": grid_ms,
                      "grid_point_device_memory_design_ms": grid_dm_ms,
                      "grid_point_linalg_solve_ms": grid_lib_ms,
                      "grid_point_cluster_ms": {str(c): t for c, (t, _) in grid_sizes.items()},
                      "ranges": ranges,
                      "steps_min": int(itk.min()), "steps_max": int(itk.max())}))
    record = {"name": "fused_cg", "route": "cuda",
              "source": "xitorch_tpu_torch/csrc/fused_cg.cu",
              "replaces": "xitorch_tpu/ops/fused_cg.py:38",
              "launches": 0, "max_abs_err": abs_err,
              "ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound, "bound_by": k_by,
              "library_ms": min(solve_ms, chol_ms)}
    return record, (mats, B, w)


def path_a(torch, np, xt, device, card, batched):
    """Dense operators through ``linalg.solve``: the upstream benchmark's
    grid, one matrix a call, and the batched point forward and gradient.
    Returns the fused-CG launches of the path."""
    import warnings

    from xitorch_tpu_torch.linalg.solve import _default_method
    from xitorch_tpu_torch.ops.fused_cg import fused_cg_cuda
    from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning

    class MatVecOnly(xt.LinearOperator):
        """The same matrix without ``_fullmatrix``: a matrix-free operator,
        which the default routing may not send to the dense solve."""

        def __init__(self, mat):
            super().__init__(shape=mat.shape, dtype=mat.dtype, device=mat.device)
            self.mat = mat

        def _getparamnames(self, prefix=""):
            return [prefix + "mat"]

        def _mv(self, x):
            return (self.mat @ x[..., None])[..., 0]

        def _mm(self, x):
            return self.mat @ x

        def _rmm(self, x):
            return self.mat.mT @ x

    opts = dict(rtol=GRID_RTOL, atol=GRID_ATOL)
    launches = 0
    rng = np.random.default_rng(0)
    busy = {}
    rows = []

    def run(A, B, method, mat, **kw):
        """One solve through the public API: time (host clock around a
        synchronised call), info, measured residual, warnings."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if method == "fused_cg":   # reports no info
                x, info = xt.linalg.solve(A, B, method=method, **kw), None
            else:
                x, info = xt.linalg.solve(A, B, method=method, return_info=True, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        warned = [wi for wi in caught if issubclass(wi.category, ConvergenceWarning)]
        rel = resid_over_stop(torch, mat, x, B)
        rcol = torch.linalg.norm(mat.double() @ x.double() - B.double(), dim=-2)
        over_b = float((rcol / torch.linalg.norm(B.double(), dim=-2)).max())
        return {"x": x, "ms": ms, "rel": rel, "resid": float(rcol.max()), "over_b": over_b,
                "warned": bool(warned),
                "iters": None if info is None else int(info["iterations"]),
                "conv": None if info is None else float(info["converged"])}

    def report(tag, n, out, gate, floor=None):
        """``gate``: "converge" (no ConvergenceWarning, converged); "floor"
        (converged, or a residual within FLOOR_MULT times ``floor``, the
        residual that float32 ``torch.linalg.solve`` leaves on the same
        system); "benchmark" (the upstream benchmark's gate: converged, or
        max |Ax-b| < 0.05 n; and every column's residual below |b|, which x = 0
        would not pass: the methods return their best iterate); or "report"
        (finite only: the method's defaults do not cover this point, see the
        caller)."""
        vs_floor = "" if floor is None else ", %.3g x the float32 direct solve's %.2e" % (
            out["resid"] / floor, floor)
        print("  %-44s %9.3f ms, iterations %s, converged %s, |Ax-b|/stop %.3g, max |Ax-b| "
              "%.2e%s%s" % (tag, out["ms"], out["iters"], out["conv"], out["rel"],
                            out["resid"], vs_floor, ", warned" if out["warned"] else ""))
        rows.append({"point": tag, "ms": out["ms"], "iterations": out["iters"],
                     "converged": out["conv"], "resid_over_stop": out["rel"],
                     "max_resid": out["resid"], "direct_solve_resid": floor,
                     "resid_over_b": out["over_b"], "warned": out["warned"], "gate": gate})
        check(bool(torch.isfinite(out["x"]).all()), "%s: non-finite solution" % tag)
        if gate == "converge":
            check(not out["warned"], "%s: ConvergenceWarning" % tag)
            check(out["conv"] in (None, 1.0), "%s: converged = %s" % (tag, out["conv"]))
        elif gate == "floor":
            check(out["conv"] == 1.0 or out["resid"] <= FLOOR_MULT * floor,
                  "%s: not converged, and max |Ax-b| %.3e is %.1f times the float32 direct "
                  "solve's %.3e" % (tag, out["resid"], out["resid"] / floor, floor))
        elif gate == "benchmark":
            check(out["conv"] == 1.0 or out["resid"] < 1e-2 * n * 5.0,
                  "%s: neither converged nor under the gate (max |Ax-b| %.3e)"
                  % (tag, out["resid"]))
            check(out["over_b"] < 1.0, "%s: a column's residual is %.3f of its |b|: no "
                  "better than x = 0" % (tag, out["over_b"]))

    print("path A, the solve benchmark's grid (float32, nc %d, rtol %.0e, atol %.0e, "
          "max_niter 8 n), one call each, host clock [%s]:" % (GRID_NCOLS, GRID_RTOL,
                                                               GRID_ATOL, card))
    for herm in (True, False):
        for lo, hi in GRID_RANGES:
            for n in GRID_SIZES:
                mat = grid_matrix(xt, n, herm, lo, hi, torch.float32, device)
                A = xt.LinearOperator.m(mat, is_hermitian=herm)
                B = torch.as_tensor(rng.standard_normal((n, GRID_NCOLS)),
                                    dtype=torch.float32, device=device)
                kw = dict(opts, max_niter=8 * n)
                tag = "%s (%g, %g) n=%d" % ("herm" if herm else "nonherm", lo, hi, n)
                definite = "converge" if lo >= 0 else "benchmark"
                if herm:
                    if lo >= 0:
                        fused_cg_cuda.launches = 0
                        out = run(A, B, "fused_cg", mat, **kw)
                        check(fused_cg_cuda.launches == 1, "%s: fused_cg launched the "
                              "kernel %d times" % (tag, fused_cg_cuda.launches))
                        launches += fused_cg_cuda.launches
                        report(tag + " fused_cg", n, out, "converge")
                        check(out["rel"] <= RESID_DRIFT, "%s fused_cg: measured residual "
                              "%.3f of the stop" % (tag, out["rel"]))
                    report(tag + " cg", n, run(A, B, "cg", mat, posdef=None, **kw), definite)
                    # cg_ir refines with the operator taken as positive definite
                    # (as in the JAX package): on the indefinite range its best
                    # iterate is reported, not gated
                    report(tag + " cg_ir", n, run(A, B, "cg_ir", mat, posdef=None, **kw),
                           definite if lo >= 0 else "report")
                else:
                    # the non-hermitian matrices are a spectrum under a random
                    # non-orthogonal similarity, whose conditioning floors the
                    # float32 residual above rtol 1e-5.  The floor is measured:
                    # the residual float32 torch.linalg.solve leaves on the same
                    # system.  Where the spectrum is definite (lo >= 0) bicgstab
                    # and gmres must converge or come within FLOOR_MULT of it,
                    # and where lo > 0 their float64 runs must converge without
                    # a warning.  On the indefinite range bicgstab stalls far
                    # above the floor in either precision, which is why the
                    # upstream benchmark has its loose gate: that gate, and a
                    # residual below |b| in every column
                    xf = torch.linalg.solve(mat, B)
                    floor = float(torch.linalg.norm(mat.double() @ xf.double() - B.double(),
                                                    dim=-2).max())
                    gate = "floor" if lo >= 0 else "benchmark"
                    # bicgstab handles indefinite systems directly: no probe
                    report(tag + " bicgstab", n, run(A, B, "bicgstab", mat, posdef=True, **kw),
                           gate, floor)
                    Afree = MatVecOnly(mat)
                    route = _default_method(Afree, None, None)
                    check(route == "bicgstab", "%s: method=None on a matrix-free "
                          "non-hermitian operator routes to %s" % (tag, route))
                    # the default options probe definiteness (posdef=None), and
                    # an indefinite operator then goes through the normal
                    # equations, as in the JAX package: reported, not gated
                    report(tag + " method=None (-> %s)" % route, n,
                           run(Afree, B, None, mat, **kw), gate if lo >= 0 else "report", floor)
                    check(_default_method(A, None, None) == "exactsolve",
                          "%s: an explicit matrix no longer routes to exactsolve" % tag)
                    if n == GRID_SIZES[-1]:
                        report(tag + " gmres(100)", n,
                               run(A, B, "gmres", mat, restart=100, **kw), gate, floor)
                    mat64 = grid_matrix(xt, n, herm, lo, hi, torch.float64, device)
                    A64 = xt.LinearOperator.m(mat64, is_hermitian=False)
                    gate64 = "converge" if lo > 0 else "report"
                    report(tag + " bicgstab, float64", n,
                           run(A64, B.double(), "bicgstab", mat64, posdef=True, **kw), gate64)
                    if n == GRID_SIZES[-1]:
                        report(tag + " gmres(100), float64", n,
                               run(A64, B.double(), "gmres", mat64, restart=100, **kw), gate64)
                if n == GRID_SIZES[-1] and (lo, hi) == DENSE_RANGE:
                    # device idle share at n = 700
                    for method, extra in ((("fused_cg", {}), ("cg", {"posdef": None}))
                                          if herm else (("bicgstab", {"posdef": True}),)):
                        def call():
                            return xt.linalg.solve(A, B, method=method, **extra, **kw)
                        ms = timed_ms(torch, call, reps=3, inner=1)
                        busy[method] = (device_busy_ms(torch, call, calls=3), ms)
    for method, (b_ms, ms) in busy.items():
        print("  %s at n = 700, range (0.2, 1): %.3f ms a call, device busy %.3f ms, idle "
              "share %.0f%% [%s]" % (method, ms, b_ms, 100 * max(0.0, 1 - b_ms / ms), card))

    # ---- the batched point: 64 x (700 x 700), forward and gradient ----
    mats, B, w = batched
    Aop = xt.LinearOperator.m(mats, is_hermitian=True)
    print("path A, the batched point (%d x %d x %d, nc %d, range %s) [%s]:"
          % (DENSE_BATCH, DENSE_N, DENSE_N, GRID_NCOLS, DENSE_RANGE, card))
    a64 = mats.double().requires_grad_()
    b64 = B.double().requires_grad_()
    x64 = torch.linalg.solve((a64 + a64.mT) / 2, b64)
    gA64, gB64 = torch.autograd.grad((x64 * w.double()).sum(), (a64, b64))

    def grads(method, **kw):
        la = mats.detach().clone().requires_grad_()
        lb = B.detach().clone().requires_grad_()
        x = xt.linalg.solve(xt.LinearOperator.m((la + la.mT) / 2, is_hermitian=True), lb,
                            method=method, **opts, **kw)
        return torch.autograd.grad((x * w).sum(), (la, lb))

    def rel_l2(a, b):
        return float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))

    for method, kw in (("fused_cg", {}), ("cg", {"posdef": None}), ("cg_ir", {"posdef": None})):
        fused_cg_cuda.launches = 0
        out = run(Aop, B, method, mats, **opts, **kw)
        n_fwd = fused_cg_cuda.launches
        report("batched %s" % method, DENSE_N, out, "converge")
        xerr = float((out["x"].double() - x64.detach()).abs().max() / x64.detach().abs().max())
        fused_cg_cuda.launches = 0
        gA, gB = grads(method, **kw)
        torch.cuda.synchronize()
        n_grad = fused_cg_cuda.launches
        rA, rB = rel_l2(gA, gA64), rel_l2(gB, gB64)
        fwd_ms = timed_ms(torch, lambda: xt.linalg.solve(Aop, B, method=method, **opts, **kw),
                          reps=3, inner=1)
        grad_ms = timed_ms(torch, lambda: grads(method, **kw), reps=3, inner=1)
        print("    x against the float64 dense solve: max rel %.2e; gradient of (x.w).sum() "
              "rel L2 against float64 torch.linalg.solve autograd: to A %.2e, to B %.2e; "
              "fused_cg launches forward %d, forward + gradient %d; %.1f solves/s "
              "(%.3f ms), %.1f grads/s (%.3f ms) [%s]"
              % (xerr, rA, rB, n_fwd, n_grad, DENSE_BATCH / fwd_ms * 1e3, fwd_ms,
                 DENSE_BATCH / grad_ms * 1e3, grad_ms, card))
        # rtol 1e-5 on the residual times kappa = 5
        check(xerr <= 2e-4, "batched %s: x off the float64 solve by %.3e" % (method, xerr))
        # two float32 solves at rtol 1e-5, kappa = 5
        check(max(rA, rB) <= 1e-3, "batched %s: gradient off float64 by %.3e / %.3e"
              % (method, rA, rB))
        check(bool(torch.isfinite(gA).all()) and bool(torch.isfinite(gB).all()),
              "batched %s: non-finite gradient" % method)
        if method == "fused_cg":
            check(n_fwd == 1, "batched fused_cg: forward launched the kernel %d times"
                  % n_fwd)
            check(n_grad == 2, "batched fused_cg: forward + adjoint launched the kernel "
                  "%d times, not 2" % n_grad)
            launches += n_fwd + n_grad
            fb = device_busy_ms(torch, lambda: xt.linalg.solve(Aop, B, method=method, **opts))
            print("    fused_cg forward: device busy %.3f ms, idle share %.0f%% [%s]"
                  % (fb, 100 * max(0.0, 1 - fb / fwd_ms), card))
            busy["fused_cg, batched"] = (fb, fwd_ms)
        rows[-1].update({"x_rel_err": xerr, "grad_rel_l2": [rA, rB], "forward_ms": fwd_ms,
                         "forward_and_gradient_ms": grad_ms})
    # what the kernel does not take (here: a shift E) is an error on the card,
    # so that naming the method never runs the Python-loop cg unnoticed
    fused_cg_cuda.launches = 0
    try:
        xt.linalg.solve(Aop, B, E=torch.zeros(GRID_NCOLS, device=device), method="fused_cg",
                        **opts)
        refused = False
    except RuntimeError as err:
        refused = "method='cg'" in str(err)
    print("  fused_cg with a shift E on the card: refused %s, kernel launches %d"
          % (refused, fused_cg_cuda.launches))
    check(refused and fused_cg_cuda.launches == 0,
          "fused_cg outside the kernel's window did not raise on the card")
    print(json.dumps({"phase": "path_a", "card": card, "fused_cg_launches": launches,
                      "device_busy_ms_and_call_ms": busy, "points": rows}))
    return launches


def lap1d(torch, n, device, dtype):
    """benchmarks/bench_kron.py's factor: the 1-D Laplacian shifted by 0.05
    (SPD; eigenvalues 2.05 - 2 cos(k pi / (n + 1)))."""
    off = -torch.ones(n - 1, dtype=dtype, device=device)
    return (2.05 * torch.eye(n, dtype=dtype, device=device)
            + torch.diag(off, 1) + torch.diag(off, -1))


def path_b(torch, np, xt, device, card):
    """Kron operators through ``linalg.solve`` and ``linalg.symeig``.
    Returns the real sweep kernel's launches on the path: a factor
    decomposition goes through it where the gate (``use_jacobi_for``, from
    ``sweep_gate_table``'s measurement) says it beats ``torch.linalg.eigh``
    at the factor's batch and size, and through the library elsewhere."""
    import warnings

    from xitorch_tpu_torch.linalg.solve import _default_method
    from xitorch_tpu_torch.ops import jacobi_eigh as jmod
    from xitorch_tpu_torch.ops.jacobi_eigh import (
        jacobi_sweep_cuda, jacobi_sweep_plain, use_jacobi_for,
    )
    from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(1)

    # ---- the sweep kernel against its plain version at the factor shapes,
    # batch 1 (where the gate sends these to torch.linalg.eigh, this is the
    # measurement behind that) ----
    factor_ms = {}
    for n in sorted({n for dims in KRON_POINTS for n in dims}):
        panel = shifted_panel(torch, lap1d(torch, n, device, f32)[None])
        tol = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(n)
        Gk, sk, gk, _ = jacobi_sweep_cuda(panel, 18, tol, return_stats=True)
        cluster = jacobi_sweep_cuda.last_cluster
        Gp, sp = jacobi_sweep_plain(panel, 18, tol)
        torch.cuda.synchronize()
        sweep_checks(torch, "jacobi_sweep (1, %d, %d)" % (n, n), panel, Gk, Gp, sk, sp, gk,
                     tol, torch.linalg.eigvalsh(panel.double()), cluster=cluster)
        factor_ms[n] = (timed_ms(torch, lambda: jacobi_sweep_cuda(panel, 18, tol), reps=3,
                                 inner=3),
                        timed_ms(torch, lambda: torch.linalg.eigh(panel), reps=3, inner=3))
        print("  sweep kernel at (1, %d, %d): %.3f ms, torch.linalg.eigh of the panel %.3f ms "
              "[%s]" % (n, n, *factor_ms[n], card))
    sweeps = 0
    rows = []

    def driven(fn):
        nonlocal sweeps
        jacobi_sweep_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        sweeps += jacobi_sweep_cuda.launches
        return out, jacobi_sweep_cuda.launches

    def once_ms(fn):
        return timed_ms(torch, fn, reps=3, inner=1)

    def forced_ms(fn):
        # the gate opened at every batch: every factor through the sweep kernel
        saved = jmod._GATE_MIN_BATCH
        jmod._GATE_MIN_BATCH = {k: (1,) * len(v) for k, v in saved.items()}
        try:
            return once_ms(fn)
        finally:
            jmod._GATE_MIN_BATCH = saved

    for dims in KRON_POINTS:
        N = math.prod(dims)
        factors = [lap1d(torch, n, device, f32) for n in dims]
        # one decomposition a factor; the kernel where the gate approves
        expect = sum(bool(use_jacobi_for(f)) for f in factors)
        A = xt.KronSumOperator(*factors, is_hermitian=True)
        B = torch.as_tensor(rng.standard_normal((N, KRON_NCOLS)), dtype=f32, device=device)
        w = torch.as_tensor(rng.standard_normal((N, KRON_NCOLS)), dtype=f32, device=device)
        tag = "kron %s (N = %d)" % (" x ".join(map(str, dims)), N)
        print("path B, %s, nc %d, float32 [%s]:" % (tag, KRON_NCOLS, card))
        check(_default_method(A, None, None) == "kron_direct",
              "%s: method=None does not route to kron_direct" % tag)
        lam1 = [2.05 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)) for n in dims]
        grid = lam1[0]
        for l1 in lam1[1:]:
            grid = np.add.outer(grid, l1)
        analytic = np.sort(grid.reshape(-1))
        # shifts below the spectrum (the pencil stays positive definite)
        E = torch.as_tensor([-0.5, -0.1, 0.0, 0.5 * analytic[0]], dtype=f32, device=device)

        for e_name, Ev in (("E=None", None), ("per-column E", E)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                (x, info), n_sw = driven(lambda: xt.linalg.solve(A, B, E=Ev, return_info=True))
                xc, ic = xt.linalg.solve(A, B, E=Ev, method="cg", return_info=True, **KRON_CG)
            r = A.mm(x) - B
            rc = A.mm(xc) - B
            if Ev is not None:
                r, rc = r - x * Ev, rc - xc * Ev
            d_ms = once_ms(lambda: xt.linalg.solve(A, B, E=Ev))
            k_ms = forced_ms(lambda: xt.linalg.solve(A, B, E=Ev))
            c_ms = once_ms(lambda: xt.linalg.solve(A, B, E=Ev, method="cg", **KRON_CG))
            print("  solve %s: method=None (kron_direct) converged %.0f, backward-error ratio "
                  "%.3g, max |Ax-b| %.2e, sweep launches %d, %.3f ms (every factor through "
                  "the sweep kernel: %.3f ms); cg converged %.0f after "
                  "%.0f iterations, max |Ax-b| %.2e, %.3f ms; max |x_direct - x_cg| / max |x| "
                  "%.2e; warnings %s"
                  % (e_name, float(info["converged"]), float(info["resid_rel"]),
                     float(r.abs().max()), n_sw, d_ms, k_ms, float(ic["converged"]),
                     float(ic["iterations"]), float(rc.abs().max()), c_ms,
                     float((x - xc).abs().max() / xc.abs().max()),
                     [wi.category.__name__ for wi in caught]))
            rows.append({"point": tag, "case": "solve, " + e_name, "kron_direct_ms": d_ms,
                         "kron_direct_sweep_kernel_forced_ms": k_ms,
                         "cg_ms": c_ms, "cg_iterations": float(ic["iterations"]),
                         "kron_direct_max_resid": float(r.abs().max()),
                         "cg_max_resid": float(rc.abs().max())})
            check(float(info["converged"]) == 1.0 and bool(torch.isfinite(x).all()),
                  "%s %s: kron_direct did not converge" % (tag, e_name))
            check(float(ic["converged"]) == 1.0, "%s %s: cg did not converge" % (tag, e_name))
            check(not any(issubclass(wi.category, ConvergenceWarning) for wi in caught),
                  "%s %s: ConvergenceWarning" % (tag, e_name))
            check(n_sw == expect, "%s %s: %d sweep launches, the gate expects %d"
                  % (tag, e_name, n_sw, expect))
            # cg stops at rtol 1e-5 on a kappa ~ 80 operator
            check(float((x - xc).abs().max() / xc.abs().max()) <= 2e-3,
                  "%s %s: kron_direct and cg disagree" % (tag, e_name))

        # a shift AT a (computed) eigenvalue sum: flagged, no Inf/NaN
        comb, _ = A.combined_eigendecomposition()
        E_sing = E.clone()
        E_sing[1] = comb.reshape(-1)[N // 3]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ConvergenceWarning)
            xs, i_s = xt.linalg.solve(A, B, E=E_sing, return_info=True)
        print("  solve with E[1] at an eigenvalue sum: converged %.0f, finite %s, max |x| %.2e"
              % (float(i_s["converged"]), bool(torch.isfinite(xs).all()), float(xs.abs().max())))
        check(float(i_s["converged"]) == 0.0 and bool(torch.isfinite(xs).all()),
              "%s: a singular shift is not flagged, or gave Inf/NaN" % tag)

        # ---- symeig: default routing takes kron_exact ----
        (ev, X, ie), n_sw = driven(lambda: xt.linalg.symeig(A, KRON_NEIG, "lowest",
                                                            return_info=True))
        want = analytic[:KRON_NEIG]
        scale = analytic[-1]
        err = float(np.abs(ev.double().cpu().numpy() - want).max() / scale)
        res = float((A.mm(X) - X * ev).abs().max())
        orth = float((X.mT @ X - torch.eye(KRON_NEIG, device=device)).abs().max())
        e_ms = once_ms(lambda: xt.linalg.symeig(A, KRON_NEIG, "lowest"))
        print("  symeig(A, %d, lowest), method=None: evals against the analytic sums, max "
              "|diff| / max |lambda| %.2e (lowest %.6f, analytic %.6f), max |A X - X E| %.2e, "
              "|X^T X - I|_max %.2e, sweep launches %d, %.3f ms"
              % (KRON_NEIG, err, float(ev[0]), want[0], res, orth, n_sw, e_ms))
        check(tuple(X.shape) == (N, KRON_NEIG) and float(ie["converged"]) == 1.0,
              "%s symeig: bad shapes or info" % tag)
        # float32 factor decompositions: eps |A| per factor
        check(err <= 1e-5, "%s symeig: eigenvalues off the analytic sums by %.3e"
              % (tag, err))
        # the float32 gates of config 2: residual / |A| and orthonormality
        check(res <= 2e-5 * scale and orth <= 5e-5, "%s symeig: residual %.3e, "
              "orthogonality %.3e" % (tag, res, orth))
        check(n_sw == expect, "%s symeig: %d sweep launches, the gate expects %d"
              % (tag, n_sw, expect))

        # ---- gradients to the factors ----
        def solve_grads(dtype, method=None):
            leaves = [f.to(dtype).clone().requires_grad_() for f in factors]
            op = xt.KronSumOperator(*((l + l.mT) / 2 for l in leaves), is_hermitian=True)
            x = xt.linalg.solve(op, B.to(dtype), E=E.to(dtype), method=method)
            return torch.autograd.grad((x * w.to(dtype)).sum(), leaves)

        def eig_grads(dtype):
            leaves = [f.to(dtype).clone().requires_grad_() for f in factors]
            op = xt.KronSumOperator(*((l + l.mT) / 2 for l in leaves), is_hermitian=True)
            ev, _ = xt.linalg.symeig(op, KRON_NEIG, "lowest")
            # symmetric in the (degenerate) eigenvalues: their order is free
            return torch.autograd.grad((ev ** 2).sum(), leaves)

        g_solve, n_sw_g = driven(lambda: solve_grads(f32))
        g_eig, _ = driven(lambda: eig_grads(f32))
        if len(dims) == 2:
            # float64 reference independent of the port: the materialised
            # operator and torch.linalg.solve, column by column for E
            leaves = [f.double().clone().requires_grad_() for f in factors]
            s0, s1 = ((l + l.mT) / 2 for l in leaves)
            eye0 = torch.eye(dims[0], dtype=f64, device=device)
            eye1 = torch.eye(dims[1], dtype=f64, device=device)
            dense = torch.kron(s0, eye1) + torch.kron(eye0, s1)
            eyeN = torch.eye(N, dtype=f64, device=device)
            cols = [torch.linalg.solve(dense - E[c].double() * eyeN, B[:, c].double())
                    for c in range(KRON_NCOLS)]
            ref_solve = torch.autograd.grad((torch.stack(cols, -1) * w.double()).sum(), leaves)
            ref_name = "float64 torch.linalg.solve of the materialised operator"
            del dense, eyeN, cols
        else:
            ref_solve = solve_grads(f64)
            ref_name = "the float64 run of the same route (torch.linalg.eigh factors)"
        # eigenvalues: the factors' float64 torch.linalg.eigvalsh, summed
        leaves = [f.double().clone().requires_grad_() for f in factors]
        tot = None
        for i, l in enumerate(leaves):
            shape = [-1 if j == i else 1 for j in range(len(dims))]
            li = torch.linalg.eigvalsh((l + l.mT) / 2).reshape(shape)
            tot = li if tot is None else tot + li
        low = torch.sort(tot.reshape(-1)).values[:KRON_NEIG]
        ref_eig = torch.autograd.grad((low ** 2).sum(), leaves)
        rs = [float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
              for a, b in zip(g_solve, ref_solve)]
        re_ = [float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
               for a, b in zip(g_eig, ref_eig)]
        gs_ms = once_ms(lambda: solve_grads(f32))
        print("  gradient to the factors, rel L2: through kron_direct against %s: %s "
              "(sweep launches forward + adjoint %d, %.3f ms); of sum(evals^2) through "
              "kron_exact against float64 eigvalsh of the factors: %s"
              % (ref_name, ", ".join("%.2e" % v for v in rs), n_sw_g, gs_ms,
                 ", ".join("%.2e" % v for v in re_)))
        rows.append({"point": tag, "case": "symeig and gradients", "symeig_ms": e_ms,
                     "evals_rel_err": err, "kron_direct_forward_and_gradient_ms": gs_ms,
                     "grad_rel_l2_kron_direct": rs, "grad_rel_l2_kron_exact": re_})
        check(max(rs) <= 1e-3, "%s: kron_direct gradient off float64: %s" % (tag, rs))
        check(max(re_) <= 1e-3, "%s: kron_exact gradient off float64: %s" % (tag, re_))
        check(n_sw_g == 2 * expect, "%s: gradient through kron_direct made %d sweep "
              "launches, not %d" % (tag, n_sw_g, 2 * expect))
    print(json.dumps({"phase": "path_b", "card": card, "sweep_launches": sweeps,
                      "factor_sweep_kernel_ms_and_eigh_ms": factor_ms, "points": rows}))
    return sweeps


def config1(torch, np, xt, device, card):
    """BASELINE config 1 through ``optimize``: the README's 2 x 2 tanh root
    with first- and second-order implicit gradients against a float64
    oracle that differentiates through unrolled Newton iterations, then
    ``benchmarks/bench_optimize.py``'s forward workload (512 systems
    ``y = tanh(A y + b)``, n = 32, float32) as one joint system, the batch
    semantics of the torch xitorch: rootfinder (broyden1), equilibrium
    (anderson_acc) and minimize (lbfgs, on its least-squares recipe),
    forward and the gradient of ``sum(y^2)`` against the float64 run of the
    same route, with times and the device's idle share.  Config 1 launches
    no kernel of this package (the Jacobian operator is matrix-free, so the
    adjoint solve takes a Python-loop method); the counters must read 0."""
    from xitorch_tpu_torch.ops import (
        fused_cg_cuda, jacobi_sweep_cuda, structured_cg_cuda, thomas_cuda,
    )
    from xitorch_tpu_torch.ops.dc_kernel import dc_precondition_cuda
    from xitorch_tpu_torch.ops.dc_level import dc_level_cuda

    kernels = (structured_cg_cuda, thomas_cuda, fused_cg_cuda, jacobi_sweep_cuda,
               dc_precondition_cuda, dc_level_cuda)
    for k in kernels:
        k.launches = 0
    jacobi_sweep_cuda.launches_complex = 0
    opt = xt.optimize
    f32, f64 = torch.float32, torch.float64
    rows = {}
    # host seconds of each part of this phase, checks and profiling included
    spent, t_part = {}, time.perf_counter()

    # ---- the README example ----
    def readme_f(y, A):
        return torch.tanh(A @ y + 0.1) + y / 2.0

    A_r = torch.tensor([[1.1, 0.4], [0.3, 0.8]], dtype=f64, device=device)
    y0_r = torch.zeros((2, 1), dtype=f64, device=device)

    def readme_loss(A):
        y = opt.rootfinder(readme_f, y0_r, params=(A,), f_tol=1e-13, maxiter=10000)
        return (y ** 2).sum()

    def oracle_loss(A):
        # Newton's iteration unrolled, autograd through every step: the
        # implicit derivatives at convergence, independent of the port
        y = torch.zeros((2,), dtype=f64, device=device)
        for _ in range(12):
            J = torch.autograd.functional.jacobian(
                lambda yy: readme_f(yy[:, None], A)[:, 0], y, create_graph=True)
            y = y - torch.linalg.solve(J, readme_f(y[:, None], A)[:, 0])
        return (y ** 2).sum()

    y_r = opt.rootfinder(readme_f, y0_r, params=(A_r,), f_tol=1e-12)
    Ag = A_r.clone().requires_grad_()
    (g_p,) = torch.autograd.grad(readme_loss(Ag), Ag)
    (g_o,) = torch.autograd.grad(oracle_loss(Ag), Ag)
    H_p = torch.autograd.functional.hessian(readme_loss, A_r)
    H_o = torch.autograd.functional.hessian(oracle_loss, A_r)
    e_val = float((y_r.cpu() - torch.tensor([[-0.04593078], [-0.06633125]],
                                            dtype=f64)).abs().max())
    e_g = float((g_p - g_o).abs().max() / g_o.abs().max())
    e_h = float((H_p - H_o).abs().max() / H_o.abs().max())
    fwd_r_ms = timed_ms(torch, lambda: opt.rootfinder(readme_f, y0_r, params=(A_r,),
                                                      f_tol=1e-12), reps=3, inner=3)
    grad_r_ms = timed_ms(torch, lambda: torch.autograd.grad(readme_loss(Ag), Ag), reps=3,
                         inner=3)
    hess_r_ms = timed_ms(torch, lambda: torch.autograd.functional.hessian(readme_loss, A_r),
                         reps=3, inner=1)
    print("config 1, the README example (float64) [%s]: y %s (README value within "
          "%.1e); gradient of sum(y^2) rel to the unrolled-Newton oracle %.2e, Hessian "
          "%.2e; forward %.3f ms, forward + gradient %.3f ms, Hessian %.3f ms"
          % (card, [round(float(v), 8) for v in y_r.flatten()], e_val, e_g, e_h,
             fwd_r_ms, grad_r_ms, hess_r_ms))
    check(e_val <= 1e-4, "README example: the root is off the README value")
    # the BASELINE target for config 1's gradients
    check(e_g <= 1e-6 and e_h <= 1e-6, "README example: gradients off the oracle: %.3e, "
          "%.3e" % (e_g, e_h))
    rows["readme"] = {"fwd_ms": fwd_r_ms, "grad_ms": grad_r_ms, "hessian_ms": hess_r_ms,
                      "grad_rel": e_g, "hessian_rel": e_h}
    spent["readme"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # ---- bench_optimize.py's forward workload, one joint system ----
    B, n = OPT_SHAPE
    rng = np.random.default_rng(7)
    w = rng.standard_normal((B, n, n))
    a_np = 0.45 * w / np.abs(w).sum(-1, keepdims=True).clip(min=1e-12)
    b_np = 0.3 * rng.standard_normal((B, n))
    rng = np.random.default_rng(13)
    am_np = np.eye(n) + 0.5 * rng.standard_normal((B, n, n)) / math.sqrt(n)
    bm_np = rng.standard_normal((B, n))

    def mv(a, y):
        return (a @ y[..., None])[..., 0]

    def fcn_root(y, a, b):
        return torch.tanh(mv(a, y) + b) - y

    def fcn_fix(y, a, b):
        return torch.tanh(mv(a, y) + b)

    def fcn_min(y, a, b):
        r = mv(a, y) - b
        return (r * r).sum()

    # the benchmark's per-system tolerance, on the joint norm of B systems
    joint = OPT_TOL * math.sqrt(B)
    suites = {
        "rootfinder broyden1": (
            lambda a, b, tol: opt.rootfinder(fcn_root, torch.zeros_like(b), params=(a, b),
                                             method="broyden1", f_tol=tol, x_tol=tol,
                                             maxiter=200, return_info=True),
            (a_np, b_np), 5e-5 * math.sqrt(n)),
        "equilibrium anderson_acc": (
            lambda a, b, tol: opt.equilibrium(fcn_fix, torch.zeros_like(b), params=(a, b),
                                              method="anderson_acc", f_tol=tol, x_tol=tol,
                                              maxiter=200, return_info=True),
            (a_np, b_np), 5e-5 * math.sqrt(n)),
        "minimize lbfgs": (
            lambda a, b, tol: opt.minimize(fcn_min, torch.zeros_like(b), params=(a, b),
                                           method="lbfgs", gtol=tol, maxiter=200,
                                           return_info=True),
            (am_np, bm_np), 1e-4 * math.sqrt(n)),
    }
    for name, (run, (an, bn), gate) in suites.items():
        a32, b32 = (torch.as_tensor(x, dtype=f32, device=device) for x in (an, bn))
        y, info = run(a32, b32, joint)
        y64 = y.double().cpu().numpy()
        ay = np.einsum("bij,bj->bi", an, y64)
        if name.startswith("minimize"):
            resid = np.abs(2.0 * np.einsum("bji,bj->bi", an, ay - bn))
        else:
            resid = np.abs(np.tanh(ay + bn) - y64)
        worst = float(resid.max())

        def grads(dtype, tol):
            a_, b_ = (torch.as_tensor(x, dtype=dtype, device=device).requires_grad_()
                      for x in (an, bn))
            y_, _ = run(a_, b_, tol)
            return torch.autograd.grad((y_ ** 2).sum(), (a_, b_))

        g32 = grads(f32, joint)
        g64 = grads(f64, 1e-10 * math.sqrt(B))
        num = math.sqrt(sum(float(((x.double() - r) ** 2).sum()) for x, r in zip(g32, g64)))
        den = math.sqrt(sum(float((r ** 2).sum()) for r in g64))
        rel = num / den
        fwd_ms = timed_ms(torch, lambda: run(a32, b32, joint), reps=3, inner=1)
        grad_ms = timed_ms(torch, lambda: grads(f32, joint), reps=3, inner=1)
        if name == PROFILED_OPT:
            # the routes share one loop shape (a Python step, one host sync):
            # one profiled route stands for all, the others stay unprofiled
            fwd_busy = device_busy_ms(torch, lambda: run(a32, b32, joint), calls=1)
            grad_busy = device_busy_ms(torch, lambda: grads(f32, joint), calls=1)
            busy_txt = ("device busy %.3f ms, idle share %.0f%%; forward + gradient device "
                        "busy %.3f ms, idle share %.0f%%"
                        % (fwd_busy, 100 * max(0.0, 1 - fwd_busy / fwd_ms), grad_busy,
                           100 * max(0.0, 1 - grad_busy / grad_ms)))
        else:
            fwd_busy = grad_busy = None
            busy_txt = "idle share not measured (profiled: %s)" % PROFILED_OPT
        print("config 1, %s (%d systems of n = %d as one joint system, float32) [%s]: "
              "converged %.0f after %.0f iterations; worst per-system residual %.2e (gate "
              "%.2e); gradient of sum(y^2) to (A, b) rel L2 to the float64 run %.2e; forward "
              "%.3f ms (%.1f systems/s), forward + gradient %.3f ms; %s"
              % (name, B, n, card, float(info["converged"]), float(info["iterations"]),
                 worst, gate, rel, fwd_ms, B / fwd_ms * 1e3, grad_ms, busy_txt))
        check(bool(torch.isfinite(y).all()) and worst < gate,
              "config 1 %s: residual %.3e above the gate %.3e" % (name, worst, gate))
        # the benchmark's gradient gate against a float64 reference
        check(rel < 2e-2, "config 1 %s: gradient off the float64 run by %.3e" % (name, rel))
        rows[name] = {"converged": float(info["converged"]),
                      "iterations": float(info["iterations"]), "worst_residual": worst,
                      "grad_rel_l2_vs_f64": rel, "fwd_ms": fwd_ms, "grad_ms": grad_ms,
                      "fwd_busy_ms": fwd_busy, "grad_busy_ms": grad_busy}
        spent[name], t_part = time.perf_counter() - t_part, time.perf_counter()
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernels}
    launched["jacobi_sweep_cuda (complex)"] = jacobi_sweep_cuda.launches_complex
    print("config 1: kernel launches %s (none is expected: no kernel of this package is on "
          "this path)" % launched)
    check(not any(launched.values()), "config 1 launched a kernel: %s" % launched)
    print("config 1: host seconds by part %s" % {k: round(v, 1) for k, v in spent.items()})
    print(json.dumps({"phase": "config1", "card": card, "rows": rows}))


def config3(torch, np, xt, device, card, chain_probe):
    """BASELINE config 3 on the card: the structured CG kernel's two designs
    and the Thomas kernel against their plain versions at config 3's shapes
    and the card tests' shapes, the register window against the build,
    ``linalg.solve`` forward and gradient (V given: the CG kernel; V None:
    the Thomas kernel), the library calls, the CG designs in turns, the
    Thomas kernel against its chain floor and the recorded time of the
    kernel it replaced, and timings.  Returns the two kernels' records for
    the JSON line."""
    import warnings

    from xitorch_tpu_torch.ops.structured_cg import (
        choose_path, fits_structured_cg, register_attrs, register_window, structured_cg_cuda,
        structured_cg_plain,
    )
    from xitorch_tpu_torch.ops.tridiag import thomas_cuda, thomas_plain
    from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning

    rng = np.random.default_rng(SEED)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    max_niter = min(2 * N, 400)

    # ---- 2. kernel vs plain: CG at config-3 shapes ----
    d_np, V_np, b_np = config3_arrays(np, rng)
    d, b = dev(d_np), dev(b_np[..., 0])
    band = np.ones((BATCH, 1, N))
    bl_np, bu_np = band.copy(), band.copy()
    bl_np[:, :, 0] = 0.0
    bu_np[:, :, -1] = 0.0
    bl, bu = dev(bl_np), dev(bu_np)
    Vf = dev(np.swapaxes(V_np, 1, 2))  # (K, r, n)
    cg_args = (d, bl, bu, Vf, b, (1,))
    cg_kw = dict(rtol=RTOL, atol=ATOL, max_niter=max_niter)
    xk, itk, _ = structured_cg_cuda(*cg_args, **cg_kw)
    cg_design = structured_cg_cuda.last_design
    xp, itp, _ = structured_cg_plain(*cg_args, **cg_kw)
    torch.cuda.synchronize()
    check(cg_design == "register", "config 3 did not take the register design: %s" % cg_design)
    # the register window from the compiled kernels: registers a thread and
    # the most threads a block may launch with; it lies inside the shared
    # design's window (fits_structured_cg's premise)
    for r_w in (1, 2, 4, 8):
        for nb_w in (1, 2):
            regs, threads = register_attrs(r_w, nb_w, b.device)
            win = register_window(r_w, nb_w, b.device)
            print("cg register design, rank <= %d, %d band(s): %d registers a thread, %d "
                  "threads a block at most, window n <= %d" % (r_w, nb_w, regs, threads, win))
            check(fits_structured_cg(win, r_w, torch.float32, nb_w),
                  "the register window at rank %d, %d bands lies outside the shared design's"
                  % (r_w, nb_w))

    def flat_resid(x):
        A = xt.TridiagLowRankOperator(d, 1.0, dev(V_np))
        return torch.linalg.norm(A.mv(x) - b, dim=-1)

    bnorm = torch.linalg.norm(b, dim=-1)
    # relative to ||x||: f32 reduction order differs (warp tree vs
    # PyTorch's), so the iterates drift apart by a few ulps per step
    cg_rel = float((torch.linalg.norm(xk - xp, dim=-1) / torch.linalg.norm(xp, dim=-1)).max())
    cg_abs = float((xk - xp).abs().max())
    it_diff = int((itk - itp).abs().max())
    rk, rp = flat_resid(xk), flat_resid(xp)
    print("cg kernel vs plain (K=%d, n=%d, r=%d, nb=1): max rel err %.3e, max abs "
          "err %.3e, iterations %d..%d (max |diff| %d), measured resid/(rtol*|b|) "
          "kernel %.3f plain %.3f" % (BATCH, N, RANK, cg_rel, cg_abs, int(itk.min()),
                                      int(itk.max()), it_diff,
                                      float((rk / (RTOL * bnorm)).max()),
                                      float((rp / (RTOL * bnorm)).max())))
    check(bool(torch.isfinite(xk).all()), "cg kernel returned non-finite values")
    check(cg_rel <= 1e-4, "cg kernel disagrees with plain: rel %.3e" % cg_rel)
    # a per-system stop on f32 recurrences: rounding may move the
    # crossing of the half-tolerance line by a step or two
    check(it_diff <= 2, "cg iteration counts differ by %d" % it_diff)
    check(bool((rk < RTOL * bnorm).all()) and bool((rp < RTOL * bnorm).all()),
          "cg measured residual above rtol*|b|")
    # each design at config 3 and at the card tests' shapes (the shared
    # design wherever the planes fit, the register design inside its window)
    cg_cases = [((1,), RANK, BATCH, N, cg_args)]
    for offsets_t, r_t, K_t, n_t in (((1,), 1, 3, 33), ((1, 2), 3, 7, 200),
                                     ((1, 2, 5), 16, 5, 100), ((1,), 8, 2, 3000)):
        g = np.random.default_rng(0)
        d_t = dev(6.0 + 2.0 * g.uniform(size=(K_t, n_t)))
        bl_t = np.zeros((K_t, len(offsets_t), n_t))
        bu_t = np.zeros((K_t, len(offsets_t), n_t))
        for k_t, o_t in enumerate(offsets_t):
            c_t = 0.5 * g.uniform(size=(K_t, n_t - o_t))
            bl_t[:, k_t, o_t:] = c_t
            bu_t[:, k_t, :n_t - o_t] = c_t
        V_t = dev(g.standard_normal((K_t, r_t, n_t)) / math.sqrt(n_t))
        cg_cases.append((offsets_t, r_t, K_t, n_t,
                         (d_t, dev(bl_t), dev(bu_t), V_t, dev(g.standard_normal((K_t, n_t))),
                          offsets_t)))
    for offsets_t, r_t, K_t, n_t, args_t in cg_cases:
        kw_t = dict(rtol=RTOL, atol=ATOL, max_niter=min(2 * n_t, 400))
        xp_t, itp_t, _ = structured_cg_plain(*args_t, **kw_t)
        chosen = choose_path(n_t, r_t, offsets_t,
                             register_window(r_t, len(offsets_t), b.device))
        for path in ("register", "shared"):
            if path == "register" and chosen != "register":
                continue
            xk_t, itk_t, resk_t = structured_cg_cuda(*args_t, path=path, **kw_t)
            torch.cuda.synchronize()
            rel_t = float((torch.linalg.norm(xk_t - xp_t, dim=-1)
                           / torch.linalg.norm(xp_t, dim=-1)).max())
            dit_t = int((itk_t - itp_t).abs().max())
            bn_t = torch.linalg.norm(args_t[4], dim=-1)
            rec_t = float((resk_t / (RTOL * bn_t)).max())
            print("cg %s design (K=%d, n=%d, r=%d, offsets %s; chosen: %s) vs plain: x rel "
                  "%.3e, steps %d..%d (max |diff| %d), recurrence resid/(rtol*|b|) %.3f"
                  % (path, K_t, n_t, r_t, offsets_t, chosen, rel_t, int(itk_t.min()),
                     int(itk_t.max()), dit_t, rec_t))
            check(bool(torch.isfinite(xk_t).all()) and rel_t <= 1e-4 and dit_t <= 2
                  and rec_t < 0.5, "cg %s design at K=%d, n=%d, r=%d, offsets %s: outside "
                  "the bounds" % (path, K_t, n_t, r_t, offsets_t))

    # the PyTorch calls for the same function: a dense solve of the
    # materialised diag + band + V V^T batch (2 GB at this shape)
    A_dense = (torch.diag_embed(d) + torch.diag_embed(bl[:, 0, 1:], offset=-1)
               + torch.diag_embed(bu[:, 0, :-1], offset=1) + Vf.transpose(1, 2) @ Vf)
    x_chol = torch.cholesky_solve(b[..., None], torch.linalg.cholesky(A_dense))[..., 0]
    chol_rel = float((xk - x_chol).abs().max() / x_chol.abs().max())
    print("cg kernel vs Cholesky + cholesky_solve of the materialised batch: max rel err %.3e"
          % chol_rel)
    check(chol_rel <= 1e-4, "cg kernel disagrees with the dense solve: rel %.3e" % chol_rel)
    cg_chol_ms = timed_ms(torch, lambda: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky(A_dense)), reps=3, inner=1)
    cg_solve_ms = timed_ms(torch, lambda: torch.linalg.solve(A_dense, b[..., None]),
                           reps=3, inner=1)
    del A_dense, x_chol

    # ---- 3. kernel vs plain: Thomas at config-3 shapes ----
    # diagonally dominant (|dl| + |du| <= 1 < d): no pivot comes near zero
    dlp = dev(rng.uniform(-0.5, 0.5, size=(BATCH, N)))
    dp = dev(4.0 + 2.0 * rng.uniform(size=(BATCH, N)))
    dup = dev(rng.uniform(-0.5, 0.5, size=(BATCH, N)))
    bp = dev(rng.standard_normal((BATCH, N)))
    tiny = float(torch.finfo(torch.float32).tiny)
    th_args = (dlp, dp, dup, bp, tiny)
    xtk = thomas_cuda(*th_args)
    xtp = thomas_plain(*th_args)
    torch.cuda.synchronize()
    # f32, contracted multiply-adds in the kernel vs separate roundings
    th_rel = float((xtk - xtp).abs().max() / xtp.abs().max())
    th_abs = float((xtk - xtp).abs().max())
    print("thomas kernel vs plain (K=%d, n=%d, f32): max rel err %.3e, max abs err %.3e"
          % (BATCH, N, th_rel, th_abs))
    check(bool(torch.isfinite(xtk).all()), "thomas kernel returned non-finite values")
    check(th_rel <= 1e-5, "thomas kernel disagrees with plain: rel %.3e" % th_rel)
    # the card tests' shapes: one long system, many short ones, a ragged
    # block; system 0 has a zero pivot at position 1, replaced by tiny
    for K_t, n_t in ((1, 65536), (4096, 64), (33, 700)):
        g = np.random.default_rng(1)
        rows = [dev(g.uniform(-0.5, 0.5, size=(K_t, n_t))), dev(2.0 + g.uniform(size=(K_t, n_t))),
                dev(g.uniform(-0.5, 0.5, size=(K_t, n_t))), dev(g.standard_normal((K_t, n_t)))]
        rows[1][0, 0], rows[1][0, 1], rows[2][0, 0], rows[0][0, 1], rows[2][0, 1] = (
            1.0, 1.0, 1.0, 1.0, 0.0)
        rows[3][0, 1] = rows[3][0, 0]
        xs_k = thomas_cuda(*rows, tiny)
        xs_p = thomas_plain(*rows, tiny)
        torch.cuda.synchronize()
        rel_t = float((xs_k - xs_p).abs().max() / xs_p.abs().max())
        print("thomas kernel vs plain (K=%d, n=%d, f32, zero pivot in system 0): max rel err "
              "%.3e" % (K_t, n_t, rel_t))
        check(bool(torch.isfinite(xs_k).all()) and rel_t <= 1e-5,
              "thomas kernel at K=%d, n=%d: rel %.3e" % (K_t, n_t, rel_t))
    # the PyTorch call for the same function: a dense solve of the
    # materialised tridiagonal batch (2 GB at this shape)
    T_dense = (torch.diag_embed(dp) + torch.diag_embed(dlp[:, 1:], offset=-1)
               + torch.diag_embed(dup[:, :-1], offset=1))
    x_lib = torch.linalg.solve(T_dense, bp[..., None])[..., 0]
    check(float((xtk - x_lib).abs().max() / x_lib.abs().max()) <= 1e-5,
          "thomas kernel disagrees with torch.linalg.solve of the dense batch")
    th_lib_ms = timed_ms(torch, lambda: torch.linalg.solve(T_dense, bp[..., None]),
                         reps=3, inner=1)
    del T_dense, x_lib

    launches = {"structured_cg": 0, "thomas": 0}

    def reset():
        structured_cg_cuda.launches = 0
        thomas_cuda.launches = 0

    def read(name, fn):
        torch.cuda.synchronize()
        launches[name] += fn.launches
        return fn.launches

    # ---- 4. main path, forward ----
    d_np, V_np, b_np = config3_arrays(np, rng)
    dT, VT, bT = dev(d_np), dev(V_np), dev(b_np)
    cT = torch.tensor(1.0, device=device)
    A = xt.TridiagLowRankOperator(dT, cT, VT)
    reset()
    x, info = xt.linalg.solve(A, bT, method="structured_cg", rtol=RTOL, atol=ATOL,
                              return_info=True)
    n_fwd = read("structured_cg", structured_cg_cuda)
    resid = float(torch.linalg.norm(A.mm(x) - bT, dim=-2).max())
    print("forward: x %s, converged %.0f, iterations %.0f, measured max |Ax-b| %.3e "
          "(gate %.0e), cg launches %d"
          % (tuple(x.shape), float(info["converged"]), float(info["iterations"]),
             resid, RESID_GATE, n_fwd))
    check(tuple(x.shape) == (BATCH, N, 1) and bool(torch.isfinite(x).all()),
          "forward: bad solution")
    check(float(info["converged"]) == 1.0, "forward: not converged")
    check(resid < RESID_GATE, "forward: residual %.3e above the gate" % resid)
    check(n_fwd >= 1, "forward: the cg kernel was not launched")

    reset()
    x_default = xt.linalg.solve(A, bT, rtol=RTOL, atol=ATOL)
    n_def = read("structured_cg", structured_cg_cuda)
    same = float((x_default - x).abs().max())
    print("default routing: cg launches %d, max |x - x_structured_cg| %.3e" % (n_def, same))
    check(n_def >= 1, "default routing did not take the cg kernel")
    check(same == 0.0, "default routing gave another solution")

    reset()
    A_tri = xt.TridiagLowRankOperator(dT, cT)
    x_tri, info_tri = xt.linalg.solve(A_tri, bT, method="structured_cg", return_info=True)
    n_th = read("thomas", thomas_cuda)
    resid_tri = float(torch.linalg.norm(A_tri.mm(x_tri) - bT, dim=-2).max())
    print("V=None: converged %.0f, measured max |Ax-b| %.3e, thomas launches %d"
          % (float(info_tri["converged"]), resid_tri, n_th))
    check(n_th >= 1, "V=None: the thomas kernel was not launched")
    check(float(info_tri["converged"]) == 1.0 and resid_tri < RESID_GATE,
          "V=None: bad solution")
    # forward + gradient to d, c, b: the adjoint is the transposed Thomas
    # solve, so the counter moves by 2; held against float64
    # torch.linalg.solve autograd on the materialised batch
    w_tri = dev(rng.standard_normal((BATCH, N, 1)))

    def tri_grads(dtype, dense):
        leaves = [t.detach().to(dtype).clone().requires_grad_() for t in (dT, cT, bT)]
        if dense:
            dd, cc, bb = leaves
            off = cc * torch.ones(N - 1, dtype=dtype, device=device)
            T_tri = (torch.diag_embed(dd) + torch.diag_embed(off, offset=1)
                     + torch.diag_embed(off, offset=-1))
            xg = torch.linalg.solve(T_tri, bb)
        else:
            xg = xt.linalg.solve(xt.TridiagLowRankOperator(leaves[0], leaves[1]), leaves[2],
                                 method="structured_cg")
        return torch.autograd.grad((xg * w_tri.to(dtype)).sum(), leaves)

    reset()
    g_tri = tri_grads(torch.float32, False)
    n_th_grad = read("thomas", thomas_cuda)
    g_ref = tri_grads(torch.float64, True)
    torch.cuda.synchronize()
    rels_tri = [float(torch.linalg.norm(a.double() - r) / torch.linalg.norm(r))
                for a, r in zip(g_tri, g_ref)]
    print("V=None gradient: thomas launches %d (forward + adjoint); rel L2 err vs float64 "
          "torch.linalg.solve autograd: d %.3e, c %.3e, b %.3e" % (n_th_grad, *rels_tri))
    check(n_th_grad == 2, "V=None gradient: %d thomas launches, expected 2" % n_th_grad)
    check(all(bool(torch.isfinite(g).all()) for g in g_tri) and max(rels_tri) <= 1e-3,
          "V=None gradient disagrees with float64: %s" % rels_tri)
    del g_ref

    # small input against a dense float64 solve
    As = xt.TridiagLowRankOperator(dT[:4, :64], cT, VT[:4, :64])
    xs = xt.linalg.solve(As, bT[:4, :64], method="structured_cg", rtol=RTOL, atol=ATOL)
    xd = torch.linalg.solve(As.fullmatrix().double(), bT[:4, :64].double())
    small = float((xs.double() - xd).abs().max() / xd.abs().max())
    print("small input (4 x 64) vs dense float64 solve: max rel err %.3e" % small)
    # f32 CG stopped at half of rtol=1e-6
    check(small < 1e-5, "small input disagrees with the dense solve")

    # ---- 5. main path, gradient ----
    w = dev(rng.standard_normal((BATCH, N, 1)))

    def plain_structured_cg(A, B, E=None, M=None, rtol=1e-6, atol=1e-8,
                            max_niter=None, **_):
        # the dispatcher's layout for a single-column config-3 solve, with
        # the plain CG in place of the kernel
        check(E is None and M is None and B.shape[-1] == 1, "plain method: config 3 only")
        cl, cu = A.full_couplings()
        nn = A.shape[-1]
        x, _, _ = structured_cg_plain(
            A.d.contiguous(), cl[:, None, :].contiguous(), cu[:, None, :].contiguous(),
            A.V.transpose(1, 2).contiguous(), B[..., 0].contiguous(), (1,),
            rtol=rtol, atol=atol, max_niter=min(2 * nn, 400) if max_niter is None
            else max_niter)
        return x[..., None]

    def grads(method):
        leaves = [t.detach().clone().requires_grad_() for t in (dT, cT, VT, bT)]
        Ag = xt.TridiagLowRankOperator(leaves[0], leaves[1], leaves[2])
        xg = xt.linalg.solve(Ag, leaves[3], method=method, rtol=RTOL, atol=ATOL,
                             bck_options={"method": method, "rtol": RTOL, "atol": ATOL})
        loss = (xg * w).sum()
        return torch.autograd.grad(loss, leaves)

    reset()
    g_k = grads("structured_cg")
    n_grad = read("structured_cg", structured_cg_cuda)
    g_p = grads(plain_structured_cg)
    torch.cuda.synchronize()
    rels = [float(torch.linalg.norm(a - p) / torch.linalg.norm(p)) for a, p in zip(g_k, g_p)]
    print("gradient: cg launches %d (forward + adjoint); rel L2 err vs plain on the card: "
          "d %.3e, c %.3e, V %.3e, b %.3e" % (n_grad, *rels))
    check(n_grad >= 2, "gradient: the adjoint solve did not launch the cg kernel")
    check(all(bool(torch.isfinite(g).all()) for g in g_k), "gradient: non-finite values")
    # both sides stop at half of rtol=1e-6 in f32; the gradients are
    # products of two such solves
    check(max(rels) <= 1e-3, "gradient disagrees with the plain path: %s" % rels)

    # ---- 6. timing ----
    # the two CG designs in turns (register, shared, shared, register)
    cg_turns = []
    for path in ("register", "shared", "shared", "register"):
        cg_turns.append((path, timed_ms(torch, lambda: structured_cg_cuda(
            *cg_args, path=path, **cg_kw))))
    cg_ms = statistics.median(t for w, t in cg_turns if w == "register")
    cg_shared_ms = statistics.median(t for w, t in cg_turns if w == "shared")
    cg_dev_ms = kernel_device_ms(torch, lambda: structured_cg_cuda(
        *cg_args, path="register", **cg_kw), "structured_cg_reg_kernel")
    cg_shared_dev_ms = kernel_device_ms(torch, lambda: structured_cg_cuda(
        *cg_args, path="shared", **cg_kw), "structured_cg_kernel")
    cg_plain_ms = timed_ms(torch, lambda: structured_cg_plain(*cg_args, **cg_kw))
    th_ms = timed_ms(torch, lambda: thomas_cuda(*th_args))
    th_dev_ms = kernel_device_ms(torch, lambda: thomas_cuda(*th_args), "thomas_kernel")
    # the chain floor: the same recurrence on registers, at the same K and n
    probe = chain_probe()
    g = np.random.default_rng(2)
    probe_rows = torch.cat([dev(g.uniform(-0.5, 0.5, size=(8, 32))),
                            dev(4.0 + 2.0 * g.uniform(size=(8, 32))),
                            dev(g.uniform(-0.5, 0.5, size=(8, 32))),
                            dev(g.standard_normal((8, 32)))])
    probe_out = torch.empty(-(-BATCH // 32) * 32, dtype=torch.float32, device=device)

    def chain_run():
        stream = torch.cuda.current_stream().cuda_stream
        check(probe.chain_f32(probe_rows.data_ptr(), probe_out.data_ptr(), N, BATCH, tiny,
                              stream) == 0, "the chain probe did not launch")

    chain_ms = timed_ms(torch, chain_run)
    chain_dev_ms = kernel_device_ms(torch, chain_run, "chain_kernel")
    check(bool(torch.isfinite(probe_out).all()), "the chain probe gave non-finite values")
    # the plain Thomas loop takes ~120 ms a call: fewer calls
    th_plain_ms = timed_ms(torch, lambda: thomas_plain(*th_args), reps=3, inner=1)
    fwd_ms = timed_ms(torch, lambda: xt.linalg.solve(A, bT, method="structured_cg",
                                                     rtol=RTOL, atol=ATOL))
    fwd_plain_ms = timed_ms(torch, lambda: xt.linalg.solve(
        A, bT, method=plain_structured_cg, rtol=RTOL, atol=ATOL))
    grad_ms = timed_ms(torch, lambda: grads("structured_cg"))
    grad_plain_ms = timed_ms(torch, lambda: grads(plain_structured_cg))
    fwd_busy = device_busy_ms(torch, lambda: xt.linalg.solve(
        A, bT, method="structured_cg", rtol=RTOL, atol=ATOL),
        expect=("structured_cg_reg_kernel",))
    grad_busy = device_busy_ms(torch, lambda: grads("structured_cg"),
                               expect=("structured_cg_reg_kernel",))
    # the eager convergence checks of this phase's structured_cg solves
    # without info were queued behind them; they report here, and none warns
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xt.linalg.flush_convergence_warnings()
    check(not any(issubclass(w.category, ConvergenceWarning) for w in caught),
          "config 3: a structured_cg solve did not converge")
    print("timing [%s], median of %d repetitions of %d calls after warm-up:"
          % (card, REPS, INNER))
    print("  structured_cg kernel, register design %.4f ms (events; device time by name "
          "%.4f ms), shared-memory design %.4f ms (device time %.4f ms), in turns %s; plain "
          "%.3f ms; Cholesky + cholesky_solve of the materialised batch %.3f ms, "
          "torch.linalg.solve %.3f ms (K=%d, n=%d, r=%d) [%s]"
          % (cg_ms, cg_dev_ms, cg_shared_ms, cg_shared_dev_ms,
             ", ".join("%s %.4f" % wt for wt in cg_turns), cg_plain_ms, cg_chol_ms,
             cg_solve_ms, BATCH, N, RANK, card))
    print("  thomas kernel %.4f ms (events; device time by name %.4f ms), plain %.3f ms, "
          "torch.linalg.solve of the materialised batch %.3f ms (K=%d, n=%d) [%s]"
          % (th_ms, th_dev_ms, th_plain_ms, th_lib_ms, BATCH, N, card))
    print("  thomas kernel against the one-thread-a-system kernel it replaced: that "
          "kernel's device time %.4f ms is recorded from another run (chip run 14 of PR 13, "
          "NVIDIA H100 80GB HBM3 at 700 W, PERF.md), not measured here; against it this "
          "run's time is %.2fx shorter [%s]"
          % (THOMAS_REPLACED_MS, THOMAS_REPLACED_MS / th_dev_ms, card))
    print("  thomas chain floor (the recurrence on registers, K=%d, n=%d): %.4f ms (device "
          "time %.4f ms); the kernel is %.2fx it [%s]"
          % (BATCH, N, chain_ms, chain_dev_ms, th_dev_ms / chain_dev_ms, card))
    print("  FWD solve (incl. the eager convergence check): %.1f solves/s (%.3f ms), "
          "plain path %.1f solves/s (%.3f ms) [%s]"
          % (BATCH / fwd_ms * 1e3, fwd_ms, BATCH / fwd_plain_ms * 1e3, fwd_plain_ms, card))
    print("  GRAD (forward + backward to d, c, V, b): %.1f grads/s (%.3f ms), plain "
          "path %.1f grads/s (%.3f ms) [%s]"
          % (BATCH / grad_ms * 1e3, grad_ms, BATCH / grad_plain_ms * 1e3, grad_plain_ms,
             card))
    print("  device busy per call (torch.profiler): FWD %.3f ms (idle share %.0f%%), "
          "GRAD %.3f ms (idle share %.0f%%) [%s]"
          % (fwd_busy, 100 * max(0.0, 1 - fwd_busy / fwd_ms), grad_busy,
             100 * max(0.0, 1 - grad_busy / grad_ms), card))

    # bounds.  CG: d, the 2 nb band planes, the r planes of V and b read
    # once, x written once; per step and system the stencil, the rank-r
    # term, three dot products and three axpys, for the steps this run took.
    nb_cg = 1
    cg_bytes = (3 + 2 * nb_cg + RANK) * BATCH * N * 4
    cg_flops = float(itk.sum()) * N * (1 + 4 * nb_cg + 4 * RANK + 12)
    cg_bound, cg_by = bound(cg_bytes, cg_flops)
    # Thomas: dl, d, du, b read once, x written once; ~8 operations a row
    th_bound, th_by = bound(5 * N * BATCH * 4, 8.0 * N * BATCH)
    print("  bounds: structured_cg %.4f ms (%s), thomas %.4f ms (%s) [%s]"
          % (cg_bound, cg_by, th_bound, th_by, card))

    return [
        {"name": "structured_cg", "route": "cuda",
         "source": "xitorch_tpu_torch/csrc/structured_cg.cu",
         "replaces": "xitorch_tpu/ops/structured_cg.py:58",
         "launches": launches["structured_cg"], "max_abs_err": cg_abs,
         "ms": cg_dev_ms, "plain_ms": cg_plain_ms, "bound_ms": cg_bound,
         "bound_by": cg_by, "library_ms": cg_chol_ms, "design": cg_design,
         "shared_design_ms": cg_shared_dev_ms},
        {"name": "thomas", "path": "config 3: V = None, %d x %d" % (BATCH, N), "route": "cuda",
         "source": "xitorch_tpu_torch/csrc/tridiag.cu",
         "replaces": "xitorch_tpu/ops/tridiag.py:38",
         "launches": launches["thomas"], "max_abs_err": th_abs,
         "ms": th_dev_ms, "plain_ms": th_plain_ms, "bound_ms": th_bound,
         "bound_by": th_by, "library_ms": th_lib_ms, "chain_floor_ms": chain_dev_ms},
    ]


def config5(torch, np, xt, device, card):
    """BASELINE config 5 through ``models.scf``: ``tests/test_scf.py``'s
    recipe (a = N(0, 1), g = 0.3) at n = 256, nocc = 8, twice: in float32
    with ``eig_method="exacteig"`` (each SCF step decomposes the
    materialised Hamiltonian through the real sweep kernel: batch 1 at
    n = 256 passes the gate) and in float64 with davidson, as the BASELINE
    names it.  Each run: the residual of the fixed point, ``converged``,
    sum(rho) = nocc, forward and forward + gradient of ``scf_energy`` to a
    and g against the float64 dense route (``torch.linalg.eigh``: the sweep
    kernels take float32 only), times, the device's idle share (of the
    float32 forward; of one davidson decomposition at the fixed point for
    the float64 run, whose whole forward takes minutes to profile), and the
    sweep kernel's launches.  The kernel is also held against its plain
    version on the panel this path gives it (the Hamiltonian at the float32
    fixed point), and ``jacobi_eigh`` warm (the reference's default at this
    n) is timed against cold there.  Returns the kernel's record at this
    path's panel, with the path's launches."""
    from xitorch_tpu_torch.models import scf_density, scf_energy
    from xitorch_tpu_torch.models.scf import HamiltonianOp, _density, _eig_options
    from xitorch_tpu_torch.ops.jacobi_eigh import (jacobi_eigh, jacobi_sweep_cuda,
                                                   jacobi_sweep_plain)

    f32, f64 = torch.float32, torch.float64
    n, nocc = SCF_N, SCF_NOCC
    a_np = np.random.default_rng(SEED).standard_normal((n, n))
    # the float32 run names its own f_tol and x_tol (SCF_TOL32); the
    # float64 run keeps the module's (f_tol 1e-9; davidson min_eps 1e-9,
    # max_niter 2000).  Energy and gradient limits against the float64
    # reference: float32 stops at SCF_TOL32 on a density of norm ~0.5, so
    # 1e-5 (energy, first order in the density error) and 1e-3 (gradient,
    # through the two adjoint solves); float64 davidson stops at 1e-9, and
    # its adjoint's shifted solves at cg's default tolerance, so 1e-9 and
    # 1e-6
    runs = {"float32 exacteig": (f32, {"eig_method": "exacteig", "f_tol": SCF_TOL32,
                                        "x_tol": SCF_TOL32}, 1e-5, 1e-3),
            "float64 davidson": (f64, {"eig_method": "davidson"}, 1e-9, 1e-6)}

    def inputs(dtype, requires_grad=False):
        return (torch.tensor(a_np, dtype=dtype, device=device, requires_grad=requires_grad),
                torch.tensor(SCF_G, dtype=dtype, device=device, requires_grad=requires_grad))

    def energy_grad(dtype, kw):
        a, g = inputs(dtype, True)
        e = scf_energy(a, g, nocc=nocc, maxiter=400, **kw)
        return (e.detach(), *torch.autograd.grad(e, (a, g)))

    jacobi_sweep_cuda.launches = 0
    e_ref, *g_ref = energy_grad(f64, {"eig_method": "exacteig"})
    torch.cuda.synchronize()
    check(jacobi_sweep_cuda.launches == 0,
          "config 5: the float64 reference went through the sweep kernel")
    rows, path_sweeps = {}, 0
    for name, (dtype, kw, e_tol, g_tol) in runs.items():
        a, g = inputs(dtype)
        f_tol = kw.get("f_tol", 1e-9)

        def fwd():
            return scf_density(a, g, nocc=nocc, maxiter=400, return_info=True, **kw)

        if dtype == f32:
            fwd()  # one call first at these shapes (libraries, kernel attributes)
        jacobi_sweep_cuda.launches = 0
        (rho, info), fwd_ms = timed_once(torch, fwd)
        fwd_sweeps = jacobi_sweep_cuda.launches
        resid = float(torch.linalg.vector_norm(
            rho - _density(a, g, rho, nocc, kw["eig_method"],
                           **_eig_options(kw["eig_method"], None))))
        occ_err = abs(float(rho.sum()) - nocc)
        jacobi_sweep_cuda.launches = 0
        (e, *grads), grad_ms = timed_once(torch, lambda: energy_grad(dtype, kw))
        grad_sweeps = jacobi_sweep_cuda.launches
        path_sweeps += fwd_sweeps + grad_sweeps
        e_rel = abs(float(e) - float(e_ref)) / abs(float(e_ref))
        g_rel = rel_l2_all(grads, g_ref)
        if dtype == f32:
            busy_of, busy_ms_of = "forward", fwd_ms
            busy = device_busy_ms(torch, fwd, calls=1, warmup=False,
                                  expect=("jacobi_sweep",))
        else:
            # one davidson decomposition at the fixed point stands for the
            # forward, a chain of ~40 of them (profiling it all takes minutes)
            H64 = HamiltonianOp(a, g, rho)

            def one():
                return xt.linalg.symeig(H64, nocc, "lowest", method="davidson",
                                        **_eig_options("davidson", None))

            busy_of = "one davidson symeig at the fixed point"
            _, busy_ms_of = timed_once(torch, one)
            busy = device_busy_ms(torch, one, calls=1, warmup=False)
        idle = max(0.0, 1 - busy / busy_ms_of)
        print("config 5, SCF %s (n = %d, nocc = %d, g = %.1f) [%s]: converged %.0f after %.0f "
              "iterations; residual |rho - density(H(rho))| %.2e (f_tol %.0e); |sum(rho) - "
              "nocc| %.2e; energy %.6f, rel to the float64 eigh route %.2e (limit %.0e); "
              "gradient to (a, g) rel L2 %.2e (limit %.0e); forward %.3f ms, forward + "
              "gradient %.3f ms; %s: %.3f ms, device busy %.3f ms, idle share %.0f%%; sweep "
              "kernel launches %d forward, %d forward + gradient"
              % (name, n, nocc, SCF_G, card, float(info["converged"]),
                 float(info["iterations"]), resid, f_tol, occ_err, float(e), e_rel, e_tol,
                 g_rel, g_tol, fwd_ms, grad_ms, busy_of, busy_ms_of, busy, 100 * idle,
                 fwd_sweeps, grad_sweeps))
        check(float(info["converged"]) == 1.0 and resid < f_tol,
              "config 5 %s: not converged (residual %.3e)" % (name, resid))
        check(occ_err < (1e-4 if dtype == f32 else 1e-8),
              "config 5 %s: sum(rho) off nocc by %.3e" % (name, occ_err))
        check(e_rel <= e_tol and g_rel <= g_tol,
              "config 5 %s: energy (%.3e) or gradient (%.3e) off the float64 route"
              % (name, e_rel, g_rel))
        if dtype == f32:
            check(fwd_sweeps >= 1 and grad_sweeps >= 1,
                  "config 5 float32: the sweep kernel was not launched (%d, %d)"
                  % (fwd_sweeps, grad_sweeps))
            H = HamiltonianOp(a, g, rho).fullmatrix()[None]
        else:
            # davidson's projected matrices are float64: outside the sweep
            # kernels' window, they never reach the kernel
            check(fwd_sweeps == 0 and grad_sweeps == 0,
                  "config 5 float64 davidson launched the sweep kernel")
        rows[name] = {"converged": float(info["converged"]),
                      "iterations": float(info["iterations"]), "residual": resid,
                      "energy_rel": e_rel, "grad_rel_l2": g_rel, "fwd_ms": fwd_ms,
                      "grad_ms": grad_ms, "busy_of": busy_of, "busy_ms": busy,
                      "idle_share": idle, "sweeps_fwd": fwd_sweeps,
                      "sweeps_grad": grad_sweeps}

    # the sweep kernel against its plain version on this path's panel
    panel = shifted_panel(torch, H.contiguous())
    tol = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(n)
    Gk, sk, gk, rk = jacobi_sweep_cuda(panel, 18, tol, return_stats=True)
    cluster = jacobi_sweep_cuda.last_cluster
    (Gp, sp), plain_ms = timed_once(torch, lambda: jacobi_sweep_plain(panel, 18, tol))
    err = sweep_checks(torch, "jacobi_sweep (1, %d, %d), the SCF's Hamiltonian" % (n, n),
                       panel, Gk, Gp, sk, sp, gk, tol, torch.linalg.eigvalsh(panel.double()),
                       cluster=cluster)
    k_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(panel, 18, tol), reps=3, inner=3)
    lib_ms = timed_ms(torch, lambda: torch.linalg.eigh(panel), reps=3, inner=3)
    k_bound, k_by = sweep_bound(1, n, sk, rk)
    print("  sweep kernel at the SCF's panel (1, %d, %d): %.3f ms, plain %.3f ms (one call), "
          "bound %.4f ms (%s), torch.linalg.eigh of the panel %.3f ms; %d sweeps [%s]"
          % (n, n, k_ms, plain_ms, k_bound, k_by, lib_ms, int(sk.max()), card))

    # the reference's jacobi_eigh warms the sweep with the DC kernel (row 4)
    # by default for real input at 192 <= n <= 448, so at this panel; the
    # port's default is cold.  Warm against cold at this path's shape
    # (outside the counted run)
    Hc = H.contiguous()
    cold_ms = timed_ms(torch, lambda: jacobi_eigh(Hc, precondition=False), reps=3, inner=3)
    warm_ms = timed_ms(torch, lambda: jacobi_eigh(Hc, precondition=True), reps=3, inner=3)
    (ec, _, ic), (ew, _, iw) = (jacobi_eigh(Hc, precondition=p, return_info=True)
                                for p in (False, True))
    warm_err = float((ew - ec).abs().max() / ec.abs().max())
    print("  jacobi_eigh at the SCF's panel (1, %d, %d) [%s]: cold %.3f ms (%d sweeps), warm "
          "start (the DC kernel, then the sweeps; the reference's default here) %.3f ms (%d "
          "sweeps, guard sent back %d); eigenvalues warm against cold %.2e of the largest"
          % (n, n, card, cold_ms, int(ic["sweeps"].max()), warm_ms, int(iw["sweeps"].max()),
             int(iw["guard_bad"].sum()), warm_err))
    check(warm_err <= 1e-5, "config 5: the warm start's eigenvalues are off the cold ones "
          "by %.3e" % warm_err)
    rows["warm_vs_cold"] = {"cold_ms": cold_ms, "warm_ms": warm_ms,
                            "cold_sweeps": int(ic["sweeps"].max()),
                            "warm_sweeps": int(iw["sweeps"].max())}
    print(json.dumps({"phase": "config5", "card": card, "rows": rows}))
    return {"name": "jacobi_sweep", "path": "config 5: SCF float32 exacteig, 1 x %d^2" % n,
            "route": "cuda", "source": "xitorch_tpu_torch/csrc/jacobi_sweep.cu",
            "replaces": "xitorch_tpu/ops/jacobi_eigh.py:308", "launches": path_sweeps,
            "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": lib_ms}


def deq_phase(torch, np, xt, device, card):
    """The DEQ model at ``benchmarks/bench_deq.py``'s shape (batch 256,
    d_in 64, hidden 256, d_out 8, float32, anderson_acc with the module's
    defaults) trained by ``torch.optim.Adam(lr=1e-3)`` for a few steps, a
    new batch a step: the loss and ms of each step, samples/s and the idle
    share; and the gradient of one step against the float64 run with the
    same settings.  No kernel of this package is on this path."""
    from xitorch_tpu_torch.models import DEQParams, deq_loss, init_deq, train_step

    f32, f64 = torch.float32, torch.float64
    B, d_in, hidden, d_out = DEQ_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_deq(gen, d_in, hidden, d_out, f32, device=device)
    data = [(torch.randn((B, d_in), generator=gen, device=device),
             torch.randn((B, d_out), generator=gen, device=device)) for _ in range(DEQ_STEPS)]

    def grads(dtype):
        ps = DEQParams(*(p.detach().to(dtype).requires_grad_() for p in params))
        x, y = data[0]
        return torch.autograd.grad(deq_loss(ps, x.to(dtype), y.to(dtype)), ps)

    # Anderson stops at f_tol 1e-4 on the joint residual of the (256, 256)
    # state (norm ~1e2): the fixed points differ by ~1e-6 of it, so 1e-4
    g_rel = rel_l2_all(grads(f32), grads(f64))
    opt = torch.optim.Adam(params, lr=1e-3)
    losses, step_ms = [], []
    for x, y in data:
        (_, loss), ms = timed_once(torch, lambda: train_step(params, opt, x, y))
        losses.append(float(loss))
        step_ms.append(ms)
    per = statistics.median(step_ms[1:])
    busy = device_busy_ms(torch, lambda: train_step(params, opt, *data[-1]), calls=1,
                          warmup=False)
    print("DEQ train steps (batch %d, d_in %d, hidden %d, d_out %d, float32, anderson_acc, "
          "Adam lr 1e-3) [%s]: losses %s; ms a step %s (median after the first %.3f: "
          "%.1f samples/s); device busy %.3f ms a step, idle share %.0f%%; gradient of one "
          "step rel L2 to the float64 run %.2e (limit 1e-4)"
          % (B, d_in, hidden, d_out, card, [round(v, 6) for v in losses],
             [round(v, 3) for v in step_ms], per, B / per * 1e3, busy,
             100 * max(0.0, 1 - busy / per), g_rel))
    check(all(math.isfinite(v) for v in losses), "DEQ: a loss is not finite")
    check(g_rel <= 1e-4, "DEQ: gradient off the float64 run by %.3e" % g_rel)
    print(json.dumps({"phase": "deq", "card": card, "losses": losses, "step_ms": step_ms,
                      "samples_per_s": B / per * 1e3, "busy_ms": busy, "grad_rel_l2": g_rel}))


def f_osc(torch, t, y, w):
    """``benchmarks/bench_ivp.py``'s vector field: a damped, driven chain of
    masses, state (x, v) stacked on the second-last dim, stiffness w."""
    x, v = y[..., 0, :], y[..., 1, :]
    lap = 2.0 * x
    lap = lap - torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], -1)
    lap = lap - torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], -1)
    a = -(w[..., None] ** 2) * x - 0.5 * lap - 0.1 * v + torch.sin(t)
    return torch.stack([v, a], dim=-2)


def md_dydt(torch, t, state, masses):
    """``examples/02-molecular-dynamics``'s pairwise gravity on a dict
    state."""
    pos, vel = state["pos"], state["vel"]
    disp = pos[None, :, :] - pos[:, None, :]
    dist3 = ((disp ** 2).sum(-1) + 1e-6) ** 1.5
    acc = (masses[None, :, None] * disp / dist3[..., None]).sum(1)
    return {"pos": vel, "vel": acc}


def osc_dict(torch, t, state, w):
    """:func:`f_osc` on a dict state ``{"x", "v"}``."""
    d = f_osc(torch, t, torch.stack([state["x"], state["v"]], -2), w)
    return {"x": d[..., 0, :], "v": d[..., 1, :]}


def config4(torch, np, xt, device, card):
    """BASELINE config 4 through ``integrate.solve_ivp``:
    ``benchmarks/bench_ivp.py``'s 512 chains of 32 masses, 64 output times
    over 6 s, rk45 at rtol 1e-6, atol 1e-8, float32, through
    ``torch.func.vmap`` (a step size a trajectory); the smallest power-of-two
    step budget at which every trajectory converges, the bench's accuracy
    gate against a tighter integration of trajectory 0, trajectories/s and
    the idle share.  Then ``examples/02-molecular-dynamics``'s problem (4
    bodies, dict state, 20 times over 2 s, rk45 at atol 1e-8, rtol 1e-7):
    the float64 gradient of its loss to v0 by autodiff and by backsolve,
    each against the JAX package's by the same adjoint, with the gradient
    through one of the bench's chains as a dict state by both adjoints, in
    float32 and float64, held against float64 autodiff; and the neural
    ODE's forward and gradient at batch 256, hidden 64, d_in 16, d_out 4
    against float64.  No kernel of this package is on this path."""
    from xitorch_tpu_torch.models import NODEParams, init_node, node_forward, node_loss

    solve_ivp = xt.integrate.solve_ivp
    f32, f64 = torch.float32, torch.float64
    rows = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    ws = 1.0 + torch.rand((IVP_B,), generator=gen, device=device)
    ts = torch.linspace(0.0, 6.0, IVP_NT, device=device)
    y0 = torch.stack([torch.ones(IVP_B, IVP_M, device=device),
                      torch.zeros(IVP_B, IVP_M, device=device)], dim=-2)

    def osc(t, y, w):
        return f_osc(torch, t, y, w)

    def batched(max_steps):
        return torch.func.vmap(lambda y, w: solve_ivp(
            osc, ts, y, params=(w,), method="rk45", rtol=1e-6, atol=1e-8,
            max_steps=max_steps, return_info=True))(y0, ws)

    budget = 16
    while True:
        yt, info = batched(budget)
        if bool((info["converged"] == 1).all()):
            break
        check(budget < 4096, "config 4: trajectories unconverged at a budget of 4096")
        budget *= 2
    ref0 = solve_ivp(osc, ts, y0[0], params=(ws[0],), method="rk45", rtol=1e-8, atol=1e-10)
    err = float((yt[0] - ref0).abs().max())
    ms = timed_ms(torch, lambda: batched(budget), reps=REPS, inner=1)
    busy = device_busy_ms(torch, lambda: batched(budget), calls=1, warmup=False)
    slots = info["iterations"] + info["rejected"]
    print("config 4, solve_ivp rk45 under torch.func.vmap (%d chains of %d masses, %d output "
          "times over 6 s, rtol 1e-6, atol 1e-8, float32) [%s]: every trajectory converged at "
          "a budget of max_steps = %d (the smallest power of two from 16); accepted steps "
          "%d..%d, rejected %d..%d; max error of trajectory 0 against rtol 1e-8 %.2e (gate "
          "1e-3); %.3f ms a call (median of %d), %.1f trajectories/s; device busy %.3f ms, "
          "idle share %.0f%%"
          % (IVP_B, IVP_M, IVP_NT, card, budget, int(info["iterations"].min()),
             int(info["iterations"].max()), int(info["rejected"].min()),
             int(info["rejected"].max()), err, ms, REPS, IVP_B / ms * 1e3, busy,
             100 * max(0.0, 1 - busy / ms)))
    check(err < 1e-3, "config 4: rk45 accuracy gate failed: %.3e" % err)
    rows["bench_ivp"] = {"max_steps": budget, "max_slots": int(slots.max()), "err": err,
                         "ms": ms, "trajectories_per_s": IVP_B / ms * 1e3, "busy_ms": busy}

    # ---- the gradient through one chain, dict state, both adjoints ----
    def chain_grad(dtype, adjoint):
        w = ws[0].to(dtype).requires_grad_()
        x0, v0 = (y0[0, k].to(dtype).requires_grad_() for k in (0, 1))
        yt = solve_ivp(lambda t, s, w: osc_dict(torch, t, s, w), ts.to(dtype),
                       {"x": x0, "v": v0}, params=(w,), method="rk45", rtol=1e-6,
                       atol=1e-8, adjoint=adjoint)
        return torch.autograd.grad((yt["x"] ** 2).mean(), (w, x0, v0))

    chain_ref = chain_grad(f64, "autodiff")
    chain = {}
    for dtype, adjoint in ((f64, "backsolve"), (f32, "autodiff"), (f32, "backsolve")):
        g, g_ms = timed_once(torch, lambda: chain_grad(dtype, adjoint))
        chain["%s %s" % (str(dtype)[6:], adjoint)] = (rel_l2_all(g, chain_ref), g_ms)
    print("config 4, the gradient of mean(x^2) over trajectory 0's 64 times to (w, x0, v0), "
          "dict state {x, v}, rtol 1e-6, atol 1e-8 [%s]: rel L2 to the float64 autodiff run "
          "%s (limit 1e-3: the step control's rtol over 63 intervals)"
          % (card, "; ".join("%s %.2e (%.1f ms)" % (k, *v) for k, v in chain.items())))
    check(all(v[0] <= 1e-3 for v in chain.values()),
          "config 4: chain gradients off the float64 run: %s" % chain)
    rows["chain_grad"] = {k: v[0] for k, v in chain.items()}

    # ---- examples/02-molecular-dynamics: the gradient to v0 at rest ----
    pos0 = torch.tensor(EXAMPLE_POS0, dtype=f64, device=device)
    target = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], dtype=f64,
                          device=device)

    def md_grad(adjoint):
        v0 = torch.zeros((4, 2), dtype=f64, device=device, requires_grad=True)
        yt = solve_ivp(lambda t, s, m: md_dydt(torch, t, s, m),
                       torch.linspace(0.0, 2.0, 20, dtype=f64, device=device),
                       {"pos": pos0, "vel": v0},
                       params=(torch.ones(4, dtype=f64, device=device),), method="rk45",
                       atol=1e-8, rtol=1e-7, adjoint=adjoint)
        loss = ((yt["pos"][-1] - target) ** 2).mean()
        return loss.detach(), torch.autograd.grad(loss, v0)

    # float64 only: the example's rtol 1e-7 lies below float32's eps, and
    # through the encounter its float32 gradient is not the problem's in
    # either package (tests/test_torch_integrate.py, ROADMAP.md queue 3).
    # Each adjoint is held against the JAX package's float64 gradient by the
    # same adjoint (EXAMPLE_GRAD): the card's reductions run in another
    # order, which the encounter amplifies (the two packages differ by ~2e-7
    # on the CPU), so 1e-5 in L2.  The two adjoints differ by ~0.5 at these
    # tolerances: each carries its own discretisation error through the
    # encounter (the gap closes as rtol tightens, in the same test file)
    md = {}
    for adjoint in ("autodiff", "backsolve"):
        (loss, g), g_ms = timed_once(torch, lambda: md_grad(adjoint))
        md[adjoint] = (float(loss), g[0], g_ms)
    held = {k: rel_l2_all((v[1],), (torch.tensor(EXAMPLE_GRAD[k], dtype=f64, device=device),))
            for k, v in md.items()}
    gap = rel_l2_all((md["backsolve"][1],), (md["autodiff"][1],))
    jax_gap = rel_l2_all(*((torch.tensor(EXAMPLE_GRAD[k], dtype=f64),)
                           for k in ("backsolve", "autodiff")))
    print("examples/02 (4 bodies at the example's start, at rest, dict state, 20 times over "
          "2 s, rk45 atol 1e-8 rtol 1e-7, float64) [%s]: loss %.6f; the gradient to v0 rel L2 "
          "to the JAX package's by the same adjoint: %s (limit 1e-5: summation order through "
          "the close encounter); backsolve against autodiff %.4f (JAX's %.4f: the adjoints' "
          "discretisation error at rtol 1e-7)"
          % (card, md["autodiff"][0], "; ".join("%s %.2e (%.1f ms)" % (k, held[k], md[k][2])
                                                 for k in md), gap, jax_gap))
    check(all(v <= 1e-5 for v in held.values()),
          "examples/02: a float64 gradient is off the JAX package's: %s" % held)
    rows["md"] = {"held": held, "adjoint_gap": gap}

    # ---- the neural ODE ----
    B, d_in, hidden, d_out = NODE_SHAPE
    params = init_node(gen, d_in, hidden, d_out, f32, device=device)
    x = torch.randn((B, d_in), generator=gen, device=device)
    y = torch.randn((B, d_out), generator=gen, device=device)

    def node_run(dtype):
        ps = NODEParams(*(p.detach().to(dtype).requires_grad_() for p in params))
        out = node_forward(ps, x.to(dtype))
        return out.detach(), torch.autograd.grad(node_loss(ps, x.to(dtype), y.to(dtype)), ps)

    (out32, g32), node_ms = timed_once(torch, lambda: node_run(f32))
    out64, g64 = node_run(f64)
    f_rel, g_rel = rel_l2_all((out32,), (out64,)), rel_l2_all(g32, g64)
    print("neural ODE (batch %d, d_in %d, hidden %d, d_out %d, rk45 atol 1e-6 rtol 1e-5, "
          "float32) [%s]: forward rel L2 to float64 %.2e, gradient of node_loss %.2e (limits "
          "1e-4: the step control's rtol 1e-5); forward + loss gradient %.3f ms"
          % (B, d_in, hidden, d_out, card, f_rel, g_rel, node_ms))
    check(f_rel <= 1e-4 and g_rel <= 1e-4, "neural ODE: off float64 (%.3e, %.3e)"
          % (f_rel, g_rel))
    rows["node"] = {"fwd_rel": f_rel, "grad_rel": g_rel, "ms": node_ms}
    print(json.dumps({"phase": "config4", "card": card, "rows": rows}))


def quad_mcquad(torch, np, xt, device, card):
    """``integrate.quad`` (leggauss and tanhsinh) of a batched integrand
    against its closed form, and ``mcquad(method="mh")`` of a Gaussian mean
    within 5 standard errors of the chains, on the card."""
    from xitorch_tpu_torch._impls.integrate.mcmc import mh

    f64 = torch.float64
    w = torch.linspace(0.5, 4.0, 64, dtype=f64, device=device)
    exact = 0.5 * torch.sqrt(math.pi / w) * torch.special.erf(3.0 * torch.sqrt(w))
    errs = {}
    for method in ("leggauss", "tanhsinh"):
        val = xt.integrate.quad(lambda x, w: torch.exp(-w * x * x), 0.0, 3.0, params=(w,),
                                method=method)
        errs[method] = float(((val - exact).abs() / exact).max())
    mu = torch.tensor([0.5, -0.2, 1.0, 0.0], device=device)

    def logp(x, mu):
        return -0.5 * ((x - mu) ** 2).sum()

    opts = dict(nsamples=64 * 1000, nburnout=500, step_size=0.8)
    ev = xt.integrate.mcquad(lambda x: x, logp, torch.zeros(4, device=device), pparams=(mu,),
                             method="mh", **opts)
    xs, _ = mh(logp, torch.zeros(4, device=device), (mu,), **opts)
    cmeans = xs.reshape(64, -1, 4).mean(1)
    se = cmeans.std(0) / math.sqrt(64)
    z = float(((ev - mu).abs() / se).max())
    print("quad of exp(-w x^2) over [0, 3], 64 values of w, float64 [%s]: max rel error to "
          "the closed form leggauss %.2e, tanhsinh %.2e; mcquad mh of a 4-d Gaussian's mean "
          "(64 chains x 1000, float32): %s against %s, worst %.2f standard errors of the "
          "chain means (limit 5)"
          % (card, errs["leggauss"], errs["tanhsinh"], [round(float(v), 4) for v in ev],
             mu.tolist(), z))
    check(max(errs.values()) <= 1e-10, "quad off its closed form: %s" % errs)
    check(z <= 5.0, "mcquad mh: %.2f standard errors off the mean" % z)


def interp_data(np):
    """``benchmarks/bench_quad_interp.py``'s data, as it draws it (float64
    numpy): a jittered-uniform grid of NKNOT knots on [0, 1] (spacing at
    least 0.5 / NKNOT), NCURVE random-walk curves on it, NQ queries."""
    rng = np.random.default_rng(6)
    x = (np.arange(NKNOT) + 0.25 * rng.uniform(-1, 1, NKNOT)) / NKNOT
    x = np.sort(x)
    x[0], x[-1] = 0.0, 1.0
    y = np.cumsum(rng.standard_normal((NCURVE, NKNOT)), axis=-1) / 30.0
    xq = np.linspace(0.001, 0.999, NQ)
    return x, y, xq


def interp_gate(np, out, ref) -> float:
    """The benchmark's gate: the largest absolute error over the first
    GATE_CURVES curves, as a share of max(1, max |ref|)."""
    err = float(np.max(np.abs(np.asarray(out, np.float64)[:GATE_CURVES] - ref)))
    return err / max(1.0, float(np.max(np.abs(ref))))


def interp_squad(torch, np, xt, device, card):
    """``interpolate.Interp1D`` and ``integrate.SQuad`` at
    ``benchmarks/bench_quad_interp.py``'s workload, uncut: 512 curves on
    1,000 shared knots, 2,048 queries, float32, construction plus
    evaluation in each call as the benchmark's body does.

    First the Thomas kernel against its plain version on the system this
    path gives it (the natural spline's (1,000,) diagonals broadcast to
    (512, 1,000), as ``tridiag_solve_kernel`` copies them), in float32
    (config 3's limit) and float64, with its time, bound and the PyTorch
    call for the same function (``torch.linalg.solve`` of the one dense
    spline matrix against the 512 right-hand sides).  Then, counted: (a)
    the natural spline (the Thomas route) forward, and forward plus the
    gradient to y and x; (b) the default not-a-knot (dense); (c) clamped
    (Thomas) with mirror extrapolation at MIRROR_QUERIES; (d) linear and
    pchip; SQuad cspline integrate and cumsum, trapz and simpson integrate,
    forward and gradient to y.  Each is held to the benchmark's gate
    against scipy / numpy in float64 (simpson against the same path in
    float64), the gradients to INTERP_GRAD_TOL relative L2 of the float64
    path, and the Thomas launches to 1 a forward and 2 a gradient, none on
    the dense and SQuad routes.  Times a call, curve-evals/s and
    integrations/s, beside the plain Thomas version for (a) and the dense
    route for (a) and (c), and the device idle share.  Returns the Thomas
    kernel's record at this path's shape, with this path's launches."""
    import scipy.integrate
    from scipy.interpolate import CubicSpline, PchipInterpolator

    from xitorch_tpu_torch._impls.interpolate.interp_1d import spline_tridiag_system
    from xitorch_tpu_torch.ops import tridiag
    from xitorch_tpu_torch.ops.tridiag import thomas_cuda, thomas_plain, tridiag_solve_kernel

    Interp1D, SQuad = xt.interpolate.Interp1D, xt.integrate.SQuad
    f32, f64 = torch.float32, torch.float64
    x_np, y_np, xq_np = interp_data(np)
    xc_np = np.concatenate([xq_np, MIRROR_QUERIES])

    def dev(a, dtype=f32, grad=False):
        return torch.tensor(a, dtype=dtype, device=device, requires_grad=grad)

    x, y, xq, xqc = dev(x_np), dev(y_np), dev(xq_np), dev(xc_np)
    w = dev(np.random.default_rng(SEED).standard_normal((NCURVE, NQ)))
    rows = {}

    # ---- the Thomas kernel at this path's system ----
    th = {}
    for dtype in (f32, f64):
        dl, d, du, r = spline_tridiag_system(x.to(dtype), y.to(dtype), "natural")
        flat = [a.expand(NCURVE, NKNOT).contiguous() for a in (dl, d, du, r)]
        eps = float(torch.finfo(dtype).tiny)
        thomas_cuda.launches = 0
        xk = thomas_cuda(*flat, eps)
        xw = tridiag_solve_kernel(dl, d, du, r)  # the wrapper's own broadcast
        xp = thomas_plain(*flat, eps)
        torch.cuda.synchronize()
        check(thomas_cuda.launches == 2, "thomas: %d launches, expected 2" % thomas_cuda.launches)
        rel = float((xk - xp).abs().max() / xp.abs().max())
        th[dtype] = {"rel": rel, "abs": float((xk - xp).abs().max()),
                     "wrapper_rel": float((xw - xp).abs().max() / xp.abs().max()),
                     "args": (*flat, eps), "system": (dl, d, du, r), "x": xk}
    lim = {f32: 1e-5, f64: 1e-12}
    for dtype, t in th.items():
        print("thomas kernel vs plain at the natural spline's system (K=%d, n=%d, %s, "
              "diagonals broadcast from (n,)): max rel err %.3e (limit %.0e), max abs err "
              "%.3e; through tridiag_solve_kernel's broadcast %.3e"
              % (NCURVE, NKNOT, str(dtype)[6:], t["rel"], lim[dtype], t["abs"],
                 t["wrapper_rel"]))
        check(bool(torch.isfinite(t["x"]).all()) and max(t["rel"], t["wrapper_rel"])
              <= lim[dtype], "thomas kernel at the spline's system (%s): rel %.3e"
              % (dtype, t["rel"]))
    th_args, th_abs = th[f32]["args"], th[f32]["abs"]
    dl, d, du, r = th[f32]["system"]
    # the PyTorch call for the same function: the one dense spline matrix
    # against the 512 right-hand sides
    T_dense = (torch.diag_embed(d) + torch.diag_embed(dl[1:], offset=-1)
               + torch.diag_embed(du[:-1], offset=1))
    rT = r.T.contiguous()
    x_lib = torch.linalg.solve(T_dense, rT).T
    lib_rel = float((th[f32]["x"] - x_lib).abs().max() / x_lib.abs().max())
    check(lib_rel <= 1e-4, "thomas kernel disagrees with torch.linalg.solve of the spline "
          "matrix: rel %.3e" % lib_rel)
    th_ms = timed_ms(torch, lambda: thomas_cuda(*th_args))
    th_dev_ms = kernel_device_ms(torch, lambda: thomas_cuda(*th_args), "thomas_kernel")
    th_plain_ms = timed_ms(torch, lambda: thomas_plain(*th_args), reps=3, inner=1)
    th_lib_ms = timed_ms(torch, lambda: torch.linalg.solve(T_dense, rT), reps=3, inner=3)
    # as row 2's bound: dl, d, du, b read once, x written once; ~8
    # operations a row
    th_bound, th_by = bound(5 * NKNOT * NCURVE * 4, 8.0 * NKNOT * NCURVE)
    print("  thomas kernel at (%d, %d) float32: %.4f ms (events; device time by name %.4f "
          "ms), plain %.3f ms, torch.linalg.solve of the dense (%d, %d) spline matrix "
          "against %d right-hand sides %.3f ms (rel %.2e to the kernel), bound %.4f ms (%s) "
          "[%s]" % (NCURVE, NKNOT, th_ms, th_dev_ms, th_plain_ms, NKNOT, NKNOT, NCURVE,
                    th_lib_ms, lib_rel, th_bound, th_by, card))
    del T_dense, th

    # ---- the references (float64, scipy and numpy) on the first curves ----
    xg, yg = x_np, y_np[:GATE_CURVES]
    mirrored = np.where(xc_np < 0, -xc_np, np.where(xc_np > 1, 2 - xc_np, xc_np))
    refs = {
        "natural": CubicSpline(xg, yg.T, bc_type="natural")(xq_np).T,
        "not-a-knot": CubicSpline(xg, yg.T, bc_type="not-a-knot")(xq_np).T,
        "clamped": CubicSpline(xg, yg.T, bc_type="clamped")(mirrored).T,
        "linear": np.stack([np.interp(xq_np, xg, yy) for yy in yg]),
        "pchip": PchipInterpolator(xg, yg.T)(xq_np).T,
    }
    nat = CubicSpline(xg, yg.T, bc_type="natural")
    sq_refs = {"cspline integrate": nat.integrate(xg[0], xg[-1]),
               "cspline cumsum": nat.antiderivative()(xg).T,
               "trapz integrate": scipy.integrate.trapezoid(yg, xg, axis=-1)}

    # the calls, as a user makes them
    def interp(method, bc_type=None, q=xq, yy=y, xx=x):
        kw = {} if bc_type is None else {"bc_type": bc_type}
        return Interp1D(xx, yy, method=method, **kw)(q)

    calls = {
        "(a) cspline natural": lambda: interp("cspline", "natural"),
        "(b) cspline not-a-knot": lambda: interp("cspline"),
        "(c) cspline clamped": lambda: interp("cspline", "clamped", xqc),
        "(d) linear": lambda: interp("linear"),
        "(d) pchip": lambda: interp("pchip"),
    }
    sq = {m: SQuad(x, method=m) for m in ("cspline", "trapz", "simpson")}
    sq_calls = {
        "cspline integrate": lambda yy=y: sq["cspline"].integrate(yy),
        "cspline cumsum": lambda yy=y: sq["cspline"].cumsum(yy),
        "trapz integrate": lambda yy=y: sq["trapz"].integrate(yy),
        "simpson integrate": lambda yy=y: sq["simpson"].integrate(yy),
    }

    def interp_grads(dtype):
        xx, yy = dev(x_np, dtype, True), dev(y_np, dtype, True)
        out = interp("cspline", "natural", xq.to(dtype), yy, xx)
        return torch.autograd.grad((out * w.to(dtype)).sum(), (xx, yy))

    def squad_grad(dtype, name):
        method, what = name.split()
        yy = dev(y_np, dtype, True)
        s_ = SQuad(dev(x_np, dtype), method=method)
        if what == "integrate":
            loss = (s_.integrate(yy) * w[:, 0].to(dtype)).sum()
        else:
            loss = (s_.cumsum(yy) * w[:, :NKNOT].to(dtype)).sum()
        return torch.autograd.grad(loss, yy)

    # ---- the main path, counted ----
    launches = {}
    thomas_cuda.launches = 0
    outs = {}
    for name, fn in calls.items():
        before = thomas_cuda.launches
        outs[name] = fn()
        torch.cuda.synchronize()
        launches[name] = thomas_cuda.launches - before
    before = thomas_cuda.launches
    g32 = interp_grads(f32)
    torch.cuda.synchronize()
    launches["(a) natural forward + gradient to x, y"] = thomas_cuda.launches - before
    sq_outs, sq_g32 = {}, {}
    before = thomas_cuda.launches
    for name, fn in sq_calls.items():
        sq_outs[name] = fn()
        sq_g32[name] = squad_grad(f32, name)
    torch.cuda.synchronize()
    launches["SQuad"] = thomas_cuda.launches - before
    path_launches = thomas_cuda.launches
    print("interpolate/SQuad thomas launches: %s; %d in all" % (launches, path_launches))
    expect = {"(a) cspline natural": 1, "(b) cspline not-a-knot": 0, "(c) cspline clamped": 1,
              "(d) linear": 0, "(d) pchip": 0, "(a) natural forward + gradient to x, y": 2,
              "SQuad": 0}
    check(launches == expect, "thomas launches on the interpolation path: %s, expected %s"
          % (launches, expect))

    # ---- the gates ----
    gates = {}
    for name, key in (("(a) cspline natural", "natural"), ("(b) cspline not-a-knot",
                                                           "not-a-knot"),
                      ("(c) cspline clamped", "clamped"), ("(d) linear", "linear"),
                      ("(d) pchip", "pchip")):
        out = outs[name]
        check(tuple(out.shape) == (NCURVE, out.shape[-1]) and bool(torch.isfinite(out).all()),
              "%s: non-finite or misshapen output" % name)
        gates[name] = interp_gate(np, out.cpu(), refs[key])
    for name in ("cspline integrate", "cspline cumsum", "trapz integrate"):
        out = sq_outs[name]
        check(bool(torch.isfinite(out).all()), "SQuad %s: non-finite output" % name)
        gates["SQuad " + name] = interp_gate(np, out.cpu(), sq_refs[name])
    s64 = SQuad(dev(x_np, f64), method="simpson").integrate(dev(y_np, f64))
    gates["SQuad simpson integrate (against float64)"] = interp_gate(
        np, sq_outs["simpson integrate"].cpu(), s64[:GATE_CURVES].cpu().numpy())
    g64 = interp_grads(f64)
    grad_rel = {"(a) natural, to x": rel_l2_all(g32[:1], g64[:1]),
                "(a) natural, to y": rel_l2_all(g32[1:], g64[1:])}
    for name in sq_calls:
        grad_rel["SQuad %s, to y" % name] = rel_l2_all(sq_g32[name], squad_grad(f64, name))
    print("interpolate/SQuad gates [%s]: max abs err over the first %d curves / max(1, "
          "max |ref|) (limit %.0e): %s; float32 gradients' rel L2 to float64 (limit %.0e): %s"
          % (card, GATE_CURVES, INTERP_GATE,
             ", ".join("%s %.2e" % kv for kv in gates.items()), INTERP_GRAD_TOL,
             ", ".join("%s %.2e" % kv for kv in grad_rel.items())))
    check(max(gates.values()) <= INTERP_GATE, "interpolate/SQuad gate: %s" % gates)
    check(max(grad_rel.values()) <= INTERP_GRAD_TOL, "interpolate/SQuad gradients: %s"
          % grad_rel)
    rows["gates"], rows["grad_rel_l2"], rows["launches"] = gates, grad_rel, launches

    # ---- timing, outside the counted run ----
    def plain_thomas(fn):
        """``fn`` with the Thomas kernel's plain version in its place."""
        def run():
            saved = tridiag.thomas_cuda
            tridiag.thomas_cuda = thomas_plain
            try:
                return fn()
            finally:
                tridiag.thomas_cuda = saved
        return run

    def dense(bc_type, q=xq):
        return lambda: Interp1D(x, y, method="cspline", bc_type=bc_type,
                                use_tridiag=False)(q)

    timed = {name: timed_ms(torch, fn, reps=3, inner=3) for name, fn in calls.items()}
    timed["(a) natural forward + gradient to x, y"] = timed_ms(
        torch, lambda: interp_grads(f32), reps=3, inner=3)
    base = {
        "(a) cspline natural": {
            "plain thomas": timed_ms(torch, plain_thomas(calls["(a) cspline natural"]),
                                     reps=3, inner=1),
            "dense route": timed_ms(torch, dense("natural"), reps=3, inner=3)},
        "(a) natural forward + gradient to x, y": {
            "plain thomas": timed_ms(torch, plain_thomas(lambda: interp_grads(f32)),
                                     reps=3, inner=1)},
        "(c) cspline clamped": {"dense route": timed_ms(torch, dense("clamped", xqc),
                                                         reps=3, inner=3)},
    }
    for name, fn in sq_calls.items():
        timed["SQuad " + name] = timed_ms(torch, fn, reps=3, inner=10)
        timed["SQuad %s + gradient to y" % name] = timed_ms(
            torch, lambda name=name: squad_grad(f32, name), reps=3, inner=3)
    busy = {}
    thomas = ("thomas_kernel",)
    for name, fn, expect in (
            ("(a) cspline natural", calls["(a) cspline natural"], thomas),
            ("(a) natural forward + gradient to x, y", lambda: interp_grads(f32), thomas),
            ("(b) cspline not-a-knot", calls["(b) cspline not-a-knot"], ()),
            ("SQuad cspline integrate", sq_calls["cspline integrate"], ())):
        b_ms = device_busy_ms(torch, fn, calls=3, expect=expect)
        busy[name] = {"busy_ms": b_ms, "idle_share": max(0.0, 1 - b_ms / timed[name])}
    print("interpolate/SQuad timing [%s], median of 3 repetitions, per call (each Interp1D "
          "call builds the spline: its sort check reads one value back from the card):"
          % card)
    for name, ms in timed.items():
        what = "integrations/s" if name.startswith("SQuad") else "curve-evals/s"
        extra = "".join(", %s %.3f ms (%.1f %s)" % (k, v, NCURVE / v * 1e3, what)
                        for k, v in base.get(name, {}).items())
        idle = ("; device busy %.3f ms, idle share %.0f%%"
                % (busy[name]["busy_ms"], 100 * busy[name]["idle_share"])
                if name in busy else "")
        print("  %s: %.3f ms, %.1f %s%s%s" % (name, ms, NCURVE / ms * 1e3, what, extra, idle))
    rows["ms"], rows["baseline_ms"], rows["busy"] = timed, base, busy
    rows["thomas"] = {"ms": th_ms, "device_ms": th_dev_ms, "plain_ms": th_plain_ms,
                      "library_ms": th_lib_ms, "bound_ms": th_bound}
    print(json.dumps({"phase": "interp_squad", "card": card, "rows": rows}))
    return {"name": "thomas", "path": "interpolate: natural/clamped spline, %d x %d, "
            "diagonals broadcast from (%d,)" % (NCURVE, NKNOT, NKNOT),
            "route": "cuda", "source": "xitorch_tpu_torch/csrc/tridiag.cu",
            "replaces": "xitorch_tpu/ops/tridiag.py:38", "launches": path_launches,
            "max_abs_err": th_abs, "ms": th_dev_ms,
            "plain_ms": th_plain_ms, "bound_ms": th_bound, "bound_by": th_by,
            "library_ms": th_lib_ms}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive xitorch_tpu_torch on one card.")
    parser.add_argument("--gate-sizes", default=None,
                        help="comma-separated n: only measure the sweep gate's table there")
    parser.add_argument("--only", choices=("solve", "dc", "dc_level", "sweep", "complex",
                                           "models", "integrate", "interpolate"),
                        default=None,
                        help="solve: build, then run only config 3's phase (config3, "
                             "rows 1 and 2); dc: only config 2's warm start phase "
                             "(config2_warm, row 4); dc_level: only the per-level warm "
                             "start's phase (per_level_warm, row 7); sweep: only config "
                             "2's phase (config2, row 3) and the sweep gate's table; "
                             "complex: only config 2's complex phase (config2_complex, "
                             "row 5) and the sweep gate's table; models: only config 5 "
                             "(config5, row 3 at the SCF's panel) and the DEQ model "
                             "(deq_phase); integrate: only config 4 (config4) and quad/"
                             "mcquad (quad_mcquad); interpolate: only Interp1D and SQuad "
                             "(interp_squad, row 2 at the spline's system); development "
                             "switches")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import xitorch_tpu_torch as xt
    from xitorch_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    print("card: %s" % card)
    # TF32 must never reach a solver contraction
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("torch %s, CUDA %s, %s x%d; allow_tf32=%s, float32_matmul_precision=%s"
          % (torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
             torch.cuda.device_count(), torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision()))

    # ---- 1. build ----
    t_start = t0 = time.perf_counter()
    chain_probe = start_chain_probe() if args.only in (None, "solve") and not args.gate_sizes \
        else None
    libs = _build.build(["structured_cg", "tridiag", "jacobi_sweep", "dc_kernel",
                         "jacobi_sweep_complex", "fused_cg", "dc_level"])
    print("build: %.1f s; %s" % (time.perf_counter() - t0,
                                 ", ".join(os.path.relpath(p, HERE) for p in libs.values())))
    if args.gate_sizes:
        # the table times one call a cell: a small table first loads every
        # library and kernel on the card
        sweep_gate_table(torch, device, card, hold=False, sizes=(64,), batches=(1, 2))
        sweep_gate_table(torch, device, card, hold=False,
                         sizes=tuple(int(v) for v in args.gate_sizes.split(",")))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        return 0
    if args.only == "solve":
        print(json.dumps({"kernels": config3(torch, np, xt, device, card, chain_probe)}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0
    if args.only == "dc_level":
        level_record, _ = per_level_warm(torch, np, xt, device, card)
        print(json.dumps({"kernels": [level_record]}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0
    if args.only == "sweep":
        jacobi_record, _ = config2(torch, np, xt, device, card)
        sweep_gate_table(torch, device, card)
        print(json.dumps({"kernels": [jacobi_record]}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0
    if args.only == "complex":
        complex_record = config2_complex(torch, np, xt, device, card,
                                         {"rng": config2_rng(np)})
        sweep_gate_table(torch, device, card)
        print(json.dumps({"kernels": [complex_record]}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0
    if args.only == "models":
        scf_record = config5(torch, np, xt, device, card)
        deq_phase(torch, np, xt, device, card)
        print(json.dumps({"kernels": [scf_record]}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0
    if args.only == "integrate":
        config4(torch, np, xt, device, card)
        quad_mcquad(torch, np, xt, device, card)
        # no kernel of this package is on these paths
        print(json.dumps({"kernels": []}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0
    if args.only == "interpolate":
        print(json.dumps({"kernels": [interp_squad(torch, np, xt, device, card)]}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0
    if args.only == "dc":
        from xitorch_tpu_torch.ops.jacobi_eigh import jacobi_sweep_cuda

        _, mats, mats_np, panel, tol = config2_batch(torch, np, device)
        shared = {"mats": mats, "mats_np": mats_np, "panel": panel, "tol": tol,
                  "cold_kernel_ms": timed_ms(torch, lambda: jacobi_sweep_cuda(panel, 18, tol),
                                             inner=3)}
        dc_record, _ = config2_warm(torch, np, xt, device, card, shared)
        print(json.dumps({"kernels": [dc_record]}))
        print("total: %.1f s" % (time.perf_counter() - t_start))
        print_device(torch)
        return 0

    last = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print("phase %s: %.1f s" % (phase, now - last[0]))
        last[0] = now

    # ---- 2-6. BASELINE config 3: the structured CG and Thomas kernels ----
    config3_records = config3(torch, np, xt, device, card, chain_probe)
    lap("config 3")

    # ---- 7. BASELINE config 2: the Jacobi sweep kernel, symeig and svd ----
    jacobi_record, shared = config2(torch, np, xt, device, card)

    lap("config 2")

    # ---- 8. the default routing outside the sweep kernel's window ----
    routing_outside_window(torch, np, xt, device, card)

    lap("routing outside the window")

    # ---- 9. config 2 with the warm start: the DC kernel ----
    dc_record, warm_sweeps = config2_warm(torch, np, xt, device, card, shared)
    jacobi_record["launches"] += warm_sweeps

    lap("warm start")

    # ---- 10. the per-level DC kernel on the warm path past a padded n of 448 ----
    level_record, level_sweeps = per_level_warm(torch, np, xt, device, card)
    jacobi_record["launches"] += level_sweeps

    lap("per-level warm start")

    # ---- 11. config 2 with complex input: the complex sweep kernel ----
    complex_record = config2_complex(torch, np, xt, device, card, shared)

    lap("complex")

    # ---- 12. the sweep kernels against the library by batch: the gate ----
    sweep_gate_table(torch, device, card)

    lap("gate table")

    # ---- 13. dense operators: the fused dense CG kernel and path A ----
    fused_record, batched = fused_cg_kernel_phase(torch, np, xt, device, card)
    fused_record["launches"] = path_a(torch, np, xt, device, card, batched)
    check(fused_record["launches"] >= 1, "path A did not launch the fused_cg kernel")
    del batched

    lap("path A")

    # ---- 14. Kron operators: path B (the factor decompositions go through
    # the real sweep kernel where the gate approves) ----
    jacobi_record["launches"] += path_b(torch, np, xt, device, card)

    lap("path B")

    # ---- 15. BASELINE config 1: optimize (no kernel on this path) ----
    config1(torch, np, xt, device, card)
    lap("config 1")

    # ---- 16. BASELINE config 5 (SCF: the float32 run decomposes through
    # the real sweep kernel) and the DEQ model ----
    scf_record = config5(torch, np, xt, device, card)
    lap("config 5")
    deq_phase(torch, np, xt, device, card)
    lap("DEQ")

    # ---- 17. BASELINE config 4 (solve_ivp), the molecular-dynamics example
    # and the neural ODE; quad and mcquad (no kernel on these paths) ----
    config4(torch, np, xt, device, card)
    lap("config 4")
    quad_mcquad(torch, np, xt, device, card)
    lap("quad and mcquad")

    # ---- 18. interpolate and SQuad (the natural and clamped splines solve
    # through the Thomas kernel) ----
    interp_record = interp_squad(torch, np, xt, device, card)
    lap("interpolate and SQuad")

    print(json.dumps({"kernels": [
        *config3_records,
        jacobi_record, dc_record, complex_record, fused_record, level_record, scf_record,
        interp_record,
    ]}))
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print_device(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
