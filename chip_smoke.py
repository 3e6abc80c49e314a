#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xitorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the main paths from ``xitorch_tpu_torch/csrc``
with ``nvcc`` (one compiler process per source, all started together),
holds each kernel against its plain PyTorch version at the shapes the main
paths give it, and drives two configurations through the public API:

* BASELINE config 3: a batch of 512 ``TridiagLowRankOperator`` systems,
  n = 1024, rank 4, float32, solved by
  ``linalg.solve(method="structured_cg")``, forward and implicit gradient
  (the structured-CG and Thomas kernels);
* BASELINE config 2: 64 dense symmetric matrices of 256 x 256, float32,
  ``linalg.symeig(A, 8, "lowest")`` by exacteig, davidson, chebfsi and
  the default routing, ``linalg.svd`` of 64 general matrices, and the
  gradient to the dense A (the one-sided Jacobi sweep kernel).

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
"""
from __future__ import annotations

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed_ms(torch, fn, reps: int = REPS, inner: int = INNER) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls of ``fn()``, per call, after one warm-up call."""
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


def device_busy_ms(torch, fn, calls: int = REPS, top: int = 0):
    """Summed device time of the kernels ``fn()`` launches, per call, from
    ``torch.profiler`` over ``calls`` calls after one warm-up call.  Only
    events on the card count (the profiler also files module loading under
    device time).  With ``top``, also the ``top`` largest entries as
    ``(name, ms per call)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    check(busy_us > 0, "the profiler saw no device time")
    if not top:
        return busy_us / calls / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    return busy_us / calls / 1e3, [(e.key, e.self_device_time_total / calls / 1e3)
                                   for e in events[:top]]


def bound(nbytes: float, flops: float):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate, and which it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def config3_arrays(np, rng):
    """bench.py's config-3 operator recipe, drawn with numpy."""
    d = 4.0 + 2.0 * rng.uniform(size=(BATCH, N))
    V = rng.standard_normal((BATCH, N, RANK)) / math.sqrt(N)
    b = rng.standard_normal((BATCH, N, 1))
    return d, V, b


def sweep_checks(torch, name, P, Gk, Gp, sk, sp, gk, tol, spectrum):
    """Hold the sweep kernel's output ``Gk`` against the plain version's
    ``Gp`` on the panel ``P`` (neither promises a row order, so everything
    compared is invariant under one).  ``spectrum``: the float64 row norms
    expected at convergence, ascending.  Returns the max abs difference of
    the sorted row norms."""
    from xitorch_tpu_torch.ops.jacobi_eigh import _max_cos2

    check(bool(torch.isfinite(Gk).all()), "%s: kernel returned non-finite values" % name)
    tol2 = tol * tol
    gauges = [float(_max_cos2(G).max()) for G in (Gk, Gp)]
    check(max(gauges) <= tol2 and float(gk.max()) <= tol2,
          "%s: gauge above tol^2: kernel %.3e (its own reading %.3e), plain %.3e, "
          "tol^2 %.3e" % (name, gauges[0], float(gk.max()), gauges[1], tol2))
    # the sweep only rotates rows: G^T G keeps the input's
    ref = P.double().mT @ P.double()
    invs = [float(torch.linalg.norm(G.double().mT @ G.double() - ref)
                  / torch.linalg.norm(ref)) for G in (Gk, Gp)]
    nk, npl = (torch.sort(torch.linalg.norm(G.double(), dim=-1), dim=-1).values
               for G in (Gk, Gp))
    scale = float(spectrum.max())
    rel = float((nk - npl).abs().max()) / scale
    dsweeps = int((sk - sp).abs().max())
    spec = float((nk - spectrum).abs().max()) / scale
    print("%s kernel vs plain: gauge %.2e / %.2e (tol^2 %.2e), G-invariant %.2e / "
          "%.2e, sorted row norms rel diff %.2e, vs float64 spectrum %.2e, sweeps "
          "%d..%d (mean %.2f, max |diff| %d)"
          % (name, gauges[0], gauges[1], tol2, invs[0], invs[1], rel, spec,
             int(sk.min()), int(sk.max()), float(sk.float().mean()), dsweeps))
    # float32 rounding of ~n rotations per row and sweep
    check(max(invs) <= 1e-5, "%s: G-invariant broken: %s" % (name, invs))
    # sums in another order; both left on a measured gauge
    check(rel <= 1e-5, "%s: row norms disagree with plain: %.3e" % (name, rel))
    check(dsweeps <= 1, "%s: sweep counts differ by %d" % (name, dsweeps))
    check(spec <= 1e-4, "%s: row norms off the float64 spectrum: %.3e" % (name, spec))
    return float((nk - npl).abs().max())


def config2(torch, np, xt, device, card):
    """BASELINE config 2 on the card: the Jacobi sweep kernel against its
    plain version, symeig/svd forward and gradient through the public API,
    and timings.  Returns the kernel's record for the JSON line."""
    import warnings

    from xitorch_tpu_torch.ops import jacobi_eigh as jmod
    from xitorch_tpu_torch.ops.jacobi_eigh import (
        jacobi_eigh, jacobi_svd, jacobi_sweep_cuda, jacobi_sweep_plain,
    )
    from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning

    rng = np.random.default_rng(SEED)
    f32 = torch.float32

    def dev(a, dtype=f32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    # bench_symeig.py's recipes, drawn with numpy: an SPD batch and a
    # general batch
    a_np = rng.standard_normal((B2, N2, N2)) / math.sqrt(N2)
    mats_np = a_np @ a_np.transpose(0, 2, 1) + 2.0 * np.eye(N2)
    gmats_np = rng.standard_normal((B2, N2, N2)) / math.sqrt(N2)
    mats, gmats = dev(mats_np), dev(gmats_np)
    mats_np, gmats_np = mats.double().cpu().numpy(), gmats.double().cpu().numpy()
    tol = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(N2)
    max_sweeps = 18

    # ---- kernel vs plain at the config-2 panel and one rectangular panel ----
    # the panel jacobi_eigh hands the kernel: the Gershgorin-shifted input
    absa = mats.abs()
    diag = torch.diagonal(mats, dim1=-2, dim2=-1)
    lower = (diag - (absa.sum(-1) - diag.abs())).amin(-1)
    sigma = torch.clamp(-lower, min=0.0) + 0.01 * torch.linalg.norm(mats, dim=(-2, -1))
    panel = (mats + sigma[:, None, None] * torch.eye(N2, device=device)).contiguous()
    Gk, sk, gk, rk = jacobi_sweep_cuda(panel, max_sweeps, tol, return_stats=True)
    Gp, sp = jacobi_sweep_plain(panel, max_sweeps, tol)
    torch.cuda.synchronize()
    spectrum = torch.linalg.eigvalsh(panel.double())
    sq_err = sweep_checks(torch, "jacobi_sweep (%d, %d, %d)" % (B2, N2, N2), panel, Gk,
                          Gp, sk, sp, gk, tol, spectrum)
    # rows = the first 128 columns of the general batch: Hestenes' SVD
    rect = gmats[:, :, :N2 // 2].mT.contiguous()
    tol_r = float(torch.finfo(f32).eps) * 4.0 * math.sqrt(N2 // 2)
    Rk, rsk, rgk, _ = jacobi_sweep_cuda(rect, max_sweeps, tol_r, return_stats=True)
    Rp, rsp = jacobi_sweep_plain(rect, max_sweeps, tol_r)
    torch.cuda.synchronize()
    sweep_checks(torch, "jacobi_sweep (%d, %d, %d)" % (B2, N2 // 2, N2), rect, Rk, Rp,
                 rsk, rsp, rgk, tol_r,
                 torch.linalg.svdvals(rect.double()).flip(-1))

    counts = {"fwd": 0, "svd": 0, "grad": 0}

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
        ev, X = xt.linalg.symeig(A, NEIG, "lowest")
    from xitorch_tpu_torch.linalg.symeig import _auto_symeig_method
    err, colres, orth = quality(ev, X)
    print("config 2 default routing (%s): evals rel err %.2e, residual/|A| %.2e, "
          "warnings: %s" % (_auto_symeig_method(A, NEIG, None), err, colres,
                            [w.category.__name__ for w in caught]))
    check(_auto_symeig_method(A, NEIG, None) == "chebfsi", "default routing is not chebfsi")
    check(all(issubclass(w.category, ConvergenceWarning) for w in caught),
          "default routing raised another warning than non-convergence")
    # the scale-aware residual target sqrt(eps)*||A|| bounds the value error
    check(err <= 1e-3, "default routing: evals off by %.3e" % err)

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
        _, sv_d, _ = xt.linalg.svd(G, NEIG)   # top-k: Gram + default symeig
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
    jmod.jacobi_sweep_cuda = lambda p, ms, t: jacobi_sweep_plain(p, ms, t)
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
    def once(fn, reps=3):
        return timed_ms(torch, fn, reps=reps, inner=1)

    k_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(panel, max_sweeps, tol), inner=3)
    gauge_ms = timed_ms(torch, lambda: jacobi_sweep_cuda(panel, 0, tol), inner=3)
    copy_ms = timed_ms(torch, lambda: panel.clone(), inner=3)
    plain_ms = once(lambda: jacobi_sweep_plain(panel, max_sweeps, tol), reps=2)
    lib_eigh_panel_ms = once(lambda: torch.linalg.eigh(panel))
    je_ms = timed_ms(torch, lambda: jacobi_eigh(mats), inner=3)
    eigh_ms = once(lambda: torch.linalg.eigh(mats))
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
    exact_busy, exact_top = device_busy_ms(torch, lambda: fwd("exacteig"), top=4)
    cheb_busy, cheb_top = device_busy_ms(
        torch, lambda: fwd("chebfsi", **CHEBFSI_OPTS), top=4)

    # the kernel's bound on this run's data: the panel read once and written
    # once; per matrix the pair dots of every round played (2 width
    # operations each), the rotations that were applied (8 width), and one
    # gauge (upper triangle) and norm refresh before the first sweep and
    # after each
    rounds = -(-(N2 - 1) // 6) * 6
    sweeps_total, rot_total = float(sk.sum()), float(rk.sum())
    flops = (sweeps_total * rounds * (N2 // 2) * 2 * N2 + rot_total * 8 * N2
             + (sweeps_total + B2) * (N2 * (N2 - 1) // 2 + N2) * 2 * N2)
    k_bound, k_by = bound(2 * B2 * N2 * N2 * 4, flops)
    gauge_share = (gauge_ms - copy_ms) * (sweeps_total / B2 + 1) / k_ms

    def rate(ms):
        return B2 / ms * 1e3

    print("timing, config 2 [%s], CUDA events after warm-up (median):" % card)
    print("  jacobi_sweep kernel %.3f ms, plain %.3f ms, bound %.4f ms (%s), "
          "torch.linalg.eigh of the same panel %.3f ms; mean sweeps per matrix %.2f, "
          "rotations applied %.0f of %.0f pair visits (B=%d, n=%d) [%s]"
          % (k_ms, plain_ms, k_bound, k_by, lib_eigh_panel_ms, sweeps_total / B2,
             rot_total, sweeps_total * rounds * (N2 // 2), B2, N2, card))
    print("  gauge + norm refresh alone (max_sweeps=0, panel copy of %.3f ms taken "
          "off) %.3f ms a time: %.0f%% of the kernel's time [%s]"
          % (copy_ms, gauge_ms - copy_ms, 100 * gauge_share, card))
    print("  jacobi_eigh %.3f ms vs torch.linalg.eigh %.3f ms; jacobi_svd %.3f ms vs "
          "torch.linalg.svd %.3f ms (%d x %d x %d) [%s]"
          % (je_ms, eigh_ms, js_ms, svd_ms, B2, N2, N2, card))
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

    return {"name": "jacobi_sweep", "route": "cuda",
            "source": "xitorch_tpu_torch/csrc/jacobi_sweep.cu",
            "replaces": "xitorch_tpu/ops/jacobi_eigh.py:308",
            "launches": sum(counts.values()), "max_abs_err": sq_err,
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": lib_eigh_panel_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import xitorch_tpu_torch as xt
    from xitorch_tpu_torch.ops import _build
    from xitorch_tpu_torch.ops.structured_cg import (
        structured_cg_cuda, structured_cg_plain,
    )
    from xitorch_tpu_torch.ops.tridiag import thomas_cuda, thomas_plain

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
    t0 = time.perf_counter()
    libs = _build.build(["structured_cg", "tridiag", "jacobi_sweep"])
    print("build: %.1f s; %s" % (time.perf_counter() - t0,
                                 ", ".join(os.path.relpath(p, HERE) for p in libs.values())))

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
    xp, itp, _ = structured_cg_plain(*cg_args, **cg_kw)
    torch.cuda.synchronize()

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

    # ---- 3. kernel vs plain: Thomas at config-3 shapes ----
    # diagonally dominant (|dl| + |du| <= 1 < d): no pivot comes near zero
    dlp = dev(rng.uniform(-0.5, 0.5, size=(N, BATCH)))
    dp = dev(4.0 + 2.0 * rng.uniform(size=(N, BATCH)))
    dup = dev(rng.uniform(-0.5, 0.5, size=(N, BATCH)))
    bp = dev(rng.standard_normal((N, BATCH)))
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
    cg_ms = timed_ms(torch, lambda: structured_cg_cuda(*cg_args, **cg_kw))
    cg_plain_ms = timed_ms(torch, lambda: structured_cg_plain(*cg_args, **cg_kw))
    th_ms = timed_ms(torch, lambda: thomas_cuda(*th_args))
    th_plain_ms = timed_ms(torch, lambda: thomas_plain(*th_args))
    fwd_ms = timed_ms(torch, lambda: xt.linalg.solve(A, bT, method="structured_cg",
                                                     rtol=RTOL, atol=ATOL))
    fwd_plain_ms = timed_ms(torch, lambda: xt.linalg.solve(
        A, bT, method=plain_structured_cg, rtol=RTOL, atol=ATOL))
    grad_ms = timed_ms(torch, lambda: grads("structured_cg"))
    grad_plain_ms = timed_ms(torch, lambda: grads(plain_structured_cg))
    fwd_busy = device_busy_ms(torch, lambda: xt.linalg.solve(
        A, bT, method="structured_cg", rtol=RTOL, atol=ATOL))
    grad_busy = device_busy_ms(torch, lambda: grads("structured_cg"))
    print("timing [%s], median of %d repetitions of %d calls after warm-up:"
          % (card, REPS, INNER))
    print("  structured_cg kernel %.3f ms, plain %.3f ms (K=%d, n=%d, r=%d) [%s]"
          % (cg_ms, cg_plain_ms, BATCH, N, RANK, card))
    print("  thomas kernel %.3f ms, plain %.3f ms (K=%d, n=%d) [%s]"
          % (th_ms, th_plain_ms, BATCH, N, card))
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

    # ---- 7. BASELINE config 2: the Jacobi sweep kernel, symeig and svd ----
    jacobi_record = config2(torch, np, xt, device, card)

    print(json.dumps({"kernels": [
        {"name": "structured_cg", "route": "cuda",
         "source": "xitorch_tpu_torch/csrc/structured_cg.cu",
         "replaces": "xitorch_tpu/ops/structured_cg.py:58",
         "launches": launches["structured_cg"], "max_abs_err": cg_abs,
         "ms": cg_ms, "plain_ms": cg_plain_ms, "bound_ms": cg_bound,
         "bound_by": cg_by, "library_ms": None},
        {"name": "thomas", "route": "cuda",
         "source": "xitorch_tpu_torch/csrc/tridiag.cu",
         "replaces": "xitorch_tpu/ops/tridiag.py:38",
         "launches": launches["thomas"], "max_abs_err": th_abs,
         "ms": th_ms, "plain_ms": th_plain_ms, "bound_ms": th_bound,
         "bound_by": th_by, "library_ms": None},
        jacobi_record,
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
