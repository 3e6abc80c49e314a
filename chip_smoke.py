#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xitorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the main path from ``xitorch_tpu_torch/csrc``
with ``nvcc`` (one compiler process per source, all started together),
holds each kernel against its plain PyTorch version at the shapes of
BASELINE config 3, drives config 3 through the public API (a batch of 512
``TridiagLowRankOperator`` systems, n = 1024, rank 4, float32, solved by
``linalg.solve(method="structured_cg")``, forward and implicit gradient),
reads the kernels' launch counters to show that the main path went
through them, and times kernels, forward and gradient with CUDA events.

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


def device_busy_ms(torch, fn, calls: int = REPS) -> float:
    """Summed device time of the kernels ``fn()`` launches, per call, from
    ``torch.profiler`` over ``calls`` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    check(busy_us > 0, "the profiler saw no device time")
    return busy_us / calls / 1e3


def config3_arrays(np, rng):
    """bench.py's config-3 operator recipe, drawn with numpy."""
    d = 4.0 + 2.0 * rng.uniform(size=(BATCH, N))
    V = rng.standard_normal((BATCH, N, RANK)) / math.sqrt(N)
    b = rng.standard_normal((BATCH, N, 1))
    return d, V, b


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
    libs = _build.build(["structured_cg", "tridiag"])
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

    print(json.dumps({"kernels": [
        {"name": "structured_cg", "route": "cuda",
         "source": "xitorch_tpu_torch/csrc/structured_cg.cu",
         "replaces": "xitorch_tpu/ops/structured_cg.py:58",
         "launches": launches["structured_cg"], "max_abs_err": cg_abs,
         "ms": cg_ms, "plain_ms": cg_plain_ms},
        {"name": "thomas", "route": "cuda",
         "source": "xitorch_tpu_torch/csrc/tridiag.cu",
         "replaces": "xitorch_tpu/ops/tridiag.py:38",
         "launches": launches["thomas"], "max_abs_err": th_abs,
         "ms": th_ms, "plain_ms": th_plain_ms},
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
