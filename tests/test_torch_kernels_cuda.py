"""The port's CUDA kernels against their plain PyTorch versions on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card:
each is marked ``cuda`` and skips without one.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have; this file imports no JAX.)

(``python3 chip_smoke.py`` covers the BASELINE config-3 and config-2
shapes; these cases cover odd sizes, several bands, other ranks, float64
Thomas, the real Jacobi sweep kernel on every cluster size its chooser
picks and on its device-memory path, the complex one likewise and on
forced cluster sizes, the divide-and-conquer kernel with its exports, the per-level
divide-and-conquer kernel one level at a time, the sweep gate by batch, and
the fused dense CG kernel's cluster path and device-memory path over odd
sizes (n % 4 != 0, n = 1, 33), forced cluster sizes, super-groups, float64
and a broadcast A.)
"""
import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu_torch.ops import (
    structured_cg_cuda, structured_cg_plain, thomas_cuda, thomas_plain,
)
from xitorch_tpu_torch.ops.structured_cg import (
    choose_path, fits_structured_cg, register_window,
)
from xitorch_tpu_torch.ops.fused_cg import fused_cg_cuda, fused_cg_dense, fused_cg_plain
from xitorch_tpu_torch.ops.dc_kernel import (
    dc_precondition, dc_precondition_cuda, dc_precondition_plain,
)
from xitorch_tpu_torch.ops.jacobi_eigh import (
    _guard_warm_start, _max_cos2, jacobi_eigh, jacobi_sweep, jacobi_sweep_cuda,
    jacobi_sweep_plain,
)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cg_flat(offsets, r, K, n, device, seed=0):
    rng = np.random.default_rng(seed)
    nb = len(offsets)
    d = 6.0 + 2.0 * rng.uniform(size=(K, n))
    bl = np.zeros((K, nb, n))
    bu = np.zeros((K, nb, n))
    for k, o in enumerate(offsets):
        c = 0.5 * rng.uniform(size=(K, n - o))
        bl[:, k, o:] = c
        bu[:, k, :n - o] = c
    V = rng.standard_normal((K, r, n)) / np.sqrt(n)
    b = rng.standard_normal((K, n))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (d, bl, bu, V, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", [None, "register", "shared"])
@pytest.mark.parametrize("offsets, r, K, n", [
    ((1,), 1, 3, 33), ((1, 2), 3, 7, 200), ((1,), 4, 64, 1024), ((1, 2, 5), 16, 5, 100),
    ((1,), 8, 2, 3000),
])
def test_cg_kernel_matches_plain(cuda, offsets, r, K, n, path):
    args = (*_cg_flat(offsets, r, K, n, cuda), offsets)
    kw = dict(rtol=1e-6, atol=1e-8, max_niter=min(2 * n, 400))
    chosen = choose_path(n, r, offsets, register_window(r, len(offsets), cuda))
    if path == "register" and chosen != "register":
        # outside the register window a forced register launch raises
        with pytest.raises(RuntimeError):
            structured_cg_cuda(*args, path=path, **kw)
        return
    xk, itk, resk = structured_cg_cuda(*args, path=path, **kw)
    assert structured_cg_cuda.last_design == (path or chosen)
    xp, itp, resp = structured_cg_plain(*args, **kw)
    torch.cuda.synchronize()
    # f32 sums in another order (warp tree vs PyTorch's reduction)
    rel = (torch.linalg.norm(xk - xp, dim=-1) / torch.linalg.norm(xp, dim=-1)).max()
    assert float(rel) <= 1e-4
    # per-system stop on f32 recurrences: a step or two either way
    assert int((itk - itp).abs().max()) <= 2
    bn = torch.linalg.norm(args[4], dim=-1)
    assert bool((resk < 0.5 * 1e-6 * bn).all())


@pytest.mark.cuda
def test_register_window_matches_the_build(cuda):
    """Every register design launches at the largest n of its window (the
    window read from the build), and that window lies inside the
    shared-memory design's, as fits_structured_cg assumes."""
    for r in (1, 2, 4, 8):
        for nb in (1, 2):
            n = register_window(r, nb, cuda)
            assert n >= 1024 and fits_structured_cg(n, r, torch.float32, nb)
            offsets = tuple(range(1, nb + 1))
            args = (*_cg_flat(offsets, r, 1, n, cuda), offsets)
            x, _, _ = structured_cg_cuda(*args, rtol=1e-6, atol=1e-8, max_niter=2)
            assert structured_cg_cuda.last_design == "register"
            torch.cuda.synchronize()
            assert bool(torch.isfinite(x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("K, n", [(1, 5), (300, 129), (512, 1024), (1, 65536), (4096, 64),
                                  (33, 700)])
def test_thomas_kernel_matches_plain(cuda, dtype, tol, K, n):
    rng = np.random.default_rng(1)
    rows = [rng.uniform(-0.5, 0.5, size=(K, n)), 2.0 + rng.uniform(size=(K, n)),
            rng.uniform(-0.5, 0.5, size=(K, n)), rng.standard_normal((K, n))]
    dl, d, du, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in rows)
    # system 0: pivot d1 - dl1 * du0 / d0 == 1 - 1 * 1 == 0 is replaced by
    # eps; du1 = 0 and b1 = dl1 * x0 keep the solution finite
    d[0, 0], d[0, 1], du[0, 0], dl[0, 1], du[0, 1] = 1.0, 1.0, 1.0, 1.0, 0.0
    b[0, 1] = b[0, 0]
    eps = float(torch.finfo(dtype).tiny)
    xk = thomas_cuda(dl, d, du, b, eps)
    xp = thomas_plain(dl, d, du, b, eps)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xk).all())
    # contracted multiply-adds in the kernel vs separate roundings
    assert float((xk - xp).abs().max() / xp.abs().max()) <= tol


@pytest.mark.cuda
def test_wrappers_and_structured_solve_do_not_synchronise(cuda):
    """The CG and Thomas wrappers and solve(method="structured_cg") without
    return_info put their work on the stream and return: under
    set_sync_debug_mode("error") any synchronise raises."""
    args = (*_cg_flat((1,), 4, 64, 1024, cuda), (1,))
    kw = dict(rtol=1e-6, atol=1e-8, max_niter=400)
    rng = np.random.default_rng(4)
    panels = [torch.tensor(a, dtype=torch.float32, device=cuda)
              for a in (rng.uniform(-0.5, 0.5, (64, 1024)), 2.0 + rng.uniform(size=(64, 1024)),
                        rng.uniform(-0.5, 0.5, (64, 1024)), rng.standard_normal((64, 1024)))]
    d = torch.tensor(4.0 + 2.0 * rng.uniform(size=(16, 1024)), dtype=torch.float32, device=cuda)
    V = torch.tensor(rng.standard_normal((16, 1024, 4)) / 32.0, dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.standard_normal((16, 1024, 1)), dtype=torch.float32, device=cuda)
    A = xt.TridiagLowRankOperator(d, 1.0, V)
    for path in ("register", "shared"):   # build and load outside the checked region
        structured_cg_cuda(*args, path=path, **kw)
    thomas_cuda(*panels, 1e-38)
    xt.linalg.solve(A, b, method="structured_cg")
    xt.linalg.flush_convergence_warnings()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for path in ("register", "shared"):
            structured_cg_cuda(*args, path=path, **kw)
        thomas_cuda(*panels, 1e-38)
        x = xt.linalg.solve(A, b, method="structured_cg")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    xt.linalg.flush_convergence_warnings()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_unconverged_solve_on_card_warns(cuda):
    """A structured_cg solve that stops short (max_niter=1) returns before
    its eager check is read, and warns at flush_convergence_warnings();
    another method's check warns before the solve returns."""
    from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning

    rng = np.random.default_rng(6)
    d = torch.tensor(4.0 + 2.0 * rng.uniform(size=(16, 1024)), dtype=torch.float32, device=cuda)
    V = torch.tensor(rng.standard_normal((16, 1024, 4)) / 32.0, dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.standard_normal((16, 1024, 1)), dtype=torch.float32, device=cuda)
    A = xt.TridiagLowRankOperator(d, 1.0, V)
    xt.linalg.flush_convergence_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xt.linalg.solve(A, b, method="structured_cg", max_niter=1)
        assert not caught
        xt.linalg.flush_convergence_warnings()
    assert [w.category for w in caught] == [ConvergenceWarning]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xt.linalg.solve(A, b, method="cg", max_niter=1)
    assert any(issubclass(w.category, ConvergenceWarning) for w in caught)


@pytest.mark.cuda
def test_solve_on_card_goes_through_both_kernels(cuda):
    rng = np.random.default_rng(2)
    d = torch.tensor(4.0 + 2.0 * rng.uniform(size=(8, 256)), dtype=torch.float32, device=cuda)
    V = torch.tensor(rng.standard_normal((8, 256, 4)) / 16.0, dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.standard_normal((8, 256, 2)), dtype=torch.float32, device=cuda)
    E = torch.tensor([-1.0, -0.5], device=cuda)
    structured_cg_cuda.launches = thomas_cuda.launches = 0
    A = xt.TridiagLowRankOperator(d, 1.0, V)
    x, info = xt.linalg.solve(A, b, E=E, method="structured_cg", return_info=True)
    assert structured_cg_cuda.launches == 1 and float(info["converged"]) == 1.0
    _, info2 = xt.linalg.solve(xt.TridiagLowRankOperator(d, 1.0), b, return_info=True)
    assert thomas_cuda.launches == 1 and float(info2["converged"]) == 1.0
    # the same solves on the CPU take the plain versions
    x_cpu = xt.linalg.solve(xt.TridiagLowRankOperator(d.cpu(), 1.0, V.cpu()), b.cpu(),
                            E=E.cpu(), method="structured_cg")
    assert float((x.cpu() - x_cpu).abs().max() / x_cpu.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take(cuda):
    d, bl, bu, V, b = _cg_flat((1,), 2, 2, 16, cuda)
    kw = dict(rtol=1e-6, atol=1e-8, max_niter=10)
    with pytest.raises(RuntimeError):
        structured_cg_cuda(d.cpu(), bl, bu, V, b, (1,), **kw)
    with pytest.raises(RuntimeError):
        structured_cg_cuda(d.double(), bl, bu, V, b, (1,), **kw)
    with pytest.raises(RuntimeError):
        structured_cg_cuda(d, bl, bu, V.transpose(1, 2), b, (1,), **kw)
    with pytest.raises(RuntimeError):
        thomas_cuda(d.t(), d.t(), d.t(), b.t(), 1e-38)  # not contiguous


def _sorted_row_norms(G):
    return torch.sort(torch.linalg.norm(G.double(), dim=-1), dim=-1).values


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, width, smem_limit, cluster", [
    (3, 32, 32, None, 8),        # square, one float4 column a CTA
    (2, 64, 300, None, 8),       # rectangular: 75 float4 columns, slices of 10, the last 5
    (2, 256, 256, None, 8),      # a 256 KB panel grown to 8 CTAs
    (64, 256, 256, None, 2),     # config 2: two 128 KB slices a matrix, 128 CTAs
    (1, 256, 256, None, 8),      # batch 1
    (1, 512, 512, None, 8),      # a 1 MB panel
    (2, 768, 768, None, 16),     # 2.36 MB: the non-portable cluster of 16
    (1, 16, 1000, None, 8),      # wide rows
    (2, 256, 256, 0, 0),         # the device-memory path, forced
    (1, 16, 1000, 0, 0),         # device memory, eight float4 per lane in registers
    (1, 32, 2052, 0, 0),         # device memory, wider than the register cache
])
def test_jacobi_sweep_kernel_matches_plain(cuda, B, n, width, smem_limit, cluster):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((B, n, width))
    if n == width:
        a = a @ a.transpose(0, 2, 1) / np.sqrt(n) + 2.0 * np.eye(n)
    a[-1, 1] = 0.0  # a zero row must stay dead
    P = torch.tensor(a, dtype=torch.float32, device=cuda)
    tol = float(torch.finfo(torch.float32).eps) * 4.0 * np.sqrt(n)
    Gk, sk, gk, rk = jacobi_sweep_cuda(P, 18, tol, return_stats=True, smem_limit=smem_limit)
    assert jacobi_sweep_cuda.last_cluster == cluster
    Gp, sp = jacobi_sweep_plain(P, 18, tol)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Gk).all())
    assert float(Gk[-1, 1].abs().max()) == 0.0  # rows keep their order
    # both left on the gauge, and the kernel's own reading agrees
    assert float(_max_cos2(Gk).max()) <= tol * tol and float(gk.max()) <= tol * tol
    assert float(_max_cos2(Gp).max()) <= tol * tol
    # the sweep only rotates rows: G^T G is invariant
    ref = (P.double().mT @ P.double())
    for name, G in (("kernel", Gk), ("plain", Gp)):
        inv = torch.linalg.norm(G.double().mT @ G.double() - ref) / torch.linalg.norm(ref)
        assert float(inv) <= 1e-5, name
    # f32 sums in another order; the exit is on a measured gauge
    nk, np_ = _sorted_row_norms(Gk), _sorted_row_norms(Gp)
    assert float((nk - np_).abs().max() / np_.max()) <= 1e-5
    assert int((sk - sp).abs().max()) <= 1
    # at most one rotation per pair and round
    rounds = -(-(n - 1) // 6) * 6
    assert bool((rk > 0).all()) and bool((rk <= sk * rounds * (n // 2)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B, cluster", [(3, 8), (40, 2)])
def test_jacobi_sweep_clusters_exit_on_their_own(cuda, B, cluster):
    # one launch: an orthogonal panel (no sweep), random ones, one with a
    # dead zero row; every cluster leaves on its own gauge and none hangs
    n = 256
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = rng.standard_normal((B, n, n)) / np.sqrt(n)
    a = a @ a.transpose(0, 2, 1) + 2.0 * np.eye(n)
    a[0] = q * np.arange(1, n + 1)[:, None]
    a[-1, 5] = 0.0
    P = torch.tensor(a, dtype=torch.float32, device=cuda)
    tol = float(torch.finfo(torch.float32).eps) * 4.0 * np.sqrt(n)
    G, sweeps, gauge, rot = jacobi_sweep_cuda(P, 18, tol, return_stats=True)
    torch.cuda.synchronize()
    assert jacobi_sweep_cuda.last_cluster == cluster
    assert int(sweeps[0]) == 0 and int(rot[0]) == 0 and bool(torch.equal(G[0], P[0]))
    assert bool((sweeps[1:] >= 5).all()) and bool((sweeps <= 18).all())
    assert float(G[-1, 5].abs().max()) == 0.0
    assert bool((gauge <= tol * tol).all()) and float(_max_cos2(G).max()) <= tol * tol
    ref = P.double().mT @ P.double()
    inv = torch.linalg.norm(G.double().mT @ G.double() - ref, dim=(-2, -1)) \
        / torch.linalg.norm(ref, dim=(-2, -1))
    assert float(inv.max()) <= 1e-5
    # max_sweeps = 0 measures the gauge and leaves, on every cluster
    G0, s0, g0, _ = jacobi_sweep_cuda(P, 0, tol, return_stats=True)
    assert bool((s0 == 0).all()) and bool(torch.equal(G0, P))
    assert float(((g0.double() / _max_cos2(P).double())[1:] - 1.0).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_jacobi_sweep_kernel_zero_sweeps_on_orthogonal_panel(cuda):
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    P = torch.tensor(q[None] * np.arange(1, 65)[None, :, None], dtype=torch.float32,
                     device=cuda)
    G, sweeps = jacobi_sweep_cuda(P, 18, 1e-5)
    torch.cuda.synchronize()
    assert int(sweeps[0]) == 0 and bool(torch.equal(G, P))
    # max_sweeps = 0 measures the gauge and leaves
    A = torch.tensor(rng.standard_normal((1, 32, 32)), dtype=torch.float32, device=cuda)
    G0, s0, g0, r0 = jacobi_sweep_cuda(A, 0, 1e-5, return_stats=True)
    assert int(s0[0]) == 0 and int(r0[0]) == 0 and bool(torch.equal(G0, A))
    assert abs(float(g0[0]) / float(_max_cos2(A)[0]) - 1.0) <= 1e-4


@pytest.mark.cuda
def test_jacobi_sweep_rejects_what_it_cannot_take(cuda):
    P = torch.zeros(1, 32, 32, device=cuda)
    for bad in (P.cpu(), P.double(), P[:, :31], P.mT[:, :, :16],
                torch.zeros(1, 1040, 64, device=cuda),      # over the row window
                torch.zeros(1, 16, 4100, device=cuda)):     # over the width window
        with pytest.raises(RuntimeError):
            jacobi_sweep_cuda(bad, 18, 1e-5)
    with pytest.raises(RuntimeError):
        jacobi_sweep(torch.zeros(1, 1040, 64, device=cuda), 18, 1e-5)


@pytest.mark.cuda
def test_symeig_and_svd_on_card_go_through_the_sweep_kernel(cuda):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 96, 96)) / np.sqrt(96)
    mats = a @ a.transpose(0, 2, 1) + 2.0 * np.eye(96)
    x = torch.tensor(mats, dtype=torch.float32, device=cuda, requires_grad=True)
    jacobi_sweep_cuda.launches = 0
    A = xt.LinearOperator.m((x + x.mT) / 2, is_hermitian=True)
    e, X = xt.linalg.symeig(A, 4, "lowest", method="exacteig")
    assert jacobi_sweep_cuda.launches == 1
    e0 = np.linalg.eigvalsh(mats)[:, :4]
    # float32 under the gate of the reference's Jacobi tests
    assert np.abs(e.detach().cpu().numpy() - e0).max() <= 2e-5 * np.abs(e0).max()
    (g,) = torch.autograd.grad(e.sum() + (X @ X.mT).sum(), x)
    assert bool(torch.isfinite(g).all()) and jacobi_sweep_cuda.launches == 1
    # the same on the CPU takes the plain version and agrees
    e_cpu, _ = xt.linalg.symeig(
        xt.LinearOperator.m(torch.tensor(mats, dtype=torch.float32), is_hermitian=True),
        4, "lowest", method="exacteig")
    assert jacobi_sweep_cuda.launches == 1
    assert float((e.detach().cpu() - e_cpu).abs().max()) <= 2e-5 * np.abs(e0).max()
    # svd of a general (96, 80) batch: rectangular panel, rows padded to 80
    gm = torch.tensor(rng.standard_normal((4, 96, 80)), dtype=torch.float32, device=cuda)
    _, s, _ = xt.linalg.svd(xt.LinearOperator.m(gm), 4, method="exacteig")
    assert jacobi_sweep_cuda.launches == 2
    s0 = np.linalg.svd(gm.double().cpu().numpy(), compute_uv=False)[:, :4][:, ::-1]
    assert np.abs(s.cpu().numpy() - s0).max() <= 2e-5 * s0.max()
    # off the window the library decomposition runs, not the kernel
    small = xt.LinearOperator.m(x[:, :32, :32].detach(), is_hermitian=True)
    xt.linalg.symeig(small, 4, method="exacteig")
    assert jacobi_sweep_cuda.launches == 2



# ------------------------------------------------------------------
# the divide-and-conquer kernel
# ------------------------------------------------------------------

def _spd(seed, B, n, device):
    a = np.random.default_rng(seed).standard_normal((B, n, n)) / np.sqrt(n)
    return torch.tensor(a @ a.transpose(0, 2, 1) + 2.0 * np.eye(n), dtype=torch.float32,
                        device=device)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _offmass(T):
    off = T - torch.diag_embed(torch.diagonal(T, dim1=-2, dim2=-1))
    return float(torch.linalg.norm(off))


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, levels, min_seg, refine", [
    (4, 256, 2, 2, 0),     # shallow
    (3, 64, 6, 2, 0),      # 2 x 2 product tiles
    (2, 96, 5, 3, 0),      # an odd number of tiles, odd min_seg
    (2, 256, 8, 2, 0),     # the config-2 shape: 8 x 8 tiles, split down to pairs
    (2, 130, 4, 16, 1),    # ragged last tile, refinement pass, early freeze, n % 4 != 0
    (2, 448, 9, 2, 0),     # the largest single-shot n jacobi_eigh gives it
    (1, 256, 8, 2, 0),     # one matrix
])
def test_dc_kernel_matches_plain(cuda, B, n, levels, min_seg, refine):
    A = _spd(n, B, n, cuda)
    kw = dict(levels=levels, min_seg=min_seg, refine=refine, return_t=True,
              return_seg=True)
    dc_precondition_cuda.launches = 0
    gk, tk, sk = dc_precondition_cuda(A, **kw)
    gp, tp, sp = dc_precondition_plain(A, **kw)
    torch.cuda.synchronize()
    assert dc_precondition_cuda.launches == 1
    assert bool(torch.isfinite(gk).all()) and bool(torch.isfinite(tk).all())
    assert sk.shape == (B, n, 1) and sk.dtype == torch.int32
    assert bool((sk[:, 1:] >= sk[:, :-1]).all())   # non-decreasing along the index
    a2 = A.double() @ A.double()
    for name, g, t in (("kernel", gk, tk), ("plain", gp, tp)):
        g, t = g.double(), t.double()
        # the implicit Q is orthonormal: G0^T G0 == A^2 (the reference's 1e-4)
        rel = float((g.mT @ g - a2).abs().max() / a2.abs().max())
        assert rel < 1e-4, (name, rel)
        # T = Q^T A Q: symmetric, and G0 G0^T == T^2
        assert float((t - t.mT).abs().max()) < 1e-4, name
        assert float((g @ g.mT - t @ t).abs().max() / a2.abs().max()) < 1e-4, name
        if levels >= 5:
            assert _offmass(g @ g.mT) < 0.25 * _offmass(a2), name
    # entry by entry, one level at a time from the kernel's own state (two
    # free runs amplify the last bit to O(1) over the levels): chip_smoke.py's
    # check, which raises where the kernel's level and the plain version's
    # differ in segment ids, G0, T or the loss of the G-invariant
    launches = dc_precondition_cuda.launches
    (gl, tl, sl), _, rows = _chip_smoke().dc_level_by_level(torch, A, levels, min_seg, refine)
    assert len(rows) == levels
    assert torch.equal(gl, gk) and torch.equal(tl, tk) and torch.equal(sl, sk)
    dc_precondition_cuda.launches = launches
    # the exports change nothing, and the dispatcher takes the kernel
    g_only = dc_precondition(A, levels=levels, min_seg=min_seg, refine=refine)
    assert torch.equal(g_only, gk) and dc_precondition_cuda.launches == 2


@pytest.mark.cuda
def test_dc_kernel_at_config2_batch(cuda):
    # 64 matrices of 256^2, 8 levels: one level at a time from the kernel's
    # own state (chip_smoke.py's check), then the free runs.  Once in some
    # tens of matrices of this recipe a soft projector's rounded rank is
    # wrong and the panel loses rank (the plain version's too; the guard of
    # the warm start catches it), so the free runs are held as
    # chip_smoke.py's config2_warm holds them: at most one panel more lost
    # than the plain version, and the healthy ones concentrate
    B, n, levels = 64, 256, 8
    A = _spd(n, B, n, cuda)
    kw = dict(levels=levels, min_seg=2, return_t=True, return_seg=True)
    (gk, tk, sk), _, rows = _chip_smoke().dc_level_by_level(torch, A, levels, 2)
    assert len(rows) == levels
    assert torch.equal(dc_precondition_cuda(A, **kw)[0], gk)
    gp, _, _ = dc_precondition_plain(A, **kw)
    a2 = A.double() @ A.double()
    healthy = []
    for g in (gk, gp):
        g = g.double()
        inv = torch.linalg.norm(g.mT @ g - a2, dim=(-2, -1)) / torch.linalg.norm(a2, dim=(-2, -1))
        ok = inv <= 1e-4
        healthy.append(int(ok.sum()))
        assert float(inv.median()) <= 1e-5
        gg = (g @ g.mT)[ok]
        off = gg - torch.diag_embed(torch.diagonal(gg, dim1=-2, dim2=-1))
        a2h = a2[ok]
        off2 = a2h - torch.diag_embed(torch.diagonal(a2h, dim1=-2, dim2=-1))
        assert bool((torch.linalg.norm(off, dim=(-2, -1))
                     < 0.25 * torch.linalg.norm(off2, dim=(-2, -1))).all())
    assert healthy[0] >= healthy[1] - 1
    assert bool((sk[:, 1:] >= sk[:, :-1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, levels, refine", [(64, 256, 8, 0), (3, 130, 5, 1)])
def test_dc_kernel_is_deterministic(cuda, B, n, levels, refine):
    # every sum in a fixed order, no atomics: two launches give the same
    # bits, and a matrix gives the same bits alone as in its batch
    A = _spd(n + 7, B, n, cuda)
    kw = dict(levels=levels, min_seg=2, refine=refine, return_t=True, return_seg=True)
    first = dc_precondition_cuda(A, **kw)
    second = dc_precondition_cuda(A, **kw)
    alone = dc_precondition_cuda(A[-1:].contiguous(), **kw)
    torch.cuda.synchronize()
    for x, y, z in zip(first, second, alone):
        assert torch.equal(x, y) and torch.equal(x[-1:], z)


@pytest.mark.cuda
def test_dc_kernel_nan_input_is_flagged_by_the_guard(cuda):
    A = _spd(0, 2, 64, cuda)
    A[1, 3, 3] = float("nan")
    g0 = dc_precondition_cuda(A, levels=6, min_seg=2)
    torch.cuda.synchronize()
    _, bad = _guard_warm_start(A, g0)
    assert bad.tolist() == [False, True]


@pytest.mark.cuda
def test_dc_kernel_rejects_what_it_cannot_take(cuda):
    A = _spd(1, 1, 32, cuda)
    for bad in (A.cpu(), A.double(), A[:, ::2, ::2],
                torch.zeros(1, 32, 31, device=cuda),
                torch.zeros(1, 1040, 1040, device=cuda),
                torch.zeros(1, 32, 32, dtype=torch.complex64, device=cuda)):
        with pytest.raises(RuntimeError):
            dc_precondition_cuda(bad)
    with pytest.raises(RuntimeError):
        dc_precondition_cuda(A, levels=40)
    with pytest.raises(ValueError):
        dc_precondition_cuda(A, om=torch.zeros(8, 8))
    # the per-level path takes this batch and returns G0 only
    for kw in ({"return_t": True}, {"return_seg": True}, {"refine": 1}):
        with pytest.raises(ValueError):
            dc_precondition(A, per_level=True, **kw)
    with pytest.raises(ValueError, match="768"):
        dc_precondition(torch.zeros(1, 776, 776, device=cuda), per_level=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 256])
def test_warm_jacobi_eigh_on_card(cuda, n):
    A = _spd(n + 1, 4, n, cuda)
    jacobi_sweep_cuda.launches = dc_precondition_cuda.launches = 0
    lw, Vw, iw = jacobi_eigh(A, precondition=True, return_info=True)
    lc, Vc, ic = jacobi_eigh(A, precondition=False, return_info=True)
    assert dc_precondition_cuda.launches == 1 and jacobi_sweep_cuda.launches == 2
    l0 = torch.linalg.eigvalsh(A.double())
    # the float32 gates of the reference's tests
    assert float((lw.double() - l0).abs().max()) < 5e-5
    assert float((lw - lc).abs().max()) < 5e-5
    assert float((A @ Vw - Vw * lw[:, None, :]).abs().max()) < 5e-4
    assert float((Vw.mT @ Vw - torch.eye(n, device=cuda)).abs().max()) < 5e-6
    warm = ~iw["guard_bad"]
    assert bool((iw["sweeps"][warm] < ic["sweeps"][warm]).all())


# ------------------------------------------------------------------
# the per-level DC kernel (one level a launch) and the sweep-kernel gate
# ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B, n, levels", [
    (2, 96, 5),      # down to frozen segments
    (3, 200, 4),     # n not a multiple of the product tile
    (2, 130, 4),     # n not a multiple of 4: the IEEE tile's single-float staging
    (2, 640, 3),     # the per-level window
])
def test_dc_level_kernel_level_by_level(cuda, B, n, levels):
    from xitorch_tpu_torch.ops.dc_level import dc_level_cuda, dc_precondition_per_level

    A = _spd(n, B, n, cuda)
    # chip_smoke.py's check, one level a launch from the kernel's own state
    (gl, _, sl), _, rows = _chip_smoke().dc_level_by_level(torch, A, levels, 2,
                                                           per_level=True)
    assert len(rows) == levels
    assert bool((sl[:, 1:] >= sl[:, :-1]).all())   # non-decreasing along the index
    dc_level_cuda.launches = 0
    g = dc_precondition_per_level(A, levels=levels)
    torch.cuda.synchronize()
    assert dc_level_cuda.launches == levels
    assert float((g - gl).abs().max()) == 0.0
    # the dispatcher: per_level=True takes the level kernel, one launch a level
    assert torch.equal(dc_precondition(A, levels=levels, per_level=True), g)
    assert dc_level_cuda.launches == 2 * levels


@pytest.mark.cuda
def test_per_level_warm_jacobi_eigh_on_card(cuda):
    from xitorch_tpu_torch.ops.dc_level import dc_level_cuda

    n = 500   # padded to 512 on this path: 9 levels
    A = _spd(n, 2, n, cuda)
    jacobi_sweep_cuda.launches = dc_level_cuda.launches = dc_precondition_cuda.launches = 0
    lw, Vw, _ = jacobi_eigh(A, precondition=True, return_info=True)
    torch.cuda.synchronize()
    assert dc_level_cuda.launches == 9 and dc_precondition_cuda.launches == 0
    assert jacobi_sweep_cuda.launches >= 1
    l0 = torch.linalg.eigvalsh(A.double())
    # config 2's float32 gates
    assert float(((lw.double() - l0).abs() / l0[:, -1:]).max()) <= 1e-5
    assert float((Vw.mT @ Vw - torch.eye(n, device=cuda)).abs().max()) < 5e-5


@pytest.mark.cuda
def test_sweep_gate_by_batch_on_card(cuda):
    from xitorch_tpu_torch.ops.jacobi_eigh import use_jacobi_for, use_jacobi_svd_for

    # the measured table: one 128 x 128 matrix goes to the library, two and
    # 64 to the kernel; from one 256 x 256 matrix on the kernel; at 768 the
    # library up to batch 8 for eigh; at 1024 the library for eigh
    assert not use_jacobi_for(torch.zeros(1, 128, 128, device=cuda))
    assert use_jacobi_for(torch.zeros(2, 128, 128, device=cuda))
    assert use_jacobi_for(torch.zeros(64, 128, 128, device=cuda))
    assert use_jacobi_for(torch.zeros(1, 256, 256, device=cuda))
    assert not use_jacobi_for(torch.zeros(8, 768, 768, device=cuda))
    assert use_jacobi_for(torch.zeros(16, 768, 768, device=cuda))
    assert not use_jacobi_for(torch.zeros(32, 1024, 1024, device=cuda))
    assert not use_jacobi_svd_for(torch.zeros(1, 128, 300, device=cuda))
    assert use_jacobi_svd_for(torch.zeros(2, 128, 300, device=cuda))
    assert use_jacobi_svd_for(torch.zeros(64, 128, 300, device=cuda))
    # complex: from batch 4 at 256, from 32 at 512
    assert not use_jacobi_for(torch.zeros(2, 256, 256, dtype=torch.complex64, device=cuda))
    assert use_jacobi_for(torch.zeros(4, 256, 256, dtype=torch.complex64, device=cuda))
    assert not use_jacobi_for(torch.zeros(16, 512, 512, dtype=torch.complex64, device=cuda))
    assert use_jacobi_for(torch.zeros(64, 512, 512, dtype=torch.complex64, device=cuda))
    # the library side of the gate meets the kernel side's orthogonality: a
    # 128-point Laplacian (gaps ~2e-3 at its bottom) through degen_eigh
    from xitorch_tpu_torch._impls.linalg.symeig import degen_eigh

    n = 128
    lap = (2.05 * torch.eye(n, device=cuda) - torch.diag(torch.ones(n - 1, device=cuda), 1)
           - torch.diag(torch.ones(n - 1, device=cuda), -1))[None]
    jacobi_sweep_cuda.launches = 0
    lam, V = degen_eigh(lap)
    torch.cuda.synchronize()
    assert jacobi_sweep_cuda.launches == 0
    assert float((V.mT @ V - torch.eye(n, device=cuda)).abs().max()) < 5e-6
    assert float((lap @ V - V * lam[:, None, :]).abs().max()) < 5e-5


# ------------------------------------------------------------------
# the complex sweep kernel
# ------------------------------------------------------------------

def _hgauge(G, hw):
    z = torch.complex(G[..., :hw].double(), G[..., hw:].double())
    gram = z @ z.mH
    nrm = torch.diagonal(gram, dim1=-2, dim2=-1).real
    ratio = gram.abs() ** 2 / (nrm[:, :, None] * nrm[:, None, :]).clamp(min=1e-300)
    eye = torch.eye(G.shape[-2], dtype=torch.bool, device=G.device)
    return float(ratio.masked_fill(eye, 0.0).max())


def _herm_panel(B, n, hw, device, seed=6):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, n, hw)) + 1j * rng.standard_normal((B, n, hw))
    if n == hw:
        z = z @ z.conj().transpose(0, 2, 1) / np.sqrt(n) + 2.0 * np.eye(n)
    z[-1, 1] = 0.0  # a zero row must stay dead
    return torch.tensor(np.concatenate([z.real, z.imag], -1), dtype=torch.float32,
                        device=device)


def _hermitian_invariant(G, hw):
    z = torch.complex(G[..., :hw].double(), G[..., hw:].double())
    return z.mH @ z


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, hw, smem_limit, forced, cluster", [
    (3, 32, 32, None, None, 8),     # hermitian, one float4 of each plane a CTA
    (2, 64, 150, None, None, 8),    # rectangular, half-width not a multiple of 4
    (2, 48, 149, None, None, 8),    # an odd half-width
    (64, 256, 256, None, None, 3),  # config 2: 184 KB slices on 3 CTAs, two waves
    (16, 256, 256, None, None, 4),  # 16 clusters of 4 at once
    (1, 256, 256, None, None, 8),   # batch 1
    (2, 512, 512, None, None, 16),  # 139 KB slices only on the cluster of 16
    (1, 16, 500, None, None, 8),    # wide rows
    (4, 256, 256, None, 3, 3),      # 3 CTAs forced where 8 would be chosen
    (4, 256, 256, None, 4, 4),      # 4 CTAs forced: two tile buffers
    (2, 256, 256, 0, None, 0),      # the device-memory path, forced
    (1, 16, 500, 0, None, 0),       # device memory, four float4 a half a lane
    (1, 32, 1030, 0, None, 0),      # device memory, wider than the register cache
])
def test_complex_sweep_kernel_matches_plain(cuda, B, n, hw, smem_limit, forced, cluster):
    P = _herm_panel(B, n, hw, cuda)
    tol = float(torch.finfo(torch.float32).eps) * 4.0 * np.sqrt(n)
    jacobi_sweep_cuda.launches = jacobi_sweep_cuda.launches_complex = 0
    Gk, sk, gk, rk = jacobi_sweep_cuda(P, 18, tol, return_stats=True, complexpair=True,
                                       smem_limit=smem_limit, cluster=forced)
    assert jacobi_sweep_cuda.last_cluster == cluster
    Gp, sp = jacobi_sweep_plain(P, 18, tol, complexpair=True)
    torch.cuda.synchronize()
    assert jacobi_sweep_cuda.launches_complex == 1 and jacobi_sweep_cuda.launches == 0
    assert Gk.shape == P.shape and bool(torch.isfinite(Gk).all())
    assert float(Gk[-1, 1].abs().max()) == 0.0  # rows keep their order
    tol2 = tol * tol
    assert float(_max_cos2(Gk, True).max()) <= tol2 and float(gk.max()) <= tol2
    assert float(_max_cos2(Gp, True).max()) <= tol2
    assert _hgauge(Gk, hw) <= 1.5 * tol2
    # rows are only rotated and re-phased: G^H G is invariant
    ref = _hermitian_invariant(P, hw)
    for name, G in (("kernel", Gk), ("plain", Gp)):
        inv = torch.linalg.norm(_hermitian_invariant(G, hw) - ref) / torch.linalg.norm(ref)
        assert float(inv) <= 1e-5, name
    nk, np_ = _sorted_row_norms(Gk), _sorted_row_norms(Gp)
    assert float((nk - np_).abs().max() / np_.max()) <= 1e-5
    assert int((sk - sp).abs().max()) <= 1
    rounds = -(-(n - 1) // 6) * 6
    assert bool((rk > 0).all()) and bool((rk <= sk * rounds * (n // 2)).all())
    # the dispatcher takes the complex kernel
    jacobi_sweep(P, 18, tol, complexpair=True)
    assert jacobi_sweep_cuda.launches_complex == 2


@pytest.mark.cuda
@pytest.mark.parametrize("B, cluster", [(3, 8), (40, 3)])
def test_complex_sweep_clusters_exit_on_their_own(cuda, B, cluster):
    # one launch: an orthogonal panel (no sweep), random ones, one with a
    # dead zero row; every cluster leaves on its own gauge and none hangs
    # (40 matrices on clusters of 3: the card holds 39 at once, so a second
    # wave starts as the first clusters leave)
    n = 256
    rng = np.random.default_rng(8)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    z = (rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))) / np.sqrt(2 * n)
    z = z @ z.conj().transpose(0, 2, 1) + 2.0 * np.eye(n)
    z[0] = q * np.arange(1, n + 1)[:, None]
    z[-1, 5] = 0.0
    P = torch.tensor(np.concatenate([z.real, z.imag], -1), dtype=torch.float32, device=cuda)
    tol = float(torch.finfo(torch.float32).eps) * 4.0 * np.sqrt(n)
    G, sweeps, gauge, rot = jacobi_sweep_cuda(P, 18, tol, return_stats=True, complexpair=True)
    torch.cuda.synchronize()
    assert jacobi_sweep_cuda.last_cluster == cluster
    assert int(sweeps[0]) == 0 and int(rot[0]) == 0 and bool(torch.equal(G[0], P[0]))
    assert bool((sweeps[1:] >= 5).all()) and bool((sweeps <= 18).all())
    assert float(G[-1, 5].abs().max()) == 0.0
    tol2 = tol * tol
    assert bool((gauge <= tol2).all()) and float(_max_cos2(G, True).max()) <= tol2
    ref = _hermitian_invariant(P, n)
    inv = torch.linalg.norm(_hermitian_invariant(G, n) - ref, dim=(-2, -1)) \
        / torch.linalg.norm(ref, dim=(-2, -1))
    assert float(inv.max()) <= 1e-5
    # max_sweeps = 0 measures the gauge and leaves, on every cluster
    G0, s0, g0, _ = jacobi_sweep_cuda(P, 0, tol, return_stats=True, complexpair=True)
    assert bool((s0 == 0).all()) and bool(torch.equal(G0, P))
    assert float(((g0.double() / _max_cos2(P, True).double())[1:] - 1.0).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_complex_sweep_rejects_what_it_cannot_take(cuda):
    P = torch.zeros(1, 32, 64, device=cuda)
    for bad in (P.cpu(), P.double(), P[:, :31], P[:, :, :33].contiguous(),
                torch.zeros(1, 1040, 64, device=cuda),
                torch.zeros(1, 16, 4104, device=cuda),
                torch.zeros(1, 32, 32, dtype=torch.complex64, device=cuda)):
        with pytest.raises(RuntimeError):
            jacobi_sweep_cuda(bad, 18, 1e-5, complexpair=True)


@pytest.mark.cuda
def test_complex_symeig_and_svd_on_card_go_through_the_complex_kernel(cuda):
    rng = np.random.default_rng(7)
    z = rng.standard_normal((4, 96, 96)) + 1j * rng.standard_normal((4, 96, 96))
    herm = z @ z.conj().transpose(0, 2, 1) / 96 + 2.0 * np.eye(96)
    ar = torch.tensor(herm.real, dtype=torch.float32, device=cuda, requires_grad=True)
    ai = torch.tensor(herm.imag, dtype=torch.float32, device=cuda, requires_grad=True)
    x = torch.complex(ar, ai)
    jacobi_sweep_cuda.launches = jacobi_sweep_cuda.launches_complex = 0
    A = xt.LinearOperator.m((x + x.mH) / 2, is_hermitian=True)
    e, X = xt.linalg.symeig(A, 4, "lowest")          # default routing
    assert jacobi_sweep_cuda.launches_complex == 1 and jacobi_sweep_cuda.launches == 0
    e0 = np.linalg.eigvalsh(herm)[:, :4]
    # the reference's complex64 gate
    scale = np.abs(np.linalg.eigvalsh(herm)).max()
    assert np.abs(e.detach().cpu().numpy() - e0).max() <= 3e-5 * scale
    gr, gi = torch.autograd.grad(e.sum() + (X @ X.mH).real.sum(), (ar, ai))
    assert bool(torch.isfinite(gr).all()) and bool(torch.isfinite(gi).all())
    gm = torch.tensor(z[:, :, :80] / 10, dtype=torch.complex64, device=cuda)
    u, s, vh = xt.linalg.svd(xt.LinearOperator.m(gm), 4)
    assert jacobi_sweep_cuda.launches_complex == 2
    s0 = np.linalg.svd(gm.to(torch.complex128).cpu().numpy(), compute_uv=False)[:, :4][:, ::-1]
    assert np.abs(s.cpu().numpy() - s0).max() <= 3e-5 * s0.max()
    assert float((gm @ vh.mH - u * s[..., None, :]).abs().max()) <= 2e-4


def _spd_batch(nb, n, nc, dtype, device, seed=0, lo=0.2):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((nb, n, n)))
    a = (q * np.linspace(lo, 1.0, n)) @ np.swapaxes(q, -1, -2)
    a = (a + np.swapaxes(a, -1, -2)) / 2
    b = rng.standard_normal((nb, n, nc))
    return (torch.tensor(a, dtype=dtype, device=device),
            torch.tensor(b, dtype=dtype, device=device))


def _twin_group(nc):
    # the stop groups of the launch just made: None where one group (one
    # cluster) holds all of a system's columns, the reference's joint rule
    d = fused_cg_cuda.last_design
    return None if d.group >= nc else d.group


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol, xtol", [(torch.float32, 1e-6, 1e-4),
                                               (torch.float64, 1e-12, 1e-10)])
@pytest.mark.parametrize("nb, n, nc, cluster", [
    (3, 33, 1, None), (2, 97, 5, None), (5, 130, 11, None), (2, 700, 13, None),
    (40, 64, 9, None), (1, 257, 3, None),
    (2, 1, 3, None),        # n = 1: one row, padded to 16 bytes
    (1, 350, 50, None),     # the grid: n % 4 == 2, 7 CTAs of 8 / 7 columns
    (4, 300, 600, None),    # more columns than a cluster holds: super-groups
    (2, 200, 13, 3), (1, 350, 50, 16), (3, 120, 5, 1),   # forced cluster sizes
    (2, 130, 11, 0),        # forced device-memory path
    (1, 3500, 2, None),     # past the cluster path's window: the device-memory path
])
def test_fused_cg_kernel_matches_plain(cuda, dtype, rtol, xtol, nb, n, nc, cluster):
    A, B = _spd_batch(nb, n, nc, dtype, cuda, seed=n)
    B[0, :, 0] = 0.0  # a zero column: stop = atol, r.r = 0, x = 0 at once
    kw = dict(rtol=rtol, atol=rtol * 1e-2, max_niter=int(1.5 * n))
    a_idx = torch.arange(nb, device=cuda)
    xk, itk = fused_cg_cuda(A, a_idx, B, cluster=cluster, **kw)
    d = fused_cg_cuda.last_design
    if cluster is not None:
        assert d.cluster == cluster
    if n == 3500:
        assert d.cluster == 0
    xp, itp = fused_cg_plain(A, B, group=_twin_group(nc), **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xk).all()) and bool((xk[0, :, 0] == 0).all())
    # sums in another order (shuffle and warp order vs PyTorch's reduction)
    assert float((xk - xp).abs().max() / xp.abs().max()) <= xtol
    # a stop on rounded recurrences: a step or two either way
    assert itk.shape == itp.shape == (nb, d.groups(nc))
    assert int((itk - itp).abs().max()) <= 2
    r = torch.linalg.norm(A @ xk - B, dim=-2)
    stop = torch.clamp(rtol * torch.linalg.norm(B, dim=-2), min=rtol * 1e-2)
    # the recurrence residual drifts from the measured one by rounding
    assert bool((r <= 2.0 * stop).all())


@pytest.mark.cuda
def test_fused_cg_kernel_max_niter_and_broadcast_a(cuda):
    A, B = _spd_batch(1, 96, 4, torch.float32, cuda, seed=5, lo=0.01)
    B = B.expand(6, 96, 4).clone() * torch.arange(1, 7, device=cuda)[:, None, None]
    kw = dict(rtol=1e-6, atol=1e-8)
    x, steps = fused_cg_dense(A[0], B, max_niter=3, return_steps=True, **kw)
    assert bool((steps == 3).all())
    # a broadcast A is indexed: every system solved with the one matrix
    fused_cg_cuda.launches = 0
    x = fused_cg_dense(A[0], B, **kw)
    xp, _ = fused_cg_plain(A.expand(6, 96, 96), B, max_niter=144, group=_twin_group(4),
                           **kw)
    torch.cuda.synchronize()
    assert fused_cg_cuda.launches == 1
    assert float((x - xp).abs().max() / xp.abs().max()) <= 1e-4
    with pytest.raises(RuntimeError, match="does not match"):
        fused_cg_dense(A[0].double(), B)


@pytest.mark.cuda
def test_solve_fused_cg_on_card_launches_forward_and_adjoint(cuda):
    A, B = _spd_batch(4, 80, 6, torch.float32, cuda, seed=7)
    leaf = A.clone().requires_grad_()
    Bl = B.clone().requires_grad_()
    w = torch.ones_like(B)
    fused_cg_cuda.launches = 0
    x = xt.linalg.solve(xt.LinearOperator.m((leaf + leaf.mT) / 2, is_hermitian=True), Bl,
                        method="fused_cg", rtol=1e-6, atol=1e-8)
    assert fused_cg_cuda.launches == 1
    gA, gB = torch.autograd.grad((x * w).sum(), (leaf, Bl))
    assert fused_cg_cuda.launches == 2
    A64 = A.double().requires_grad_()
    B64 = B.double().requires_grad_()
    x64 = torch.linalg.solve((A64 + A64.mT) / 2, B64)
    rA, rB = torch.autograd.grad((x64 * w.double()).sum(), (A64, B64))
    for g, r in ((gA, rA), (gB, rB)):
        assert float(torch.linalg.norm(g.double() - r) / torch.linalg.norm(r)) <= 1e-4


class _MatVecOnly(xt.LinearOperator):
    """A hermitian matrix without ``_fullmatrix``: matrix-free."""

    def __init__(self, mat):
        super().__init__(shape=mat.shape, dtype=mat.dtype, device=mat.device,
                         is_hermitian=True)
        self.mat = mat

    def _getparamnames(self, prefix=""):
        return [prefix + "mat"]

    def _mv(self, x):
        return (self.mat @ x[..., None])[..., 0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["E", "matrix_free", "complex"])
def test_solve_fused_cg_on_card_raises_outside_the_kernel(cuda, case):
    # naming the kernel's method on the card never runs the Python-loop cg
    # unnoticed: what the kernel does not take is an error there
    A, B = _spd_batch(1, 64, 3, torch.float32, cuda, seed=11)
    op, kw = xt.LinearOperator.m(A[0], is_hermitian=True), {}
    if case == "E":
        kw["E"] = torch.zeros(3, device=cuda)
    elif case == "matrix_free":
        op = _MatVecOnly(A[0])
    else:
        op = xt.LinearOperator.m(A[0].to(torch.complex64), is_hermitian=True)
        B = B.to(torch.complex64)
    fused_cg_cuda.launches = 0
    with pytest.raises(RuntimeError, match="method='cg'"):
        xt.linalg.solve(op, B[0], method="fused_cg", **kw)
    assert fused_cg_cuda.launches == 0
    # the same call on CPU tensors goes to the matrix-free cg, as in the reference
    cpu_op = _MatVecOnly(A[0].cpu()) if case == "matrix_free" else \
        xt.LinearOperator.m(op.fullmatrix().cpu(), is_hermitian=True)
    cpu_kw = {k: v.cpu() for k, v in kw.items()}
    x = xt.linalg.solve(cpu_op, B[0].cpu(), method="fused_cg", **cpu_kw)
    assert bool(torch.isfinite(torch.view_as_real(x) if x.is_complex() else x).all())


@pytest.mark.cuda
def test_scf_float32_exacteig_on_card_goes_through_the_sweep_kernel(cuda):
    # BASELINE config 5's float32 route: each SCF step decomposes the
    # materialised 256 x 256 Hamiltonian through the real sweep kernel
    # (batch 1 at n = 256 passes the gate), and the gradient to a and g
    # goes through both implicit rules on the card
    from xitorch_tpu_torch.models import scf_density, scf_energy

    n, nocc = 256, 8
    a = torch.tensor(np.random.default_rng(0).standard_normal((n, n)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    g = torch.tensor(0.3, device=cuda, requires_grad=True)
    # the sweep kernel's float32 eigenvectors leave ~2e-5 in the residual
    kw = dict(nocc=nocc, eig_method="exacteig", f_tol=1e-4, x_tol=1e-4, maxiter=400)
    jacobi_sweep_cuda.launches = 0
    rho, info = scf_density(a.detach(), g.detach(), return_info=True, **kw)
    assert jacobi_sweep_cuda.launches >= 2 and float(info["converged"]) == 1.0
    assert abs(float(rho.sum()) - nocc) < 1e-3
    e = scf_energy(a, g, **kw)
    ga, gg = torch.autograd.grad(e, (a, g))
    assert bool(torch.isfinite(ga).all()) and bool(torch.isfinite(gg))


@pytest.mark.cuda
def test_vmap_rk45_on_card_matches_per_trajectory_calls(cuda):
    # per-trajectory adaptive steps under torch.func.vmap on the card: each
    # trajectory equals its own call and the float64 run on the CPU
    from xitorch_tpu_torch.integrate import solve_ivp

    def f(t, y, w):
        return torch.stack([y[1], -(w ** 2) * y[0] - 0.1 * y[1] + torch.sin(t)])

    ws = torch.tensor([1.0, 1.3, 1.9], device=cuda)
    ts = torch.linspace(0.0, 3.0, 16, device=cuda)
    y0 = torch.tensor([1.0, 0.0], device=cuda)
    opts = dict(method="rk45", rtol=1e-6, atol=1e-8, return_info=True)
    yt, info = torch.func.vmap(lambda w: solve_ivp(f, ts, y0, params=(w,), max_steps=512,
                                                   **opts))(ws)
    assert bool((info["converged"] == 1).all())
    for k in range(3):
        y1, i1 = solve_ivp(f, ts, y0, params=(ws[k],), **opts)
        # float32 rounding of a batched against a single call, ~50 steps
        torch.testing.assert_close(y1, yt[k], rtol=0, atol=1e-5)
        assert float(i1["iterations"]) == float(info["iterations"][k])
        y64 = solve_ivp(f, ts.double().cpu(), y0.double().cpu(), params=(ws[k].double().cpu(),),
                        method="rk45", rtol=1e-10, atol=1e-12)
        assert float((y1.double().cpu() - y64).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_thomas_kernel_at_the_splines_system(cuda, dtype, tol):
    # the natural spline of bench_quad_interp.py's data: (1000,) diagonals
    # broadcast against 512 right-hand sides, as Interp1D gives them
    from xitorch_tpu_torch._impls.interpolate.interp_1d import spline_tridiag_system
    from xitorch_tpu_torch.ops.tridiag import tridiag_solve_kernel

    x, y, _ = _chip_smoke().interp_data(np)
    dl, d, du, r = spline_tridiag_system(torch.tensor(x, dtype=dtype, device=cuda),
                                         torch.tensor(y, dtype=dtype, device=cuda), "natural")
    assert dl.shape == (1000,) and r.shape == (512, 1000)
    flat = [a.expand(512, 1000).contiguous() for a in (dl, d, du, r)]
    eps = float(torch.finfo(dtype).tiny)
    thomas_cuda.launches = 0
    xw = tridiag_solve_kernel(dl, d, du, r)
    assert thomas_cuda.launches == 1
    xp = thomas_plain(*flat, eps)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xw).all())
    assert float((xw - xp).abs().max() / xp.abs().max()) <= tol


@pytest.mark.cuda
def test_interp1d_natural_on_card_launches_the_thomas_kernel(cuda):
    from scipy.interpolate import CubicSpline

    x, y, xq = _chip_smoke().interp_data(np)
    xt_, yt, xqt = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (x, y, xq))
    thomas_cuda.launches = 0
    out = xt.interpolate.Interp1D(xt_, yt, method="cspline", bc_type="natural")(xqt)
    torch.cuda.synchronize()
    assert thomas_cuda.launches == 1
    ref = CubicSpline(x, y[:16].T, bc_type="natural")(xq).T
    err = float(np.abs(out[:16].double().cpu().numpy() - ref).max())
    assert err <= 2e-4 * max(1.0, float(np.abs(ref).max()))
    # the gradient to y and x: one more launch (the transposed solve)
    xg, yg = xt_.clone().requires_grad_(), yt.clone().requires_grad_()
    thomas_cuda.launches = 0
    out = xt.interpolate.Interp1D(xg, yg, method="cspline", bc_type="natural")(xqt)
    gx, gy = torch.autograd.grad(out.sum(), (xg, yg))
    torch.cuda.synchronize()
    assert thomas_cuda.launches == 2
    assert bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gy).all())
    # the dense routes launch nothing
    thomas_cuda.launches = 0
    xt.interpolate.Interp1D(xt_, yt)(xqt)
    xt.integrate.SQuad(xt_).integrate(yt)
    torch.cuda.synchronize()
    assert thomas_cuda.launches == 0


@pytest.mark.cuda
def test_squad_on_card_within_its_gate(cuda):
    from scipy.interpolate import CubicSpline

    x, y, _ = _chip_smoke().interp_data(np)
    xt_, yt = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (x, y))
    out = xt.integrate.SQuad(xt_, method="cspline").integrate(yt)
    assert out.shape == (512,) and out.device.type == "cuda"
    ref = CubicSpline(x, y[:16].T, bc_type="natural").integrate(x[0], x[-1])
    err = float(np.abs(out[:16].double().cpu().numpy() - ref).max())
    assert err <= 2e-4 * max(1.0, float(np.abs(ref).max()))
