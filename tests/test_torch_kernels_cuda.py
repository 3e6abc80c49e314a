"""The port's CUDA kernels against their plain PyTorch versions on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card:
each is marked ``cuda`` and skips without one.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have; this file imports no JAX.)

(``python3 chip_smoke.py`` covers the BASELINE config-3 and config-2
shapes; these cases cover odd sizes, several bands, other ranks, float64
Thomas, and the Jacobi sweep kernel on both of its memory paths.)
"""
import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu_torch.ops import (
    structured_cg_cuda, structured_cg_plain, thomas_cuda, thomas_plain,
)
from xitorch_tpu_torch.ops.jacobi_eigh import (
    _max_cos2, jacobi_sweep, jacobi_sweep_cuda, jacobi_sweep_plain,
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
@pytest.mark.parametrize("offsets, r, K, n", [
    ((1,), 1, 3, 33), ((1, 2), 3, 7, 200), ((1,), 4, 64, 1024), ((1, 2, 5), 16, 5, 100),
    ((1,), 8, 2, 3000),
])
def test_cg_kernel_matches_plain(cuda, offsets, r, K, n):
    args = (*_cg_flat(offsets, r, K, n, cuda), offsets)
    kw = dict(rtol=1e-6, atol=1e-8, max_niter=min(2 * n, 400))
    xk, itk, resk = structured_cg_cuda(*args, **kw)
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
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("K, n", [(1, 5), (300, 129), (512, 1024)])
def test_thomas_kernel_matches_plain(cuda, dtype, tol, K, n):
    rng = np.random.default_rng(1)
    panels = [rng.uniform(-0.5, 0.5, size=(n, K)), 2.0 + rng.uniform(size=(n, K)),
              rng.uniform(-0.5, 0.5, size=(n, K)), rng.standard_normal((n, K))]
    dl, d, du, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in panels)
    # system 0: pivot d1 - dl1 * du0 / d0 == 1 - 1 * 1 == 0 is replaced by
    # eps; du1 = 0 and b1 = dl1 * x0 keep the solution finite
    d[0, 0], d[1, 0], du[0, 0], dl[1, 0], du[1, 0] = 1.0, 1.0, 1.0, 1.0, 0.0
    b[1, 0] = b[0, 0]
    eps = float(torch.finfo(dtype).tiny)
    xk = thomas_cuda(dl, d, du, b, eps)
    xp = thomas_plain(dl, d, du, b, eps)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xk).all())
    # contracted multiply-adds in the kernel vs separate roundings
    assert float((xk - xp).abs().max() / xp.abs().max()) <= tol


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
@pytest.mark.parametrize("B, n, width", [
    (3, 32, 32),      # square, shared-memory path, one float4 per lane
    (2, 64, 300),     # rectangular, width not a multiple of 4 nor of 128
    (2, 256, 256),    # the config-2 panel: 256 KB, device-memory path
    (1, 16, 1000),    # wide rows: eight float4 per lane in registers
    (1, 32, 2052),    # wider than the register cache: rows read twice
])
def test_jacobi_sweep_kernel_matches_plain(cuda, B, n, width):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((B, n, width))
    if n == width:
        a = a @ a.transpose(0, 2, 1) / np.sqrt(n) + 2.0 * np.eye(n)
    a[-1, 1] = 0.0  # a zero row must stay dead
    P = torch.tensor(a, dtype=torch.float32, device=cuda)
    tol = float(torch.finfo(torch.float32).eps) * 4.0 * np.sqrt(n)
    Gk, sk, gk, rk = jacobi_sweep_cuda(P, 18, tol, return_stats=True)
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

