"""The port's CUDA kernels against their plain PyTorch versions on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card:
each is marked ``cuda`` and skips without one.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have; this file imports no JAX.)

(``python3 chip_smoke.py`` covers the BASELINE config-3 shapes; these
cases cover odd sizes, several bands, other ranks and float64 Thomas.)
"""
import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu_torch.ops import (
    structured_cg_cuda, structured_cg_plain, thomas_cuda, thomas_plain,
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
