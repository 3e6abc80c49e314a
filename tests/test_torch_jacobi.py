"""The port's one-sided Jacobi sweep, jacobi_eigh and jacobi_svd against the
JAX package (its Pallas kernel in interpret mode, cold sweep) and numpy, on
the same numpy inputs.  On the CPU the sweep is the plain PyTorch version;
the CUDA kernel is held against it in tests/test_torch_kernels_cuda.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.ops.jacobi_eigh import _pallas_g_panel
from xitorch_tpu.ops.jacobi_eigh import jacobi_eigh as jjacobi_eigh
from xitorch_tpu.ops.jacobi_eigh import jacobi_svd as jjacobi_svd
from xitorch_tpu_torch.ops import jacobi_eigh as jmod
from xitorch_tpu_torch.ops.jacobi_eigh import (
    _max_cos2, fits_jacobi_sweep, jacobi_eigh, jacobi_svd, jacobi_sweep,
    jacobi_sweep_cuda, jacobi_sweep_plain, use_jacobi_for, use_jacobi_svd_for,
)

torch.set_num_threads(1)


def _panel(B, n, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, n, w))
    if n == w:  # shifted SPD, as jacobi_eigh hands the kernel
        a = a @ a.transpose(0, 2, 1) / math.sqrt(n) + 2.0 * np.eye(n)
    return a.astype(np.float32)


@pytest.mark.parametrize("B, n, w", [(3, 32, 32), (2, 48, 48), (2, 16, 40)])
def test_sweep_plain_matches_pallas_interpret(B, n, w):
    a = _panel(B, n, w, n + w)
    tol = float(np.finfo(np.float32).eps) * 4.0 * math.sqrt(n)
    gj, sj = _pallas_g_panel(jnp.asarray(a), 18, tol, True, False, return_sweeps=True)
    gt, st = jacobi_sweep_plain(torch.as_tensor(a), 18, tol)
    gj = np.asarray(gj, dtype=np.float64)
    g = gt.numpy().astype(np.float64)
    assert gt.shape == (B, n, w) and st.shape == (B,) and st.dtype == torch.int32
    # the reference stacks the batch in one program and sweeps to the
    # slowest; the port's matrices leave one by one
    assert int(st.max()) <= int(np.asarray(sj).max()) + 1
    assert int(st.max()) >= int(np.asarray(sj).max()) - 1
    assert float(_max_cos2(gt).max()) <= tol * tol
    # rows are only rotated: G^T G keeps the input's (float32 rounding of
    # ~n rotations per row and sweep)
    ref = a.astype(np.float64).transpose(0, 2, 1) @ a.astype(np.float64)
    for G in (g, gj):
        inv = np.linalg.norm(G.transpose(0, 2, 1) @ G - ref) / np.linalg.norm(ref)
        assert inv <= 5e-6
    # row order is not promised: compare sorted row norms
    nt = np.sort(np.linalg.norm(g, axis=-1), axis=-1)
    nj = np.sort(np.linalg.norm(gj, axis=-1), axis=-1)
    assert np.abs(nt - nj).max() <= 1e-5 * nj.max()
    if n == w:  # row norms are the eigenvalues of the SPD input
        l0 = np.linalg.eigvalsh(a.astype(np.float64))
        assert np.abs(nt - l0).max() <= 1e-5 * l0.max()


def test_sweep_exits_per_matrix_and_keeps_zero_rows_dead():
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((16, 16)))
    ortho = (q * np.arange(1, 17)[:, None]).astype(np.float32)
    a = np.stack([ortho, _panel(1, 16, 16, 1)[0]])
    a[1, 3] = 0.0
    G, sweeps = jacobi_sweep(torch.as_tensor(a), 18, 1e-5)
    assert sweeps.tolist()[0] == 0 and sweeps.tolist()[1] >= 2
    assert torch.equal(G[0], torch.as_tensor(ortho))   # untouched
    norms = torch.linalg.norm(G[1], dim=-1)
    assert int((norms == 0).sum()) == 1                # the zero row stayed zero
    G0, s0 = jacobi_sweep_plain(torch.as_tensor(a), 0, 1e-5)
    assert torch.equal(G0, torch.as_tensor(a)) and s0.tolist() == [0, 0]


# float32 under the gates of tests/test_jacobi_eigh.py (eigenvalues 2e-5 of
# the spectral scale); float64 to rounding
@pytest.mark.parametrize("dtype, rtol", [(np.float32, 2e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(2, 20, 20), (2, 3, 16, 16), (1, 64, 64)])
def test_jacobi_eigh_matches_jax_and_numpy(shape, dtype, rtol):
    a = np.random.default_rng(shape[-1]).standard_normal(shape)
    a = ((a + np.swapaxes(a, -2, -1)) / 2).astype(dtype)   # indefinite
    lj, _ = jjacobi_eigh(jnp.asarray(a), interpret=True, precondition=False)
    lt, vt = jacobi_eigh(torch.as_tensor(a))
    n = shape[-1]
    assert lt.shape == shape[:-1] and vt.shape == shape
    l0 = np.linalg.eigvalsh(a.astype(np.float64))
    scale = np.abs(l0).max()
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= rtol * scale
    assert np.abs(lt.numpy() - l0).max() <= rtol * scale
    v = vt.numpy().astype(np.float64)
    assert np.abs(a.astype(np.float64) @ v - v * lt.numpy()[..., None, :]).max() \
        <= 5 * rtol * scale
    assert np.abs(np.swapaxes(v, -2, -1) @ v - np.eye(n)).max() <= 5 * rtol


def test_jacobi_eigh_degenerate_spectrum():
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    lam = np.concatenate([np.full(8, 1.0), np.full(8, -2.0), np.linspace(3, 4, 16)])
    a = (q * lam) @ q.T
    a = (a + a.T) / 2
    lt, vt = jacobi_eigh(torch.as_tensor(a[None]))
    lj, _ = jjacobi_eigh(jnp.asarray(a[None]), interpret=True, precondition=False)
    assert np.abs(lt.numpy()[0] - np.sort(lam)).max() <= 1e-11
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= 1e-11
    v = vt.numpy()[0]
    assert np.abs(a @ v - v * lt.numpy()[0]).max() <= 1e-10
    assert np.abs(v.T @ v - np.eye(32)).max() <= 1e-11


@pytest.mark.parametrize("dtype, atol", [(np.float32, 3e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(2, 40, 24), (2, 24, 40), (2, 2, 16, 16)])
def test_jacobi_svd_matches_jax_and_numpy(shape, dtype, atol):
    a = np.random.default_rng(sum(shape)).standard_normal(shape).astype(dtype)
    _, sj, _ = jjacobi_svd(jnp.asarray(a), interpret=True)
    u, s, v = jacobi_svd(torch.as_tensor(a))
    m, n = shape[-2:]
    r = min(m, n)
    assert u.shape == (*shape[:-2], m, r) and s.shape == (*shape[:-2], r)
    assert v.shape == (*shape[:-2], n, r)
    s0 = np.linalg.svd(a.astype(np.float64), compute_uv=False)[..., ::-1]
    smax = s0.max()
    assert np.abs(s.numpy() - np.asarray(sj)).max() <= atol * smax
    assert np.abs(s.numpy() - s0).max() <= atol * smax
    rec = (u * s[..., None, :]) @ v.mT
    assert float((rec - torch.as_tensor(a)).abs().max()) <= 10 * atol * smax
    eye = torch.eye(r, dtype=u.dtype)
    assert float((u.mT @ u - eye).abs().max()) <= 10 * atol
    assert float((v.mT @ v - eye).abs().max()) <= 10 * atol


def test_jacobi_svd_rank_deficient_gets_orthonormal_completion():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((2, 24, 2)) @ rng.standard_normal((2, 2, 12))  # rank 2
    u, s, v = jacobi_svd(torch.as_tensor(a))
    _, sj, _ = jjacobi_svd(jnp.asarray(a), interpret=True)
    s0 = np.linalg.svd(a, compute_uv=False)[..., ::-1]
    assert np.abs(s.numpy() - s0).max() <= 1e-10
    assert np.abs(s.numpy() - np.asarray(sj)).max() <= 1e-10
    assert float(s[:, :-2].max()) <= 1e-10
    eye = torch.eye(12, dtype=u.dtype)
    assert float((u.mT @ u - eye).abs().max()) <= 1e-9
    assert float((v.mT @ v - eye).abs().max()) <= 1e-9
    rec = (u * s[..., None, :]) @ v.mT
    assert float((rec - torch.as_tensor(a)).abs().max()) <= 1e-9


def test_rejection_paths():
    a = torch.eye(16)[None]
    with pytest.raises(ValueError):
        jacobi_eigh(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        jacobi_svd(torch.zeros(3))
    for kw in ({"precondition": True}, {"deflate": True}):
        with pytest.raises(NotImplementedError, match="next slice"):
            jacobi_eigh(a, **kw)
    with pytest.raises(NotImplementedError, match="complex"):
        jacobi_eigh(a.to(torch.complex64))
    with pytest.raises(NotImplementedError, match="complex"):
        jacobi_svd(a.to(torch.complex64))
    # precondition=None and False are the cold sweep
    l0, _ = jacobi_eigh(a, precondition=None)
    l1, _ = jacobi_eigh(a, precondition=False, deflate=False)
    assert torch.equal(l0, l1)
    with pytest.raises(RuntimeError):
        jacobi_sweep_plain(torch.zeros(1, 3, 4), 18, 1e-5)   # odd number of rows
    with pytest.raises(RuntimeError):
        jacobi_sweep_cuda(torch.zeros(1, 16, 16), 18, 1e-5)  # not a CUDA tensor


def test_gates_and_window():
    assert use_jacobi_for(torch.zeros(2, 256, 256)) is False       # CPU tensor
    assert use_jacobi_svd_for(torch.zeros(2, 256, 128)) is False
    assert fits_jacobi_sweep(256, 256, torch.float32)              # config 2
    assert fits_jacobi_sweep(128, 256, torch.float32)
    assert fits_jacobi_sweep(1024, 4096, torch.float32)
    assert not fits_jacobi_sweep(1040, 64, torch.float32)
    assert not fits_jacobi_sweep(64, 4100, torch.float32)
    assert not fits_jacobi_sweep(63, 64, torch.float32)
    assert not fits_jacobi_sweep(64, 64, torch.float64)
    assert jmod.ENABLED is True and jacobi_sweep_cuda.launches == 0
