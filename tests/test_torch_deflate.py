"""The deflated path of ``jacobi_eigh(deflate=True)`` (``ops/_finisher_lab.py``)
against the JAX package's (xitorch_tpu/ops/_finisher_lab.py, its Pallas
sweep in interpret mode) on the same numpy inputs.

Tolerances: the restore table is integers (exact); the window solves are
float32 sweeps on well-separated blocks, each row an eigenvector to ~1e-6,
held to 1e-4 up to sign; ``deflate_refine`` is the same float64
arithmetic (1e-10); the whole path is held to the JAX package's own gates
(tests/test_jacobi_eigh.py::test_deflated_eigh_quality_and_stress):
eigenvalues within 2e-5 of the largest, column residuals 2e-5, orthogonality
5e-5, and within 2e-5 of the JAX package's eigenvalues."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.ops import _finisher_lab as jlab
from xitorch_tpu.ops.jacobi_eigh import jacobi_eigh as jjacobi_eigh
from xitorch_tpu_torch.ops import _finisher_lab as lab
from xitorch_tpu_torch.ops import jacobi_eigh as jmod
from xitorch_tpu_torch.ops.jacobi_eigh import jacobi_eigh

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [16, 32, 64, 96, 192, 256])
def test_restore_perm_table_matches_the_reference(n):
    np.testing.assert_array_equal(lab._restore_perm_table(n, 18),
                                  jlab._restore_perm_table(n, 18))


def _blocks(seed=0, BB=3, w=32):
    """Symmetric (BB, w, w) blocks with well-separated spectra, and slots
    masked to pass-through (zero couplings, a positive diagonal) as the
    deflated path's stage 1 masks them."""
    rng = np.random.default_rng(seed)
    out = np.empty((BB, w, w))
    valid = np.ones((BB, w), bool)
    valid[0, :5] = False
    valid[1, -7:] = False
    valid[2, 10:13] = False
    for i in range(BB):
        q, _ = np.linalg.qr(rng.standard_normal((w, w)))
        out[i] = (q * np.linspace(1.0, 4.0, w)) @ q.T
        vv = valid[i][:, None] & valid[i][None, :]
        out[i] = np.where(vv, out[i], 0.0) + np.diag(np.where(valid[i], 0.0,
                                                              1.0 + np.arange(w)))
    return out.astype(np.float32), valid


def _same_up_to_sign(r, rr):
    return np.minimum(np.abs(r - rr).max(-1), np.abs(r + rr).max(-1))


@pytest.mark.parametrize("sorted_", [True, False])
def test_window_solve_matches_the_reference(sorted_):
    blocks, valid = _blocks()
    sv = valid if sorted_ else None
    want = np.asarray(jax.jit(lambda b, v: jlab._window_solve(
        b, max_sweeps=18, interpret=True, sort_valid=v))(
            jnp.asarray(blocks), None if sv is None else jnp.asarray(sv)))
    got = lab._window_solve(torch.tensor(blocks), max_sweeps=18,
                            sort_valid=None if sv is None else torch.tensor(sv)).numpy()
    assert _same_up_to_sign(got, want).max() <= 1e-4
    w = blocks.shape[-1]
    eye = np.eye(w, dtype=np.float32)
    for i, j in zip(*np.nonzero(~valid)):
        assert np.array_equal(got[i, j], eye[j])          # pass-through: exactly e_j at j
    # the rows diagonalise their blocks
    lam = np.einsum("bij,bjk,blk->bil", got, blocks, got)
    off = lam - np.einsum("bii->bi", lam)[..., None] * eye
    assert np.abs(off).max() <= 1e-4 * np.abs(blocks).max()


def test_window_solve_restores_only_the_rows_that_moved(monkeypatch):
    """A route that keeps the input's row order (the kernel: ``drift`` 0) gets
    no restore; the plain version's rows (``drift`` its sweeps) do: both give
    the same rotations."""
    blocks, valid = _blocks(seed=1)
    sweep = jmod.jacobi_sweep

    def in_order(panel, max_sweeps, tol, return_drift=False):
        g, sweeps, drift = sweep(panel, max_sweeps, tol, return_drift=True)
        table = torch.as_tensor(lab._restore_perm_table(panel.shape[-2], max_sweeps))
        fix = table[drift.long()].long()
        g = torch.take_along_dim(g, fix[:, :, None], dim=1)
        return g, sweeps, torch.zeros_like(drift)

    kw = dict(max_sweeps=18, sort_valid=torch.tensor(valid))
    plain = lab._window_solve(torch.tensor(blocks), **kw)
    assert int(sweep(torch.tensor(blocks), 18, 1e-5, return_drift=True)[2].min()) >= 1
    monkeypatch.setattr(lab, "jacobi_sweep", in_order)
    assert torch.equal(lab._window_solve(torch.tensor(blocks), **kw), plain)


def test_deflate_refine_matches_the_reference():
    rng = np.random.default_rng(4)
    B, n = 2, 24
    q, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    a0 = (q * np.linspace(0.5, 3.0, n)) @ q.transpose(0, 2, 1)
    # slightly mixed eigenvectors, as the finisher leaves them
    V = q @ (np.eye(n) + 1e-4 * rng.standard_normal((B, n, n)))
    AV = a0 @ V
    lam = np.einsum("bij,bij->bj", V, AV)
    want = jlab.deflate_refine(*map(jnp.asarray, (a0, V, AV, lam)))
    got = lab.deflate_refine(*map(torch.tensor, (a0, V, AV, lam)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def _reference_inputs(rng, B, n):
    """tests/test_jacobi_eigh.py's recipe: a clustered and an exactly
    degenerate spectrum (the Wishart rest of its batch of 4 cut)."""
    w = rng.standard_normal((B, n, n)).astype(np.float32) / np.sqrt(n)
    a = (w @ np.swapaxes(w, -1, -2) + 0.05 * np.eye(n, dtype=np.float32)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lamc = np.sort(np.concatenate([np.linspace(0.1, 1, n - 16), np.full(16, 0.55)]))
    a[0] = ((q * lamc) @ q.T).astype(np.float32)
    lamd = np.repeat(np.linspace(0.2, 2.0, (n + 3) // 4), 4)[:n]
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a[1] = ((q2 * np.sort(lamd)) @ q2.T).astype(np.float32)
    return a


@pytest.mark.parametrize("n", [96, 200])
def test_deflated_eigh_matches_the_reference(n):
    a = _reference_inputs(np.random.default_rng(11), 2, n)
    lam_j = np.asarray(jax.jit(lambda x: jjacobi_eigh(x, interpret=True, deflate=True)[0])(
        jnp.asarray(a)), np.float64)
    lam, V, info = jacobi_eigh(torch.tensor(a), deflate=True, return_info=True)
    lam, V = lam.numpy().astype(np.float64), V.numpy().astype(np.float64)
    lam0 = np.linalg.eigvalsh(a.astype(np.float64))
    scale = np.abs(lam0).max(axis=-1, keepdims=True)
    assert np.max(np.abs(lam - lam0) / scale) < 2e-5
    assert np.max(np.abs(lam - lam_j) / scale) < 2e-5
    r = a.astype(np.float64) @ V - V * lam[:, None, :]
    colres = np.linalg.norm(r, axis=1) / np.linalg.norm(a, axis=(1, 2))[:, None]
    assert colres.max() < 2e-5, colres.max()
    for i in range(2):
        assert np.linalg.norm(V[i].T @ V[i] - np.eye(n)) < 5e-5
    # the finisher's sweeps and the guard's fall-backs (at n = 200 the
    # clustered matrix's deflated panel fails the guard, as the JAX
    # package's does: max cos^2 0.023 here, 0.022 there)
    assert info["sweeps"].shape == (2,) and int(info["sweeps"].max()) < 18
    assert info["guard_bad"].dtype == torch.bool


def test_deflated_eigh_rejects_complex_and_large_n():
    with pytest.raises(ValueError, match="complex"):
        jacobi_eigh(torch.eye(64, dtype=torch.complex64)[None], deflate=True)
    with pytest.raises(ValueError, match="n <= 448"):
        jacobi_eigh(torch.eye(449)[None], deflate=True)
    assert jmod._padded_n(40, deflate=True) == 64 and jmod._padded_n(200, deflate=True) == 208
    assert jmod._padded_n(40) == 48
