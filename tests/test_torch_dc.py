"""The port's spectral divide-and-conquer warm start against the JAX package
on the same numpy inputs, with the reference's own probe carried across:
``ops/spectral_dc.py`` against the XLA-level reference, and the fused
version's plain PyTorch statement (``dc_precondition_plain``) against the
Pallas kernel in interpret mode; then the contracts of the reference's
tests on the port alone.  On the CPU the dispatcher takes the plain
version; the CUDA kernel is held against it in
tests/test_torch_kernels_cuda.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.ops.dc_kernel import dc_precondition_tpu
from xitorch_tpu.ops.spectral_dc import dc_precondition as jdc_precondition
from xitorch_tpu.ops.spectral_dc import spectral_sort_basis as jspectral_sort_basis
from xitorch_tpu_torch.ops import dc_kernel as dcmod
from xitorch_tpu_torch.ops.dc_kernel import (
    dc_precondition, dc_precondition_cuda, dc_precondition_plain, fits_dc_kernel,
)
from xitorch_tpu_torch.ops.jacobi_eigh import _guard_warm_start, jacobi_eigh
from xitorch_tpu_torch.ops.spectral_dc import (
    _msign, _polar_orth, default_probe, spectral_sort_basis,
)
from xitorch_tpu_torch.ops.spectral_dc import dc_precondition as dc_precondition_xla

torch.set_num_threads(1)


def _spd(seed, B, n, dtype=np.float32):
    a = np.random.default_rng(seed).standard_normal((B, n, n)) / math.sqrt(n)
    return (a @ a.transpose(0, 2, 1) + 2.0 * np.eye(n)).astype(dtype)


def _probe(n, dtype):
    """The reference's own draw of the mixer, as a numpy array."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1803), (n, n), dtype))


def _offmass(T):
    d = np.diagonal(T, axis1=-2, axis2=-1)
    off = T - np.eye(T.shape[-1]) * d[:, :, None]
    return float(np.sqrt((off ** 2).sum()))


# float64: the two sides do the same arithmetic, so they agree to rounding
# amplified by the ~30 products of a level; float32: the soft directions at a
# split amplify rounding differences to ~1e-3 of entries of size ~1 (the
# reference's own kernel-against-XLA test allows 0.1)
@pytest.mark.parametrize("dtype, atol", [(np.float64, 1e-9), (np.float32, 2e-2)])
def test_spectral_dc_matches_jax(dtype, atol):
    a = _spd(0, 2, 96, dtype)
    om = _probe(96, dtype)
    qj = np.asarray(jspectral_sort_basis(jnp.asarray(a), levels=4, min_seg=2))
    qt = spectral_sort_basis(torch.as_tensor(a), levels=4, min_seg=2, om=om)
    assert qt.shape == (2, 96, 96) and qt.dtype == torch.as_tensor(a).dtype
    assert np.abs(qt.numpy() - qj).max() <= atol
    gj = np.asarray(jdc_precondition(jnp.asarray(a), levels=4, min_seg=2))
    gt = dc_precondition_xla(torch.as_tensor(a), levels=4, min_seg=2, om=om)
    assert np.abs(gt.numpy() - gj).max() <= 4 * atol   # entries of a are ~4


@pytest.mark.parametrize("dtype, atol", [(np.float64, 1e-9), (np.float32, 2e-2)])
@pytest.mark.parametrize("n, levels, min_seg, refine",
                         [(96, 4, 2, 0), (128, 7, 2, 0), (96, 5, 16, 1), (128, 6, 16, 0)])
def test_dc_plain_matches_pallas_interpret(n, levels, min_seg, refine, dtype, atol):
    a = _spd(n + levels, 2, n, dtype)
    om = _probe(n, dtype)
    gj, tj, sj = dc_precondition_tpu(jnp.asarray(a), levels=levels, min_seg=min_seg,
                                     interpret=True, return_t=True, return_seg=True,
                                     refine=refine)
    gt, tt, st = dc_precondition_plain(torch.as_tensor(a), levels=levels,
                                       min_seg=min_seg, return_t=True,
                                       return_seg=True, refine=refine, om=om)
    assert gt.shape == (2, n, n) and tt.shape == (2, n, n)
    assert st.shape == (2, n, 1) and st.dtype == torch.int32
    # the segment ids are integers decided by rounded ranks: equal
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.abs(gt.numpy() - np.asarray(gj)).max() <= 4 * atol
    assert np.abs(tt.numpy() - np.asarray(tj)).max() <= 4 * atol
    # the dispatcher on a CPU tensor is the plain version; outputs ordered
    # (g, [t], [seg])
    g2, s2 = dc_precondition(torch.as_tensor(a), levels=levels, min_seg=min_seg,
                             return_seg=True, refine=refine, om=om)
    assert torch.equal(g2, gt) and torch.equal(s2, st)
    g3 = dc_precondition(torch.as_tensor(a), levels=levels, min_seg=min_seg,
                         refine=refine, om=om)
    assert torch.is_tensor(g3) and torch.equal(g3, gt)


def test_default_probe_is_fixed_and_shared():
    p1 = default_probe(64, torch.float32, "cpu")
    p2 = default_probe(64, torch.float32, "cpu")
    assert torch.equal(p1, p2) and p1.shape == (64, 64)
    assert abs(float(p1.mean())) < 0.1 and abs(float(p1.std()) - 1.0) < 0.1
    a = torch.as_tensor(_spd(1, 1, 64))
    assert torch.equal(dc_precondition_plain(a, levels=3),
                       dc_precondition_plain(a, levels=3, om=p1))
    with pytest.raises(ValueError, match="probe"):
        dc_precondition_plain(a, levels=3, om=np.zeros((8, 8)))


def test_basis_orthonormal_concentrating_and_sorted():
    a = _spd(2, 2, 128)
    A = torch.as_tensor(a)
    Q = spectral_sort_basis(A, levels=5, min_seg=2)
    # the reference's gates: orthonormal to 1e-4, off-diagonal mass to a quarter
    assert float((Q.mT @ Q - torch.eye(128)).abs().max()) < 1e-4
    T = (Q.mT @ A @ Q).numpy().astype(np.float64)
    assert _offmass(T) < 0.25 * _offmass(a.astype(np.float64))
    d = np.diagonal(T, axis1=-2, axis2=-1)
    lam = np.linalg.eigvalsh(a.astype(np.float64))
    for b in range(2):
        assert np.corrcoef(d[b], lam[b])[0, 1] > 0.98


def test_degenerate_clusters_keep_orthogonality():
    n = 128
    w = np.concatenate([np.ones(40), np.ones(40) * (1 + 1e-4), np.linspace(2.0, 3.0, 48)])
    q, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((n, n)))
    a = ((q * w) @ q.T)[None]
    A = torch.as_tensor((0.5 * (a + a.transpose(0, 2, 1))).astype(np.float32))
    Q = spectral_sort_basis(A, levels=5, min_seg=2)
    assert float((Q.mT @ Q - torch.eye(n)).abs().max()) < 1e-4


@pytest.mark.parametrize("n, levels", [(96, 4), (128, 6), (192, 8)])
def test_plain_panel_invariant_and_concentration(n, levels):
    a = _spd(3 + n, 2, n)
    A = torch.as_tensor(a)
    g = dc_precondition_plain(A, levels=levels, min_seg=2).numpy().astype(np.float64)
    a64 = a.astype(np.float64)
    a2 = a64 @ a64
    # G0^T G0 == A^2 (the implicit Q is orthonormal): 1e-4, the reference's gate
    assert np.abs(g.transpose(0, 2, 1) @ g - a2).max() / np.abs(a2).max() < 1e-4
    # G0 G0^T = Q^T A^2 Q: its off-diagonal mass shrinks against A^2's
    assert _offmass(g @ g.transpose(0, 2, 1)) < 0.25 * _offmass(a2)
    # the guard passes a healthy panel
    _, bad = _guard_warm_start(A, torch.as_tensor(g.astype(np.float32)))
    assert bad.tolist() == [False, False]


def test_t_export_invariants():
    rng = np.random.default_rng(7)
    B, n = 3, 128
    w = rng.standard_normal((B, n, n)).astype(np.float32) / np.sqrt(n)
    a = (w @ np.swapaxes(w, -1, -2) + 0.05 * np.eye(n, dtype=np.float32))
    A = torch.as_tensor(a.astype(np.float32))
    g_only = dc_precondition_plain(A, levels=2, min_seg=2)
    g, t = dc_precondition_plain(A, levels=2, min_seg=2, return_t=True)
    assert torch.equal(g, g_only)
    t64 = t.numpy().astype(np.float64)
    g64 = g.numpy().astype(np.float64)
    assert np.abs(t64 - np.swapaxes(t64, -1, -2)).max() < 1e-4
    lam_a = np.linalg.eigvalsh(a.astype(np.float64))
    scale = np.abs(lam_a).max()
    assert np.abs(lam_a - np.linalg.eigvalsh(t64)).max() / scale < 1e-4
    assert np.abs(g64 @ np.swapaxes(g64, -1, -2) - t64 @ t64).max() / scale ** 2 < 1e-4


def test_sign_and_polar_building_blocks():
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    lam = np.concatenate([-np.linspace(0.05, 1.0, 16), np.linspace(0.05, 1.0, 16)])
    X = torch.as_tensor(((q * lam) @ q.T)[None])
    E = _msign(X, torch.ones(1, 32, 32, dtype=X.dtype))
    ref = (q * np.sign(lam)) @ q.T
    assert np.abs(E.numpy()[0] - ref).max() < 1e-2      # 1 +- 1e-3 on [8e-5, 1]
    Y = torch.as_tensor(rng.standard_normal((1, 32, 32)) / 12.0)
    Q = _polar_orth(Y)
    assert float((Q.mT @ Q - torch.eye(32, dtype=Q.dtype)).abs().max()) < 1e-6


def test_pathological_spectra_through_the_warm_start():
    # scaled identity: every split is maximally soft
    A = (3.0 * torch.eye(96))[None]
    lam, V = jacobi_eigh(A, precondition=True)
    assert float((lam - 3.0).abs().max()) < 1e-5
    assert float((V.mT @ V - torch.eye(96)).abs().max()) < 5e-6
    # rank-deficient PSD: half the spectrum exactly zero
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((96, 96)))
    w = np.concatenate([np.zeros(48), np.linspace(1, 2, 48)])
    a3 = ((q * w) @ q.T)[None]
    a3 = (0.5 * (a3 + a3.transpose(0, 2, 1))).astype(np.float32)
    lam3, _ = jacobi_eigh(torch.as_tensor(a3), precondition=True)
    assert np.abs(lam3.numpy() - np.linalg.eigvalsh(a3.astype(np.float64))).max() < 5e-5
    # negative definite, odd n, odd batch
    a = np.random.default_rng(3).standard_normal((3, 97, 97)).astype(np.float32) / 10
    a4 = -(a @ a.transpose(0, 2, 1)) - np.eye(97, dtype=np.float32)
    lam4, _ = jacobi_eigh(torch.as_tensor(a4), precondition=True)
    assert np.abs(lam4.numpy() - np.linalg.eigvalsh(a4.astype(np.float64))).max() < 5e-5


def test_broken_preconditioner_fails_safe(monkeypatch):
    def broken(a, **kw):
        n = a.shape[-1]
        q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((n, n)))
        q[:, 0] = 0.0  # rank-deficient "orthogonal" factor
        return torch.as_tensor(q.T.astype(np.float32)) @ a

    monkeypatch.setattr(dcmod, "dc_precondition", broken)
    a = _spd(21, 2, 96)
    A = torch.as_tensor(a)
    lam, V, info = jacobi_eigh(A, precondition=True, return_info=True)
    assert info["guard_bad"].tolist() == [True, True]   # sent back to the cold start
    assert np.abs(lam.numpy() - np.linalg.eigvalsh(a.astype(np.float64))).max() < 5e-5
    assert float((A @ V - V * lam[:, None, :]).abs().max()) < 5e-4
    # a NaN panel is flagged too (the negated <=)
    g0 = torch.full((2, 96, 96), float("nan"))
    panel, bad = _guard_warm_start(A, g0)
    assert bad.tolist() == [True, True] and torch.equal(panel, A)


def test_window_and_rejections():
    assert fits_dc_kernel(64, 256, 8, torch.float32)           # config 2
    assert fits_dc_kernel(8, 1024, 10, torch.float32)
    assert not fits_dc_kernel(8, 1040, 10, torch.float32)
    assert not fits_dc_kernel(64, 256, 8, torch.float64)
    assert not fits_dc_kernel(4096, 1024, 10, torch.float32)   # workspace budget
    a = torch.eye(16)[None]
    # per_level=True takes the per-level path (tests/test_torch_dc_level.py),
    # which returns G0 only
    with pytest.raises(ValueError, match="per-level path returns G0 only"):
        dc_precondition(a, per_level=True, return_t=True)
    with pytest.raises(RuntimeError):
        dc_precondition_cuda(a)                                # not a CUDA tensor
    with pytest.raises(RuntimeError):
        dc_precondition_plain(torch.zeros(2, 3, 4))
    with pytest.raises(RuntimeError):
        dc_precondition_plain(a.to(torch.complex64))
    assert dc_precondition_cuda.launches == 0


@pytest.mark.parametrize("n, levels, min_seg, refine", [(48, 5, 2, 0), (40, 3, 4, 1)])
def test_plain_resumes_from_its_exports(n, levels, min_seg, refine):
    # state=(t, seg) after every level reproduces one call of all the levels
    # bit for bit: the same arithmetic on the same float32 carries
    a = torch.as_tensor(_spd(31, 2, n))
    kw = dict(min_seg=min_seg, refine=refine, return_t=True, return_seg=True)
    g, t, s = dc_precondition_plain(a, levels=levels, **kw)
    g1, state = a, None
    for _ in range(levels):
        g1, t1, s1 = dc_precondition_plain(g1, levels=1, state=state, **kw)
        state = (t1, s1)
    assert torch.equal(g, g1) and torch.equal(t, t1) and torch.equal(s, s1)
    with pytest.raises(ValueError, match="state"):
        dc_precondition_plain(a, levels=1, state=(t[:, :8, :8], s))


def test_level_by_level_check_of_the_card_run(monkeypatch):
    # chip_smoke.py holds the kernel against the plain version one level at a
    # time from the kernel's own state; here the plain version stands in for
    # the kernel, so every difference is 0 and the check must pass, and a
    # kernel with a wrong level (G0 of the last level rotated) must fail it
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    a = torch.as_tensor(_spd(32, 2, 48))
    monkeypatch.setattr(dcmod, "dc_precondition_cuda", dc_precondition_plain)
    (g, t, s), max_abs, rows = smoke.dc_level_by_level(torch, a, 4, 2)
    g0, t0, s0 = dc_precondition_plain(a, levels=4, min_seg=2, return_t=True,
                                       return_seg=True)
    assert torch.equal(g, g0) and torch.equal(t, t0) and torch.equal(s, s0)
    assert max_abs == 0.0 and len(rows) == 4

    def wrong(a_, *, levels, **kw):
        g_, t_, s_ = dc_precondition_plain(a_, levels=levels, **kw)
        return ((g_ + 1e-3 * g_.roll(1, -2)) if levels == 3 else g_), t_, s_

    monkeypatch.setattr(dcmod, "dc_precondition_cuda", wrong)
    with pytest.raises(AssertionError, match="after level 3"):
        smoke.dc_level_by_level(torch, a, 4, 2)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("n, tile, levels, min_seg, refine", [
    (64, 16, 6, 2, 0),     # down to frozen pairs
    (96, 32, 4, 3, 1),     # odd min_seg, a refinement pass
    (130, 32, 4, 16, 0),   # ragged last band, early freeze
    (256, 64, 3, 2, 0),    # config 2's n at the kernel's band
])
def test_banded_plain_levels_give_the_dense_levels(n, tile, levels, min_seg, refine, dtype, tol):
    # one plain level whose products run only the kernel's k-ranges (both
    # bands for the block-diagonal products, the column band for T Q with T
    # unmasked, the row band for Q^T (T Q) and Q^T G0) gives the dense
    # level's ids, T and G0, level after level from one state
    a = torch.as_tensor(_spd(n + tile, 2, n, np.float64)).to(dtype)
    kw = dict(levels=1, min_seg=min_seg, refine=refine, return_t=True, return_seg=True)
    g, state = a, None
    unmasked = frozen = False
    for _ in range(levels):
        gd, td, sd = dc_precondition_plain(g, state=state, **kw)
        gb, tb, sb = dc_precondition_plain(g, state=state, tile=tile, **kw)
        assert torch.equal(sb, sd)
        for x, y in ((tb, td), (gb, gd)):
            assert float((x - y).abs().max()) <= tol * float(y.abs().max())
        # the carry is dense across the new segments: T Q reads all of T
        unmasked |= bool((td[sd != sd.mT] != 0).any())
        frozen |= bool(((sd == sd.mT).sum(-1) <= min_seg).any())
        g, state = gd, (td, sd)
    assert unmasked
    assert frozen or n // 2 ** levels > min_seg


def test_default_probe_is_drawn_once_and_left_unchanged():
    # one draw per (n, dtype, device), shared by every caller, which only reads it
    p1 = default_probe(48, torch.float32, "cpu")
    p2 = default_probe(48, torch.float32, torch.device("cpu"))
    assert p2 is p1
    assert default_probe(48, torch.float64, "cpu") is not p1
    assert torch.equal(default_probe(48, torch.float64, "cpu").float(), p1)
    before = p1.clone()
    a = torch.as_tensor(_spd(2, 2, 48))
    dc_precondition(a, levels=3, min_seg=2, refine=1)
    dc_precondition_plain(a, levels=2, return_t=True, return_seg=True)
    spectral_sort_basis(a, levels=2)
    from xitorch_tpu_torch.ops.dc_level import dc_precondition_per_level
    dc_precondition_per_level(a, levels=2)
    assert default_probe(48, torch.float32, "cpu") is p1
    assert torch.equal(p1, before)
