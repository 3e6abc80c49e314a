"""The port's one-sided Jacobi sweep, jacobi_eigh and jacobi_svd against the
JAX package (its Pallas kernels in interpret mode) and numpy, on the same
numpy inputs: the cold sweep, the warm start with its correction and guard,
and complex input on packed planes.  On the CPU the sweep is the plain
PyTorch version; the CUDA kernels are held against it in
tests/test_torch_kernels_cuda.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.ops.jacobi_eigh import _guard_warm_start as jguard_warm_start
from xitorch_tpu.ops.jacobi_eigh import _pallas_g_panel
from xitorch_tpu.ops.jacobi_eigh import _rot_correct as jrot_correct
from xitorch_tpu.ops.jacobi_eigh import jacobi_eigh as jjacobi_eigh
from xitorch_tpu.ops.jacobi_eigh import jacobi_svd as jjacobi_svd
from xitorch_tpu_torch.ops import jacobi_eigh as jmod
from xitorch_tpu_torch.ops.dc_kernel import dc_precondition_plain
from xitorch_tpu_torch.ops.jacobi_eigh import (
    _guard_warm_start, _max_cos2, _rot_correct, fits_jacobi_sweep, in_jacobi_window,
    jacobi_eigh, jacobi_svd, jacobi_sweep, jacobi_sweep_cuda, jacobi_sweep_plain,
    use_jacobi_for, use_jacobi_svd_for,
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
    # the deflated path runs (padded to 64) and gives the cold sweep's eigenvalues
    ld, _ = jacobi_eigh(a, deflate=True)
    assert float((ld - jacobi_eigh(a)[0]).abs().max()) <= 1e-5
    # the warm start is real-only, as in the reference
    with pytest.raises(ValueError, match="complex"):
        jacobi_eigh(a.to(torch.complex64), precondition=True)
    # precondition=None and False are the cold sweep; True gives the same
    # eigenvalues (the warm start changes the sweep count, never the answer)
    l0, _ = jacobi_eigh(a, precondition=None)
    l1, _ = jacobi_eigh(a, precondition=False, deflate=False)
    l2, _ = jacobi_eigh(a, precondition=True)
    assert torch.equal(l0, l1) and float((l2 - l0).abs().max()) <= 1e-6
    with pytest.raises(RuntimeError):
        jacobi_sweep_plain(torch.zeros(1, 3, 4), 18, 1e-5)   # odd number of rows
    with pytest.raises(RuntimeError):
        jacobi_sweep_plain(torch.zeros(1, 4, 5), 18, 1e-5, complexpair=True)  # odd width
    with pytest.raises(RuntimeError):
        jacobi_sweep_cuda(torch.zeros(1, 16, 16), 18, 1e-5)  # not a CUDA tensor
    with pytest.raises(RuntimeError):
        jacobi_sweep_cuda(torch.zeros(1, 16, 32), 18, 1e-5, complexpair=True)


def test_gates_and_window():
    assert use_jacobi_for(torch.zeros(2, 256, 256)) is False       # CPU tensor
    assert use_jacobi_svd_for(torch.zeros(2, 256, 128)) is False
    assert use_jacobi_for(torch.zeros(2, 256, 256, dtype=torch.complex64)) is False
    assert fits_jacobi_sweep(256, 256, torch.float32)              # config 2
    assert fits_jacobi_sweep(128, 256, torch.float32)
    assert fits_jacobi_sweep(1024, 4096, torch.float32)
    assert not fits_jacobi_sweep(1040, 64, torch.float32)
    assert not fits_jacobi_sweep(64, 4100, torch.float32)
    assert not fits_jacobi_sweep(63, 64, torch.float32)
    assert not fits_jacobi_sweep(64, 64, torch.float64)
    # packed complex planes: even width, half-width at most 2048
    assert fits_jacobi_sweep(256, 512, torch.float32, True)
    assert fits_jacobi_sweep(1024, 4096, torch.float32, True)
    assert not fits_jacobi_sweep(64, 131, torch.float32, True)
    # the window symeig's default routing asks about, by shape and type
    assert in_jacobi_window(256, torch.float32) and in_jacobi_window(256, torch.complex64)
    assert in_jacobi_window(64, torch.float32) and in_jacobi_window(1024, torch.complex64)
    assert not in_jacobi_window(63, torch.float32)
    assert not in_jacobi_window(1025, torch.float32)
    assert not in_jacobi_window(256, torch.float64)
    assert not in_jacobi_window(256, torch.complex128)
    assert jmod.ENABLED is True and jacobi_sweep_cuda.launches == 0
    assert jacobi_sweep_cuda.launches_complex == 0


@pytest.mark.parametrize("B, n, width, expect", [
    (64, 256, 256, 2),     # config 2: a 256 KB panel, two 128 KB slices, 128 CTAs
    (64, 128, 256, 2),     # config 2's rectangular panel fits one CTA; 2 fill the card
    (1, 256, 256, 8),      # batch 1: grown to 8 CTAs a matrix
    (2, 256, 256, 8),
    (1, 64, 64, 8),        # path B's factor panels
    (1, 128, 128, 8),
    (1, 512, 512, 8),      # a 1 MB panel needs 8
    (8, 512, 512, 8),      # the per-level warm path's sweeps
    (8, 768, 768, 16),     # 2.36 MB: only the non-portable 16 holds it
    (32, 768, 768, 16),    # several waves, but no smaller cluster holds it
    (3, 32, 32, 8),        # each CTA keeps one float4 column
    (1, 16, 8, 2),         # no more CTAs than float4 columns
    (1, 1024, 1024, 0),    # no cluster holds it: the device-memory path
    (4, 1024, 4096, 0),
])
def test_sweep_cluster_chooser(B, n, width, expect):
    c = jmod.sweep_cluster(B, n, width)
    assert c == expect
    if c:
        # the slices fit the shared memory a block may opt in to on the H100,
        # and the next smaller cluster's would not (or it is 1)
        assert jmod.cluster_smem_bytes(n, width, c) <= 232448
        assert B * c <= 132 or c == min(
            cc for cc in (1, 2, 4, 8, 16) if jmod.cluster_smem_bytes(n, width, cc) <= 232448)
    # a shared-memory limit of 0 forces the device-memory path
    assert jmod.sweep_cluster(B, n, width, smem_block=0) == 0


def test_sweep_cluster_chooser_limits():
    # the formula of csrc/jacobi_sweep.cu: 256 rows of 33 float4 (32 held,
    # the odd stride), two 64 x 64 tiles (more than 2 x 2 x 128 partials),
    # the norms and the coefficients, 64 words; at 768 on 16 CTAs the
    # partials take the area
    assert jmod.cluster_smem_bytes(256, 256, 2) == 256 * 33 * 16 + (8192 + 512 + 64) * 4
    assert jmod.cluster_smem_bytes(768, 768, 16) == \
        768 * 13 * 16 + (16 * 768 + 2 * 768 + 64) * 4
    # fewer SMs or less shared memory change the choice; the occupancy
    # query stops the growth where the card holds fewer clusters than B
    assert jmod.sweep_cluster(1, 256, 256, sm_count=4) == 4
    assert jmod.sweep_cluster(64, 256, 256, smem_block=120000) == 4
    assert jmod.sweep_cluster(1, 256, 256, active_clusters=lambda c: 1 if c <= 4 else 0) == 4
    assert jmod.sweep_cluster(4, 128, 128, active_clusters=lambda c: 132 // c) == 8
    assert jmod.sweep_cluster(4, 128, 128, active_clusters=lambda c: 3) == 1


# the complex kernel's chooser: each CTA holds the same columns of both
# planes, so a packed (n, 2 hw) panel needs the slices of an (n, 2 hw) real
# one, plus the gauge's tile of two planes and two words a pair of partials
@pytest.mark.parametrize("B, n, width, expect", [
    (64, 256, 512, 3),     # config 2: 184 KB slices on 3 CTAs, 192 CTAs
    (64, 128, 512, 2),     # the Hestenes rectangle of chip_smoke.py
    (1, 256, 512, 8),      # batch 1: 3 grown to 4 and 8
    (8, 512, 1024, 16),    # 139 KB slices only at 16 CTAs
    (1, 768, 1536, 0),     # 307 KB slices even at 16: device memory
    (32, 256, 512, 4),     # 32 x 8 CTAs would pass the 132 SMs
    (16, 256, 512, 8),     # 16 x 8 = 128 CTAs
    (1, 64, 128, 8),       # two float4 of each plane a CTA
    (3, 32, 64, 8),        # one float4 of each plane a CTA
    (2, 128, 256, 8),      # fits one CTA, grown to 8
    (2, 16, 1000, 8),      # wide rows
    (4, 1024, 2048, 0),    # beyond every cluster
])
def test_complex_sweep_cluster_chooser(B, n, width, expect):
    c = jmod.sweep_cluster(B, n, width, complexpair=True)
    assert c == expect
    fit = [cc for cc in (1, 2, 3, 4, 8, 16)
           if jmod.cluster_smem_bytes(n, width, cc, complexpair=True) <= 232448]
    if c:
        # the slices fit the shared memory a block may opt in to on the
        # H100, and the next smaller cluster's do not (or it is 1)
        assert jmod.cluster_smem_bytes(n, width, c, complexpair=True) <= 232448
        assert fit[0] == 1 or jmod.cluster_smem_bytes(
            n, width, fit[0] // 2, complexpair=True) > 232448
        assert B * c <= 132 or c == fit[0]
    else:
        assert not fit
    # a shared-memory limit of 0 forces the device-memory path
    assert jmod.sweep_cluster(B, n, width, smem_block=0, complexpair=True) == 0


def test_complex_cluster_smem_bytes_by_hand():
    # the formula of csrc/jacobi_sweep_complex.cu with one tile buffer: 256
    # rows of 16 + 16 float4 at the odd stride 33; one 64 x 64 tile of two
    # planes (more than the 2 x 4 x 128 x 2 partials); the norms, 4
    # coefficients a pair, 64 words
    assert jmod.cluster_smem_bytes(256, 512, 4, complexpair=True) == \
        256 * 33 * 16 + (2 * 64 * 64 + 256 + 4 * 128 + 64) * 4
    # config 2 on 3 CTAs: 22 + 22 float4 at stride 45, inside 227 KB
    assert jmod.cluster_smem_bytes(256, 512, 3, complexpair=True) == \
        256 * 45 * 16 + (2 * 64 * 64 + 3 * 256 + 64) * 4 <= 232448
    # at 512 rows on 16 CTAs: 8 + 8 float4 at stride 17, and the partials
    # (2 x 16 x 256 x 2 words) larger than the tile
    assert jmod.cluster_smem_bytes(512, 1024, 16, complexpair=True) == \
        512 * 17 * 16 + (2 * 16 * 512 + 3 * 512 + 64) * 4
    # the real layout is unchanged by the new argument
    assert jmod.cluster_smem_bytes(256, 256, 2, complexpair=False) == \
        jmod.cluster_smem_bytes(256, 256, 2)


@pytest.mark.parametrize("kw, expect", [
    ({"sm_count": 15}, 4),                                  # 2 x 8 CTAs pass 15 SMs
    ({"smem_block": 150000}, 8),                            # 4 no longer fits: 8 at once
    ({"active_clusters": lambda c: 30 if c <= 4 else 0}, 4),  # the card holds no cluster of 8
    ({"active_clusters": lambda c: 1}, 3),                  # nor two of any size
])
def test_complex_sweep_cluster_limits(kw, expect):
    # the SM count, the shared memory a block and the occupancy query act
    # on the complex choice as on the real one: 2 matrices of config 2
    assert jmod.sweep_cluster(2, 256, 512, complexpair=True, **kw) == expect
    assert jmod.sweep_cluster(2, 256, 512, complexpair=True) == 8
    # 32 matrices: the card holds 39 clusters of 3 but 30 of 4 (the H100's
    # occupancy query), so they stay on 3, in one wave
    held = {3: 39, 4: 30, 8: 15}
    assert jmod.sweep_cluster(32, 256, 512, complexpair=True,
                              active_clusters=held.get) == 3


# ------------------------------------------------------------------
# the warm start: correction, guard, and the whole route
# ------------------------------------------------------------------

def _spd(seed, B, n):
    a = np.random.default_rng(seed).standard_normal((B, n, n)) / math.sqrt(n)
    return (a @ a.transpose(0, 2, 1) + 2.0 * np.eye(n)).astype(np.float32)


def test_guard_and_rot_correct_match_jax():
    a = _spd(0, 3, 64)
    g0 = dc_precondition_plain(torch.as_tensor(a), levels=6, min_seg=2)
    # same float32 products on both sides: agreement to rounding of a few
    # dozen (64, 64) products on entries of size ~4
    gj = np.asarray(jrot_correct(jnp.asarray(g0.numpy())))
    gt = _rot_correct(g0)
    assert np.abs(gt.numpy() - gj).max() <= 1e-4
    # the correction lowers the coupling it is there to kill
    assert float(_max_cos2(gt).max()) < float(_max_cos2(g0).max())
    # break one panel: guard flags it on both sides and hands back a_shift
    bad_panel = gt.clone()
    bad_panel[1, 0] = 0.0
    pj, bj = jguard_warm_start(jnp.asarray(a), jnp.asarray(bad_panel.numpy()))
    pt, bt = _guard_warm_start(torch.as_tensor(a), bad_panel)
    assert bt.tolist() == np.asarray(bj).tolist() == [False, True, False]
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert torch.equal(pt[1], torch.as_tensor(a)[1]) and torch.equal(pt[0], gt[0])


def test_rot_correct_excludes_exactly_degenerate_pairs():
    # identical uncoupled rows: denom == 0 and T_ij == 0 must not become 0/0
    g0 = torch.diag_embed(torch.tensor([[2.0, 2.0, 2.0, 3.0]]))
    out = _rot_correct(g0)
    assert bool(torch.isfinite(out).all())
    assert float((out - g0).abs().max()) <= 1e-6


# n = 129 pads to 144; float32 gates of the reference's tests (5e-5 of the
# eigenvalues, 5e-4 residual, 5e-6 orthogonality)
@pytest.mark.parametrize("n", [96, 129])
def test_warm_start_matches_jax_and_cold(n):
    a = _spd(4, 2, n)
    A = torch.as_tensor(a)
    lj, _ = jjacobi_eigh(jnp.asarray(a), interpret=True, precondition=True)
    lw, Vw, iw = jacobi_eigh(A, precondition=True, return_info=True)
    lc, Vc, ic = jacobi_eigh(A, precondition=False, return_info=True)
    l0 = np.linalg.eigvalsh(a.astype(np.float64))
    assert np.abs(lw.numpy() - np.asarray(lj)).max() < 5e-5
    assert np.abs(lw.numpy() - l0).max() < 5e-5
    assert float((lw - lc).abs().max()) < 5e-5
    rw = float((A @ Vw - Vw * lw[:, None, :]).abs().max())
    rc = float((A @ Vc - Vc * lc[:, None, :]).abs().max())
    assert rw < 5e-4 and rw < max(2.0 * rc, 1e-5)
    assert float((Vw.mT @ Vw - torch.eye(n)).abs().max()) < 5e-6
    # the point of the warm start: fewer sweeps wherever the guard let it in
    warm = ~iw["guard_bad"]
    assert iw["sweeps"].shape == (2,) and ic["sweeps"].shape == (2,)
    assert bool((iw["sweeps"][warm] < ic["sweeps"][warm]).all())
    assert "guard_bad" not in ic


def test_warm_start_clustered_spectrum():
    n = 96
    w = np.concatenate([np.full(30, 1.0), np.full(30, 1.0 + 2e-4), np.linspace(1.5, 2.0, 36)])
    q, _ = np.linalg.qr(np.random.default_rng(9).standard_normal((n, n)))
    a = ((q * w) @ q.T)[None]
    a = (0.5 * (a + a.transpose(0, 2, 1))).astype(np.float32)
    lam, V = jacobi_eigh(torch.as_tensor(a), precondition=True)
    assert np.abs(lam.numpy() - np.linalg.eigvalsh(a.astype(np.float64))).max() < 5e-5
    assert float((torch.as_tensor(a) @ V - V * lam[:, None, :]).abs().max()) < 5e-4


# ------------------------------------------------------------------
# complex input
# ------------------------------------------------------------------

def _herm(seed, B, n, cdtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    return ((a + a.conj().transpose(0, 2, 1)) / 2).astype(cdtype)


def _hgauge(g, hw):
    """Hermitian Gram gauge of packed planes, in float64 numpy."""
    z = g[..., :hw].astype(np.float64) + 1j * g[..., hw:].astype(np.float64)
    gram = z @ z.conj().transpose(0, 2, 1)
    nrm = np.real(np.einsum("bii->bi", gram))
    ratio = np.abs(gram) ** 2 / np.maximum(nrm[:, :, None] * nrm[:, None, :], 1e-300)
    ratio[:, np.arange(g.shape[1]), np.arange(g.shape[1])] = 0.0
    return ratio.max()


@pytest.mark.parametrize("B, n, hw", [(2, 32, 32), (2, 16, 24)])
def test_complex_sweep_plain_matches_pallas_interpret(B, n, hw):
    rng = np.random.default_rng(n + hw)
    z = rng.standard_normal((B, n, hw)) + 1j * rng.standard_normal((B, n, hw))
    if n == hw:   # hermitian positive definite, as jacobi_eigh hands the kernel
        z = z @ z.conj().transpose(0, 2, 1) / math.sqrt(n) + 2.0 * np.eye(n)
        planes = np.concatenate([z.real, -z.imag], -1).astype(np.float32)
    else:
        planes = np.concatenate([z.real, z.imag], -1).astype(np.float32)
    tol = float(np.finfo(np.float32).eps) * 4.0 * math.sqrt(n)
    gj = np.asarray(_pallas_g_panel(jnp.asarray(planes), 18, tol, True, True))
    gt, st = jacobi_sweep_plain(torch.as_tensor(planes), 18, tol, complexpair=True)
    g = gt.numpy()
    assert gt.shape == planes.shape and st.shape == (B,)
    assert 1 <= int(st.min()) and int(st.max()) <= 18
    assert float(_max_cos2(gt, True).max()) <= tol * tol
    assert _hgauge(g, hw) <= 1.5 * tol * tol and _hgauge(gj, hw) <= 1.5 * tol * tol
    # rows are only rotated and re-phased: G^H G keeps the input's
    z0 = planes[..., :hw].astype(np.float64) + 1j * planes[..., hw:].astype(np.float64)
    ref = z0.conj().transpose(0, 2, 1) @ z0
    for G in (g, gj):
        zz = G[..., :hw].astype(np.float64) + 1j * G[..., hw:].astype(np.float64)
        inv = np.linalg.norm(zz.conj().transpose(0, 2, 1) @ zz - ref) / np.linalg.norm(ref)
        assert inv <= 5e-6
    nt = np.sort(np.linalg.norm(g, axis=-1), axis=-1)
    nj = np.sort(np.linalg.norm(gj, axis=-1), axis=-1)
    assert np.abs(nt - nj).max() <= 1e-5 * nj.max()


# complex64 under the reference's 3e-5 gate (tests/test_jacobi_eigh.py);
# complex128 to rounding
@pytest.mark.parametrize("cdtype, rtol", [(np.complex64, 3e-5), (np.complex128, 1e-12)])
@pytest.mark.parametrize("shape", [(2, 20), (2, 48)])
def test_complex_jacobi_eigh_matches_jax_and_numpy(shape, cdtype, rtol):
    B, n = shape
    a = _herm(n, B, n, cdtype)
    lj, _ = jjacobi_eigh(jnp.asarray(a), interpret=True)
    lt, vt = jacobi_eigh(torch.as_tensor(a))
    assert lt.shape == (B, n) and vt.shape == (B, n, n)
    assert not lt.is_complex() and vt.is_complex()
    l0 = np.linalg.eigvalsh(a.astype(np.complex128))
    scale = np.abs(l0).max()
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= rtol * scale
    assert np.abs(lt.numpy() - l0).max() <= rtol * scale
    v = vt.numpy().astype(np.complex128)
    assert np.abs(a.astype(np.complex128) @ v - v * lt.numpy()[:, None, :]).max() \
        <= 5 * rtol * scale
    assert np.abs(v.conj().transpose(0, 2, 1) @ v - np.eye(n)).max() <= 5 * rtol


@pytest.mark.parametrize("cdtype, atol", [(np.complex64, 3e-5), (np.complex128, 1e-12)])
@pytest.mark.parametrize("shape", [(2, 40, 24), (2, 24, 40), (2, 16, 16)])
def test_complex_jacobi_svd_matches_jax_and_numpy(shape, cdtype, atol):
    rng = np.random.default_rng(sum(shape))
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(cdtype)
    _, sj, _ = jjacobi_svd(jnp.asarray(a), interpret=True)
    u, s, v = jacobi_svd(torch.as_tensor(a))
    m, n = shape[-2:]
    r = min(m, n)
    assert u.shape == (2, m, r) and s.shape == (2, r) and v.shape == (2, n, r)
    assert u.is_complex() and not s.is_complex()
    s0 = np.linalg.svd(a.astype(np.complex128), compute_uv=False)[..., ::-1]
    smax = s0.max()
    assert np.abs(s.numpy() - np.asarray(sj)).max() <= atol * smax
    assert np.abs(s.numpy() - s0).max() <= atol * smax
    rec = (u * s[..., None, :]) @ v.mH
    assert float((rec - torch.as_tensor(a)).abs().max()) <= 10 * atol * smax
    eye = torch.eye(r, dtype=u.dtype)
    assert float((u.mH @ u - eye).abs().max()) <= 10 * atol
    assert float((v.mH @ v - eye).abs().max()) <= 10 * atol


def test_complex_svd_rank_deficient_gets_orthonormal_completion():
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((2, 24, 2)) + 1j * rng.standard_normal((2, 24, 2))) @ \
        (rng.standard_normal((2, 2, 12)) + 1j * rng.standard_normal((2, 2, 12)))
    u, s, v = jacobi_svd(torch.as_tensor(a))
    s0 = np.linalg.svd(a, compute_uv=False)[..., ::-1]
    assert np.abs(s.numpy() - s0).max() <= 1e-9
    eye = torch.eye(12, dtype=u.dtype)
    assert float((u.mH @ u - eye).abs().max()) <= 1e-9
    assert float((v.mH @ v - eye).abs().max()) <= 1e-9
    assert float(((u * s[..., None, :]) @ v.mH - torch.as_tensor(a)).abs().max()) <= 1e-9
