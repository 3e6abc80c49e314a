"""The per-level divide-and-conquer warm start of the port (one level a
launch, ``ops/dc_level.py``) against the JAX package's per-level Pallas
kernel in interpret mode, on the same numpy inputs with the reference's own
probe carried across; the kernel's zero-block rule (products over the band
ranges of the level's segments give the dense level) and its order of
products, all in IEEE arithmetic, through the plain version; the routing and
padding of ``jacobi_eigh`` on that path; and the sweep-kernel gate of
``ops/jacobi_eigh.py``, which the card's measured table makes a function of
batch and n.  On the CPU the plain
versions run and no kernel launches; the CUDA kernel is held against its
plain version in chip_smoke.py and tests/test_torch_kernels_cuda.py."""
import importlib
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference's ops package exports a function of each module's name, so
# the modules are imported by name
jdcmod = importlib.import_module("xitorch_tpu.ops.dc_kernel")
jjmod = importlib.import_module("xitorch_tpu.ops.jacobi_eigh")
from xitorch_tpu_torch.ops import dc_level as dlmod
from xitorch_tpu_torch.ops import jacobi_eigh as jmod
from xitorch_tpu_torch.ops.dc_kernel import dc_precondition
from xitorch_tpu_torch.ops.dc_level import (
    band_ranges, dc_level_cuda, dc_level_plain, dc_precondition_per_level,
)

torch.set_num_threads(1)


def _spd(seed, B, n, dtype=np.float32):
    a = np.random.default_rng(seed).standard_normal((B, n, n)) / math.sqrt(n)
    return (a @ a.transpose(0, 2, 1) + 2.0 * np.eye(n)).astype(dtype)


def _probe(n, dtype):
    """The reference's own draw of the mixer, as a numpy array."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1803), (n, n), dtype))


# float64: the same arithmetic on both sides, so they agree to rounding
# amplified by the 72 products of a level; float32: the soft directions at a
# split amplify rounding differences to ~1e-3 of entries of size ~1 (the
# reference's own kernel-against-XLA test allows 0.1), the single-shot
# port's bound
@pytest.mark.parametrize("dtype, atol", [(np.float64, 1e-9), (np.float32, 2e-2)])
@pytest.mark.parametrize("n, levels", [(96, 1), (96, 4), (128, 2), (128, 3)])
def test_per_level_matches_pallas_interpret(n, levels, dtype, atol):
    a = _spd(n + levels, 2, n, dtype)
    gj = np.asarray(jdcmod.dc_precondition_tpu(jnp.asarray(a), levels=levels, min_seg=2,
                                               interpret=True, per_level=True))
    gt = dc_precondition(torch.as_tensor(a), levels=levels, min_seg=2, per_level=True,
                         om=_probe(n, dtype))
    assert gt.shape == (2, n, n) and gt.dtype == torch.as_tensor(a).dtype
    assert np.abs(gt.numpy() - gj).max() <= atol * max(1.0, np.abs(gj).max())


def test_level_state_and_resumption():
    # one level a call: the ids split by slot, T stays symmetric and masked
    # to the level's blocks, G0 keeps the G-invariant G0^T G0 = A^2
    a = torch.as_tensor(_spd(5, 2, 64, np.float64))
    seg = torch.zeros((2, 64, 1), dtype=torch.int32)
    s1, t1, g1 = dc_level_plain(seg, 0.5 * (a + a.mT), a)
    assert s1.shape == (2, 64, 1) and s1.dtype == torch.int32
    assert set(s1.unique().tolist()) == {0, 1}
    assert bool((s1[:, 1:] >= s1[:, :-1]).all())     # non-decreasing along the index
    assert float((t1 - t1.mT).abs().max()) < 1e-12
    # the next level masks T to the blocks of the ids it started from
    s2, t2, g2 = dc_level_plain(s1, t1, g1)
    assert float(t2[s1 != s1.mT].abs().max()) == 0.0
    a2 = a @ a
    for g in (g1, g2):
        assert float((g.mT @ g - a2).abs().max() / a2.abs().max()) < 1e-10
    s, t, g = seg, 0.5 * (a + a.mT), a
    for _ in range(3):
        s, t, g = dc_level_plain(s, t, g)
    assert torch.equal(g, dc_precondition_per_level(a, levels=3))


def test_jacobi_eigh_takes_the_per_level_path_as_the_reference(monkeypatch):
    # the reference's own test (tests/test_spectral_dc.py) with the per-level
    # threshold set to 0 in both packages: 96 pads to 128, 7 levels
    monkeypatch.setattr(jdcmod, "_PER_LEVEL_MIN_N", 0)
    monkeypatch.setattr(dlmod, "_PER_LEVEL_MIN_N", 0)
    a = _spd(12, 2, 96)
    calls = []
    plain = dlmod.dc_level_plain
    monkeypatch.setattr(dlmod, "dc_level_plain", lambda *x, **k: calls.append(1) or plain(*x, **k))
    lam, V = jmod.jacobi_eigh(torch.as_tensor(a), precondition=True)
    assert len(calls) == 7 and dc_level_cuda.launches == 0
    lj, _ = jjmod.jacobi_eigh(jnp.asarray(a), precondition=True, interpret=True)
    lam0 = np.linalg.eigvalsh(a.astype(np.float64))
    # the float32 gates of the reference's test
    assert np.abs(lam.numpy() - lam0).max() < 5e-5
    assert np.abs(lam.numpy() - np.asarray(lj)).max() < 5e-5
    R = torch.as_tensor(a) @ V - V * lam[:, None, :]
    assert float(R.abs().max()) < 5e-4


@pytest.mark.parametrize("n", [96, 448, 449, 500, 512, 513, 700, 768])
def test_padding_mirrors_the_reference(n):
    for precondition in (False, True):
        assert jmod._padded_n(n, precondition) == jjmod._padded_n(n, precondition)
    # per_level=None resolves by the padded n, as in the reference
    assert (jmod._padded_n(n, True) > dlmod._PER_LEVEL_MIN_N) == (n > 448)


def test_per_level_is_chosen_by_n_and_rejects_what_it_cannot_do(monkeypatch):
    calls = []
    monkeypatch.setattr(dlmod, "dc_precondition_per_level",
                        lambda a, **k: calls.append(k) or a)
    dc_precondition(torch.zeros(1, 512, 512), levels=3)          # None: n > 448
    assert calls == [{"levels": 3, "min_seg": 2, "om": None}]
    a = torch.as_tensor(_spd(3, 1, 32))
    dc_precondition(a, levels=3)                                  # None: single shot
    assert len(calls) == 1
    for kw in ({"return_t": True}, {"return_seg": True}, {"refine": 1}):
        with pytest.raises(ValueError, match="single-shot"):
            dc_precondition(a, per_level=True, **kw)
    with pytest.raises(ValueError, match="768"):
        dc_precondition(torch.zeros(1, 776, 776), per_level=True)
    with pytest.raises(ValueError, match="768"):
        jmod.jacobi_eigh(torch.zeros(1, 800, 800), precondition=True)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    dc_level_cuda.launches = 0
    a = torch.as_tensor(_spd(4, 2, 48))
    g = dc_precondition(a, levels=4, per_level=True)
    assert torch.isfinite(g).all() and dc_level_cuda.launches == 0
    seg = torch.zeros((2, 48, 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        dc_level_cuda(seg, a, a)                                # not a CUDA tensor
    with pytest.raises(RuntimeError):
        dc_level_plain(seg[:, :8], a, a)                        # ids of another n
    assert dc_level_cuda.launches == 0


def test_level_by_level_check_of_the_card_run(monkeypatch):
    # chip_smoke.py holds the per-level kernel against dc_level_plain one
    # level at a time from the kernel's own state; with that plain version
    # standing in for the kernel every
    # difference is 0 and the check passes, and a kernel with a wrong level
    # (G0 rotated at level 2) fails it
    smoke = _smoke()
    a = torch.as_tensor(_spd(32, 2, 48))
    monkeypatch.setattr(dlmod, "dc_level_cuda",
                        lambda *x, **k: dc_level_plain(*x, **k))
    (g, t, s), max_abs, rows = smoke.dc_level_by_level(torch, a, 4, 2, per_level=True)
    s_, t_, g_ = torch.zeros((2, 48, 1), dtype=torch.int32), 0.5 * (a + a.mT), a
    for _ in range(4):
        s_, t_, g_ = dc_level_plain(s_, t_, g_)
    assert torch.equal(g, g_) and torch.equal(s, s_)
    assert max_abs == 0.0 and len(rows) == 4
    depth = []

    def wrong(seg, T, G0, **kw):
        s_, t_, g_ = dc_level_plain(seg, T, G0, **kw)
        depth.append(1)
        return s_, t_, (g_ + 1e-3 * g_.roll(1, -2)) if len(depth) == 2 else g_

    monkeypatch.setattr(dlmod, "dc_level_cuda", wrong)
    # plain's float64 run takes the same products, so its distance from the
    # float32 run measures accumulation rounding only and the entrywise
    # check catches this rotation, at level 2
    with pytest.raises(AssertionError, match="G0 of the kernel and of the plain version "
                                             "differ after level 2"):
        smoke.dc_level_by_level(torch, a, 4, 2, per_level=True)


# ------------------------------------------------------------------
# the kernel's zero-block rule: each product tile runs k only over the
# band ranges of the level's ids
# ------------------------------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_band_ranges_by_hand():
    # segments [0, 3), [3, 5), [5, 9), [9, 10); bands of 4 rows
    seg = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2, 2, 3], dtype=torch.int32)[None, :, None]
    lo, hi = band_ranges(seg, 4)
    assert lo.tolist() == [[0, 3, 5]] and hi.tolist() == [[5, 9, 10]]
    # one segment: every band spans all of n; singletons: each band its own rows
    lo, hi = band_ranges(torch.zeros((1, 10, 1), dtype=torch.int32), 4)
    assert lo.tolist() == [[0, 0, 0]] and hi.tolist() == [[10, 10, 10]]
    lo, hi = band_ranges(torch.arange(10, dtype=torch.int32)[None, :, None], 4)
    assert lo.tolist() == [[0, 4, 8]] and hi.tolist() == [[4, 8, 10]]


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("n, tile, levels", [(64, 16, 6), (200, 32, 4), (256, 128, 3)])
def test_banded_products_give_the_dense_level(n, tile, levels, dtype, tol):
    # one plain level whose products run only the kernel's k-ranges gives
    # the dense level's ids, T and G0, level after level from one state: the
    # first level from one segment, the later ones from a T that is
    # block-diagonal over the parent ids only, down to frozen segments
    a = torch.as_tensor(_spd(n + tile, 2, n, np.float64)).to(dtype)
    s, t, g = torch.zeros((2, n, 1), dtype=torch.int32), 0.5 * (a + a.mT), a
    parent_only = frozen = False
    for _ in range(levels):
        parent_only |= bool((t[s != s.mT] != 0).any())
        frozen |= bool(((s == s.mT).sum(-1) <= 2).any())
        sd, td, gd = dc_level_plain(s, t, g)
        sb, tb, gb = dc_level_plain(s, t, g, tile=tile)
        assert torch.equal(sb, sd)
        for x, y in ((tb, td), (gb, gd)):
            assert float((x - y).abs().max()) <= tol * float(y.abs().max())
        s, t, g = sd, td, gd
    assert parent_only
    assert frozen or levels < 6


# ------------------------------------------------------------------
# the kernel's order of products: all 72 in IEEE arithmetic
# ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_level_runs_its_72_products_in_order(monkeypatch, dtype):
    # the reference's order of a level's products, none with a precision
    # switch: 14 cubic sign steps (X X, X X^2), the probe, 10 quintic polar
    # steps (Q^T Q, G G, Q W), 5 cubic polar steps (Q^T Q, Q G), then T Q,
    # Q^T (T Q) and Q^T G0 (k over the row band only)
    calls = []
    product = dlmod._product

    def record(a, b, **kw):
        calls.append((kw.get("ta", False), kw.get("k_by", "both"),
                      sorted(set(kw) - {"ta", "k_by", "bands"})))
        return product(a, b, **kw)

    monkeypatch.setattr(dlmod, "_product", record)
    a = torch.as_tensor(_spd(7, 2, 48)).to(dtype)
    _, _, g = dc_level_plain(torch.zeros((2, 48, 1), dtype=torch.int32), 0.5 * (a + a.mT), a)
    assert g.dtype == dtype
    nn, tn = (False, "both", []), (True, "both", [])
    want = ([nn] * 28 + [nn] + [tn, nn, nn] * 10 + [tn, nn] * 5
            + [nn, tn, (True, "rows", [])])
    assert len(calls) == dlmod._PRODUCTS_PER_LEVEL == 72
    assert calls == want


def test_tile_operations_follow_the_band_ranges():
    # chip_smoke.py counts the operations the kernel's tiles run from the
    # band ranges: all of n for one segment, 2 m^3 a segment where the
    # segments fill the bands, and never less than the segments need
    smoke = _smoke()
    n = 384
    diag, rows = smoke.level_tile_operations(torch, torch.zeros((2, n, 1), dtype=torch.int32))
    assert diag == rows == 2 * 2.0 * n ** 3
    seg = (torch.arange(n) // 128).to(torch.int32)[None, :, None]
    diag, rows = smoke.level_tile_operations(torch, seg)
    assert diag == 3 * 2.0 * 128 ** 3 and rows == 3 * 2.0 * 128 * n * 128
    seg = torch.as_tensor(np.sort(np.random.default_rng(0).integers(0, 9, n)),
                          dtype=torch.int32)[None, :, None]
    m = (seg == seg.mT).sum(-1).double()
    diag, rows = smoke.level_tile_operations(torch, seg)
    assert diag >= 2.0 * float((m * m).sum()) and rows >= 2.0 * n * float(m.sum())


# ------------------------------------------------------------------
# the sweep-kernel gate: a function of (batch, n) from the card's table
# ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["eigh", "complex", "svd", "complex_svd"])
def test_gate_follows_the_table(kind):
    table = dict(zip(jmod._GATE_N, jmod._GATE_MIN_BATCH[kind]))
    for n in (64, 96, 128, 200, 256, 300, 512, 700, 1024):
        row = min((gn for gn in jmod._GATE_N if n <= gn), default=jmod._GATE_N[-1])
        need = table[row]
        for batch in (1, 2, 3, 4, 8, 16, 32, 64, 512):
            want = need is not None and batch >= need
            assert jmod._kernel_wins(kind, (batch,), n) == want, (kind, n, batch)
            # a batch given in several dims counts as their product
            assert jmod._kernel_wins(kind, (1, batch, 1), n) == want
    rows = [b if b is not None else math.inf for b in jmod._GATE_MIN_BATCH[kind]]
    if kind == "complex":
        # the library's complex eigh is fast at small batch, so the cluster
        # kernel's crossover rises with n, and at 768 and 1024 (the
        # device-memory path, one block a matrix) it never wins
        assert rows == sorted(rows) and rows[-2:] == [math.inf, math.inf]
    elif kind == "complex_svd":
        # on clusters (n <= 512) it wins from batch 1 to 4, on the
        # device-memory path (768 and 1024) latest or never
        assert all(b <= 4 for n, b in zip(jmod._GATE_N, rows) if n <= 512)
        assert rows[-1] >= rows[-2] >= max(rows[:-2])
    else:
        # the real kernel splits a matrix over a cluster of CTAs wherever
        # the panel's slices fit one (n <= 768): there it wins from batch 1
        # to 4 (at n = 64 both sides are a few ms of host time), at 768 (two
        # waves of clusters of 16) no earlier than at 256 and 512, and at
        # 1024 (the device-memory path, one block a matrix) latest or never
        assert all(b <= 4 for n, b in zip(jmod._GATE_N, rows) if n <= 512)
        assert rows[-1] >= max(rows[:-1]) and rows[-2] >= max(rows[2:4])


@pytest.mark.parametrize("shape", [(1, 64, 64), (64, 256, 256), (32, 512, 512), (256, 128, 96)])
def test_gate_says_no_on_the_cpu(shape):
    for dtype in (torch.float32, torch.complex64):
        A = torch.zeros(shape, dtype=dtype)
        if shape[-1] == shape[-2]:
            assert not jmod.use_jacobi_for(A)
        assert not jmod.use_jacobi_svd_for(A)
