"""The per-level divide-and-conquer warm start of the port (one level a
launch, ``ops/dc_level.py``) against the JAX package's per-level Pallas
kernel in interpret mode, on the same numpy inputs with the reference's own
probe carried across; the routing and padding of ``jacobi_eigh`` on that
path; and the sweep-kernel gate of ``ops/jacobi_eigh.py``, which the card's
measured table makes a function of batch and n.  On the CPU the plain
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
    dc_level_cuda, dc_level_plain, dc_precondition_per_level,
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
    # level at a time from the kernel's own state; with the plain version
    # standing in for the kernel every difference is 0 and the check passes,
    # and a kernel with a wrong level (G0 rotated at level 2) fails it
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    a = torch.as_tensor(_spd(32, 2, 48))
    monkeypatch.setattr(dlmod, "dc_level_cuda", dc_level_plain)
    (g, t, s), max_abs, rows = smoke.dc_level_by_level(torch, a, 4, 2, per_level=True)
    assert torch.equal(g, dc_precondition_per_level(a, levels=4))
    assert max_abs == 0.0 and len(rows) == 4
    depth = []

    def wrong(seg, T, G0, **kw):
        s_, t_, g_ = dc_level_plain(seg, T, G0, **kw)
        depth.append(1)
        return s_, t_, (g_ + 1e-3 * g_.roll(1, -2)) if len(depth) == 2 else g_

    monkeypatch.setattr(dlmod, "dc_level_cuda", wrong)
    with pytest.raises(AssertionError, match="after level 2"):
        smoke.dc_level_by_level(torch, a, 4, 2, per_level=True)


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
    # the crossover never falls as n grows: the kernel's one block a matrix
    # wins later at larger n
    rows = [b if b is not None else math.inf for b in jmod._GATE_MIN_BATCH[kind]]
    assert rows == sorted(rows)


@pytest.mark.parametrize("shape", [(1, 64, 64), (64, 256, 256), (32, 512, 512), (256, 128, 96)])
def test_gate_says_no_on_the_cpu(shape):
    for dtype in (torch.float32, torch.complex64):
        A = torch.zeros(shape, dtype=dtype)
        if shape[-1] == shape[-2]:
            assert not jmod.use_jacobi_for(A)
        assert not jmod.use_jacobi_svd_for(A)
