"""The fused dense CG of the port against xitorch_tpu's Pallas kernel.

``fused_cg_plain`` (the kernel's plain PyTorch version, which CPU tensors
take) and ``xitorch_tpu.ops.fused_cg.fused_cg_dense(..., interpret=True)``
run the same float32 loop with the same joint stop rule on the same inputs:
they agree to 1e-5 of max |x| (sums in another order; a rounding may move
the last step).  The per-group stop rule (the CUDA kernel's where a system's
columns span several stop groups) is held here against the joint one: same
solution to the solve's tolerance, each group's step count at most the
joint count.  The design chooser of the CUDA kernel is held at the main
paths' shapes on a stated card (132 SMs, 232,448 bytes a block, one CTA an
SM), with the shared memory of its designs counted by hand.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu.ops.fused_cg import fused_cg_dense as jfused
from xitorch_tpu_torch.ops.fused_cg import (
    CGDesign, choose_design, cluster_smem_bytes, fits_fused_cg, fused_cg_cuda, fused_cg_dense,
    fused_cg_plain, lda_for, ring_plan,
)

torch.set_num_threads(1)


def _spd32(rng, batch, n):
    a = rng.standard_normal((*batch, n, n)).astype(np.float32)
    a = a + np.swapaxes(a, -2, -1)
    return a + n * np.eye(n, dtype=np.float32)


def _close(xt_, xj, tol=1e-5):
    xj = np.asarray(xj)
    assert np.max(np.abs(xt_.numpy() - xj)) <= tol * np.max(np.abs(xj))


@pytest.mark.parametrize("abatch, bbatch, n, nc", [
    ((3,), (3,), 24, 2),        # batched
    ((), (), 32, 1),            # unbatched
    ((), (4,), 48, 5),          # one matrix against a batch of B
    ((2, 1), (1, 3), 24, 3),    # both broadcast
    ((2,), (2,), 96, 4),
])
def test_plain_matches_jax_kernel_in_interpret_mode(abatch, bbatch, n, nc):
    rng = np.random.default_rng(n + nc)
    a = _spd32(rng, abatch, n)
    b = rng.standard_normal((*bbatch, n, nc)).astype(np.float32)
    xj = jfused(jnp.asarray(a), jnp.asarray(b), rtol=1e-6, atol=1e-8, interpret=True)
    x, steps = fused_cg_dense(torch.as_tensor(a), torch.as_tensor(b), rtol=1e-6, atol=1e-8,
                              return_steps=True)
    batch = np.broadcast_shapes(abatch, bbatch)
    assert tuple(x.shape) == (*batch, n, nc) and tuple(steps.shape) == (*batch, 1)
    _close(x, xj)
    # and both solve the system
    r = np.linalg.norm(a.astype(np.float64) @ x.double().numpy() - b, axis=-2)
    assert np.all(r <= 2e-6 * np.linalg.norm(b, axis=-2))


def test_zero_column_exits_at_once_as_in_jax():
    rng = np.random.default_rng(0)
    a = _spd32(rng, (2,), 24)
    b = np.zeros((2, 24, 1), np.float32)
    x, steps = fused_cg_dense(torch.as_tensor(a), torch.as_tensor(b), return_steps=True)
    assert int(steps.max()) == 0 and bool((x == 0).all())
    xj = jfused(jnp.asarray(a), jnp.asarray(b), interpret=True)
    assert np.all(np.asarray(xj) == 0)
    # one zero column beside a live one: it stays zero while the other runs
    b[:, :, :] = 0
    b2 = np.concatenate([b, rng.standard_normal((2, 24, 1)).astype(np.float32)], -1)
    x2 = fused_cg_dense(torch.as_tensor(a), torch.as_tensor(b2))
    assert bool((x2[..., 0] == 0).all()) and bool(torch.isfinite(x2).all())
    _close(x2, jfused(jnp.asarray(a), jnp.asarray(b2), interpret=True))


@pytest.mark.parametrize("max_niter", [0, 1, 3])
def test_max_niter_is_honoured_as_in_jax(max_niter):
    rng = np.random.default_rng(1)
    a = _spd32(rng, (2,), 32)
    b = rng.standard_normal((2, 32, 2)).astype(np.float32)
    x, steps = fused_cg_dense(torch.as_tensor(a), torch.as_tensor(b), max_niter=max_niter,
                              return_steps=True)
    assert bool((steps == max_niter).all())
    xj = jfused(jnp.asarray(a), jnp.asarray(b), max_niter=max_niter, interpret=True)
    if max_niter == 0:
        assert np.all(np.asarray(xj) == 0) and bool((x == 0).all())
    else:
        _close(x, xj)


def test_default_max_niter_is_one_and_a_half_n():
    # a tolerance below float32 rounding is never met: the loop runs to
    # int(1.5 n)
    rng = np.random.default_rng(4)
    a = _spd32(rng, (), 9)
    b = rng.standard_normal((9, 1)).astype(np.float32)
    _, steps = fused_cg_dense(torch.as_tensor(a), torch.as_tensor(b), rtol=1e-30, atol=0.0,
                              return_steps=True)
    assert int(steps.max()) == 13


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_per_group_stop_rule_against_the_joint_one(group):
    rng = np.random.default_rng(2)
    a = torch.as_tensor(_spd32(rng, (3,), 40))
    # columns of very different scale and difficulty converge at other steps
    b = torch.as_tensor(rng.standard_normal((3, 40, 11)).astype(np.float32))
    b[:, 5:, 3] = 0.0
    kw = dict(rtol=1e-6, atol=1e-8, max_niter=60)
    xj, itj = fused_cg_plain(a, b, **kw)
    xg, itg = fused_cg_plain(a, b, group=group, **kw)
    assert tuple(itg.shape) == (3, -(-11 // group)) and tuple(itj.shape) == (3, 1)
    # a group stops no later than the whole system, and the slowest group
    # stops with it
    assert bool((itg <= itj).all()) and bool((itg.amax(-1, keepdim=True) == itj).all())
    # both are below the solve's tolerance: the groups that stopped earlier
    # are polished less, by at most rtol |b| of residual
    assert float((xg - xj).abs().max() / xj.abs().max()) <= 1e-5
    r = torch.linalg.norm(a @ xg - b, dim=-2)
    assert bool((r <= 2e-6 * torch.linalg.norm(b, dim=-2)).all())


def test_float64_plain_reaches_float64_accuracy():
    rng = np.random.default_rng(3)
    a = _spd32(rng, (2,), 24).astype(np.float64)
    b = rng.standard_normal((2, 24, 3))
    x = fused_cg_dense(torch.as_tensor(a), torch.as_tensor(b), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), atol=1e-10, rtol=0)


def test_fits_fused_cg_window_of_this_card():
    assert fits_fused_cg(700, 50, torch.float32)
    # the reference's on-chip budget is gone: A is not held on chip
    assert fits_fused_cg(4096, 1, torch.float32)
    assert fits_fused_cg(64, 1, torch.float64)          # the card has float64 units
    assert not fits_fused_cg(64, 1, torch.complex64)    # no complex
    assert not fits_fused_cg(64, 1, torch.bfloat16)
    # one column's state (4 n elements) plus 4096 B within 232,448 B
    assert fits_fused_cg(14272, 3, torch.float32) and not fits_fused_cg(14273, 3, torch.float32)
    assert fits_fused_cg(7136, 3, torch.float64) and not fits_fused_cg(7137, 3, torch.float64)
    assert not fits_fused_cg(0, 1, torch.float32) and not fits_fused_cg(8, 0, torch.float32)


_SMS, _SMEM = 132, 232448


@pytest.mark.parametrize("nb, n, nc, dtype, want", [
    # the batched point: one cluster of 2 CTAs (25 columns each) a system,
    # 128 CTAs in one wave; 4 column groups (7 or 6 columns a warp) x 2
    # halves of k, bands of 8 rows, three stages, r and x in the scratch
    (64, 700, 50, torch.float32, CGDesign(2, 25, 50, 4, 2, 3, 0, 700)),
    # the grid (one system): 13 CTAs of 4 or 3 columns, r and x on chip
    (1, 350, 50, torch.float32, CGDesign(13, 4, 50, 1, 1, 2, 1, 350)),
    (1, 100, 50, torch.float32, CGDesign(13, 4, 50, 1, 1, 2, 1, 100)),
    (1, 700, 50, torch.float32, CGDesign(13, 4, 50, 1, 2, 2, 1, 700)),
    (64, 700, 5, torch.float32, CGDesign(2, 3, 5, 1, 2, 2, 1, 700)),
    # one column: a CTA a system, no multicast, one stage holds all of A
    (512, 64, 1, torch.float32, CGDesign(1, 1, 1, 1, 1, 1, 1, 64)),
    # more columns than 16 CTAs of 32 hold: two super-groups of 300
    (8, 700, 600, torch.float32, CGDesign(16, 19, 300, 4, 1, 2, 0, 700)),
    (64, 700, 50, torch.float64, CGDesign(10, 5, 50, 4, 2, 2, 1, 700)),
    # an odd n reads rows padded to 16 bytes
    (2, 97, 5, torch.float64, CGDesign(2, 3, 5, 1, 1, 2, 1, 98)),
    # past the cluster path's window: the device-memory path
    (512, 3000, 50, torch.float64, CGDesign(0, 2, 2)),
    (1, 4000, 3, torch.float32, CGDesign(0, 1, 1)),
])
def test_choose_design(nb, n, nc, dtype, want):
    d = choose_design(nb, n, nc, dtype, _SMS, _SMEM)
    assert d == want
    if d.cluster:
        # the same pick from the occupancy query's answer
        assert choose_design(nb, n, nc, dtype, _SMS, _SMEM, lambda dd: _SMS // dd.cluster) == d


@pytest.mark.parametrize("nb, n, nc, dtype", [
    (64, 700, 50, torch.float32), (1, 350, 50, torch.float32), (5, 130, 11, torch.float32),
    (8, 700, 600, torch.float32), (64, 700, 50, torch.float64), (3, 40, 7, torch.float32),
])
def test_no_padded_column_is_multiplied(nb, n, nc, dtype):
    d = choose_design(nb, n, nc, dtype, _SMS, _SMEM)
    split = d.cta_columns(nc)
    assert len(split) == d.groups(nc)
    # every column once, no CTA over its instantiated width, and within a
    # super-group the CTAs differ by at most one column
    assert sum(map(sum, split)) == nc
    assert max(map(max, split)) == d.cols
    assert all(max(g) - min(g) <= 1 for g in split)


def test_cluster_smem_bytes_by_hand():
    # the batched point: header 80 + 256 + 1024 + 16; the warps' p.q parts
    # and the sums the k halves exchange, 512 + 1024; P and A P 2 x 25 x 700;
    # three bands of 8 rows (4 column groups x 2 halves of k) of 700; float32
    assert cluster_smem_bytes(700, 700, 25, 4, 2, 3, 0, 4) == \
        1376 + 4 * (1536 + 2 * 25 * 700 + 3 * 8 * 700) == 214720
    # r and x on chip (rx), rows padded: n = 97 float64, np = 98, one
    # column group on all of k, bands of 64 rows
    assert cluster_smem_bytes(97, 98, 5, 1, 1, 2, 1, 8) == \
        1376 + 8 * (1536 + 4 * 5 * 98 + 2 * 64 * 98)
    assert lda_for(350, 4) == 350 and lda_for(33, 4) == 36 and lda_for(33, 8) == 34


def test_ring_plan_window():
    # one column: 4 column groups x 2 halves of k (bands of 8 rows), two
    # stages, r and x in the scratch: the largest n of the cluster path
    assert ring_plan(3124, 1, 4) == (4, 2, 2, 0) and ring_plan(3125, 1, 4) is None
    assert ring_plan(1518, 1, 8) == (4, 2, 2, 0) and ring_plan(1519, 1, 8) is None
    assert choose_design(4, 3124, 2, torch.float32, _SMS).cluster >= 1
    assert choose_design(4, 3125, 2, torch.float32, _SMS).cluster == 0
    # a smaller block splits k (bands of 32 rows) before it moves r and x off
    # chip
    assert ring_plan(350, 4, 4) == (1, 1, 2, 1)
    assert ring_plan(350, 4, 4, smem_block=120000) == (1, 2, 2, 1)


@pytest.mark.parametrize("case", ["scales", "zero", "easy_and_hard"])
def test_joint_rule_of_the_plain_twin_against_jax(case):
    # the rule the kernel applies where one cluster holds all the columns:
    # every column keeps running until the slowest stops, as in the
    # reference, so each column agrees with the JAX kernel (interpret mode)
    # to 1e-5 of its own largest entry, the small columns included
    rng = np.random.default_rng(7)
    n = 40
    q, _ = np.linalg.qr(rng.standard_normal((2, n, n)))
    ev = np.linspace(0.01 if case == "easy_and_hard" else 0.2, 1.0, n)
    a = ((q * ev) @ np.swapaxes(q, -1, -2)).astype(np.float32)
    a = (a + np.swapaxes(a, -1, -2)) / 2
    b = rng.standard_normal((2, n, 6)).astype(np.float32)
    if case == "scales":
        b *= np.float32(10.0) ** np.arange(-3, 3, dtype=np.float32)
    elif case == "zero":
        b[:, :, 2] = 0.0
    else:
        b[:, :, :3] = np.swapaxes(q[:, :, -3:], -1, -2).transpose(0, 2, 1)  # eigenvectors
    kw = dict(rtol=1e-6, atol=1e-8, max_niter=60)
    x, it = fused_cg_plain(torch.as_tensor(a), torch.as_tensor(b), **kw)
    xj = np.asarray(jfused(jnp.asarray(a), jnp.asarray(b), interpret=True, **kw))
    scale = np.abs(xj).max(axis=-2, keepdims=True)
    assert np.all(np.abs(x.numpy() - xj) <= 1e-5 * np.maximum(scale, 1e-30))
    assert tuple(it.shape) == (2, 1)
    # one group of all the columns: the steps of the slowest column
    _, itg = fused_cg_plain(torch.as_tensor(a), torch.as_tensor(b), group=1, **kw)
    assert bool((it[:, 0] == itg.amax(-1)).all())


def test_dispatcher_rejects_what_the_kernel_does_not_take():
    a = torch.eye(8)
    with pytest.raises(RuntimeError, match="does not match"):
        fused_cg_dense(a, torch.ones(9, 1))
    with pytest.raises(RuntimeError, match="does not match"):
        fused_cg_dense(a.double(), torch.ones(8, 1))
    with pytest.raises(RuntimeError, match="window"):
        fused_cg_dense(a.to(torch.complex64), torch.ones(8, 1, dtype=torch.complex64))
    # the CUDA wrapper never runs on CPU tensors (no fall-back inside it)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_cg_cuda(a[None], torch.zeros(1, dtype=torch.int64), torch.ones(1, 8, 1),
                      rtol=1e-6, atol=1e-8, max_niter=3)
    assert fused_cg_cuda.launches == 0
    assert xt.ops.fused_cg_dense is fused_cg_dense


def test_off_grid_residual_over_stop_is_the_references():
    """Off path A's grid, at the batched point's n = 700 and 50 columns on
    the range (0.001, 1) (one system), the kernel's loop leaves with a
    measured residual of about 1.9x its stop, above the grid's 1.1x.  The
    reference kernel does the same on the same float32 system (both stop on
    the recurrence residual, which parts from the measured one as the
    condition number grows): the port is no more than 10% above it."""
    import jax

    rng = np.random.default_rng(12)
    n, nc, rtol, atol = 700, 50, 1e-5, 1e-7
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q * np.linspace(0.001, 1.0, n)) @ q.T
    A = (0.5 * (A + A.T)).astype(np.float32)
    B = rng.standard_normal((n, nc)).astype(np.float32)

    def over_stop(x):
        r = np.linalg.norm(A.astype(np.float64) @ np.asarray(x, np.float64) - B, axis=0)
        return float((r / np.maximum(rtol * np.linalg.norm(B, axis=0), atol)).max())

    xj = jax.jit(lambda a, b: jfused(a, b, rtol=rtol, atol=atol, interpret=True))(
        jnp.asarray(A)[None], jnp.asarray(B)[None])[0]
    xp, steps = fused_cg_plain(torch.tensor(A)[None], torch.tensor(B)[None], rtol=rtol,
                               atol=atol, max_niter=int(1.5 * n))
    ref, port = over_stop(xj), over_stop(xp[0])
    assert ref > 1.1                               # the reference misses the grid's gate here
    assert port <= 1.1 * ref, (port, ref)
    assert 100 <= int(steps.max()) < int(1.5 * n)  # it stopped on its rule, not the cap
