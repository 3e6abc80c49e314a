"""The fused dense CG of the port against xitorch_tpu's Pallas kernel.

``fused_cg_plain`` (the kernel's plain PyTorch version, which CPU tensors
take) and ``xitorch_tpu.ops.fused_cg.fused_cg_dense(..., interpret=True)``
run the same float32 loop with the same joint stop rule on the same inputs:
they agree to 1e-5 of max |x| (sums in another order; a rounding may move
the last step).  The per-group stop rule of the CUDA kernel is held here
against the joint one: same solution to the solve's tolerance, each group's
step count at most the joint count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu.ops.fused_cg import fused_cg_dense as jfused
from xitorch_tpu_torch.ops.fused_cg import (
    fits_fused_cg, fused_cg_cuda, fused_cg_dense, fused_cg_plain, group_size,
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


@pytest.mark.parametrize("nb, n, nc, dtype, want", [
    (64, 700, 50, torch.float32, 8),    # 448 blocks fill the card at 8 columns a block
    (1, 350, 50, torch.float32, 1),     # one system: a block a column, 50 blocks
    (64, 700, 5, torch.float32, 2),     # 64 * 3 = 192 blocks
    (512, 64, 1, torch.float32, 1),     # a single column
    (512, 3000, 50, torch.float32, 4),  # 8 columns of n = 3000 do not fit shared memory
    (512, 3000, 50, torch.float64, 2),
])
def test_group_size(nb, n, nc, dtype, want):
    assert group_size(nb, n, nc, dtype) == want


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
