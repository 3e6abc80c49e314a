"""Kronecker-structured operators, ``solve(method="kron_direct")`` and
``symeig(method="kron_exact")``: the port against xitorch_tpu's classes on
the same numpy inputs (the cases of tests/test_kron.py).

float64 throughout, so both sides are direct computations that differ by
round-off only: operator products agree to 1e-12, solutions to 1e-9
(kappa ~ 1e2 on round-off), eigenvalues to 1e-10; eigenvectors are compared
through their residual (their sign is free).  Gradients agree with
``jax.grad`` / ``jax.hessian`` to 1e-7.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu as xj
import xitorch_tpu_torch as xt
from xitorch_tpu.linalg import solve as jsolve, symeig as jsymeig
from xitorch_tpu_torch.convert import operator_from_numpy
from xitorch_tpu_torch.linalg import solve as tsolve, svd as tsvd, symeig as tsymeig
from xitorch_tpu_torch.linalg.solve import _default_method
from xitorch_tpu_torch.ops import jacobi_sweep_cuda

torch.set_num_threads(1)

CLASSES = {"KronOperator": (xj.KronOperator, xt.KronOperator),
           "KronSumOperator": (xj.KronSumOperator, xt.KronSumOperator)}


def _spd(rng, n, batch=()):
    a = rng.standard_normal((*batch, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _ops(kind, factors, is_hermitian=True):
    Aj = CLASSES[kind][0](*map(jnp.asarray, factors), is_hermitian=is_hermitian)
    At = operator_from_numpy(kind, {"factors": factors}, device="cpu",
                             is_hermitian=is_hermitian)
    assert type(At) is CLASSES[kind][1]
    return Aj, At


def _dense(kind, factors):
    k = np.kron
    if kind == "KronOperator":
        out = factors[0]
        for f in factors[1:]:
            out = k(out, f)
        return out
    dims = [f.shape[-1] for f in factors]
    out = 0.0
    for i, f in enumerate(factors):
        term = f
        if i > 0:
            term = k(np.eye(int(np.prod(dims[:i]))), term)
        if i < len(dims) - 1:
            term = k(term, np.eye(int(np.prod(dims[i + 1:]))))
        out = out + term
    return out


@pytest.mark.parametrize("kind", list(CLASSES))
def test_kron_mv_mm_and_fullmatrix_match_jax_and_dense(kind):
    rng = np.random.default_rng(0)
    factors = [_spd(rng, 5), _spd(rng, 4)]
    Aj, At = _ops(kind, factors)
    ref = _dense(kind, factors)
    assert At.shape == Aj.shape == (20, 20) and At.is_hermitian and At.dims == (5, 4)
    np.testing.assert_allclose(At.fullmatrix().numpy(), ref, atol=1e-12)
    np.testing.assert_allclose(At.fullmatrix().numpy(), np.asarray(Aj.fullmatrix()), atol=1e-12)
    x = rng.standard_normal((20, 3))
    np.testing.assert_allclose(At.mm(torch.as_tensor(x)).numpy(), np.asarray(Aj.mm(jnp.asarray(x))),
                               atol=1e-12)
    np.testing.assert_allclose(At.mv(torch.as_tensor(x[:, 0])).numpy(), ref @ x[:, 0], atol=1e-12)
    np.testing.assert_allclose(At.rmm(torch.as_tensor(x)).numpy(), ref.T @ x, atol=1e-12)
    xt.checklinop(At)


def test_kron_batch_dims_and_linop_factors():
    rng = np.random.default_rng(1)
    a1 = rng.standard_normal((3, 4, 4))
    a1 = a1 + np.swapaxes(a1, -1, -2) + 8 * np.eye(4)
    a2 = _spd(rng, 3)
    opj = xj.KronSumOperator(jnp.asarray(a1),
                             xj.LinearOperator.m(jnp.asarray(a2), is_hermitian=True))
    opt = xt.KronSumOperator(torch.as_tensor(a1),
                             xt.LinearOperator.m(torch.as_tensor(a2), is_hermitian=True))
    assert opt.shape == opj.shape == (3, 12, 12)
    # raw-array factor: hermitian-ness is unknown unless declared
    assert not opt.is_hermitian and not opj.is_hermitian
    x = rng.standard_normal((3, 12, 2))
    y = opt.mm(torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(opj.mm(jnp.asarray(x))), atol=1e-12)
    np.testing.assert_allclose(y.numpy(), opt.fullmatrix().numpy() @ x, atol=1e-12)
    # a non-hermitian Kron operator's adjoint product (through autograd)
    np.testing.assert_allclose(opt.rmm(torch.as_tensor(x)).numpy(),
                               np.swapaxes(opt.fullmatrix().numpy(), -1, -2) @ x, atol=1e-12)
    # all-LinearOperator hermitian factors make a hermitian operator
    H = xt.LinearOperator.m(torch.as_tensor(a2), is_hermitian=True)
    assert xt.KronOperator(H, H).is_hermitian
    # the factors are the parameters autograd reaches
    assert [tuple(p.shape) for p in opt.getlinopparams()] == [(3, 4, 4), (3, 3)]


def test_kron_promotes_dtypes_and_rejects_bad_factors():
    op = xt.KronOperator(torch.eye(3, dtype=torch.float32), torch.eye(2, dtype=torch.float64))
    assert op.dtype == torch.float64 and all(f.dtype == torch.float64 for f in op.factors)
    opc = xt.KronSumOperator(torch.eye(3), torch.eye(2, dtype=torch.complex64))
    assert opc.dtype == torch.complex64
    with pytest.raises(RuntimeError, match="square"):
        xt.KronOperator(torch.zeros(3, 4), torch.eye(3))
    with pytest.raises(RuntimeError, match="two factors"):
        xt.KronSumOperator(torch.eye(3))
    with pytest.raises(ValueError, match="unknown operator kind"):
        operator_from_numpy("Kron", {"factors": [np.eye(2), np.eye(2)]}, device="cpu")


@pytest.mark.parametrize("kind", list(CLASSES))
def test_kron_direct_solve_matches_jax(kind):
    rng = np.random.default_rng(2)
    factors = [_spd(rng, 6), _spd(rng, 5)]
    Aj, At = _ops(kind, factors)
    b = rng.standard_normal((30, 2))
    xjv, ij = jsolve(Aj, jnp.asarray(b), method="kron_direct", return_info=True)
    xtv, it = tsolve(At, torch.as_tensor(b), method="kron_direct", return_info=True)
    assert float(it["converged"]) == float(ij["converged"]) == 1.0
    assert float(it["iterations"]) == float(ij["iterations"]) == 2.0
    np.testing.assert_allclose(xtv.numpy(), np.asarray(xjv), atol=1e-9, rtol=0)
    np.testing.assert_allclose(xtv.numpy(), np.linalg.solve(_dense(kind, factors), b), atol=1e-9)
    # refine=0 is the bare eigenbasis solve
    x0, i0 = tsolve(At, torch.as_tensor(b), method="kron_direct", refine=0, return_info=True)
    assert float(i0["iterations"]) == 1.0
    np.testing.assert_allclose(x0.numpy(), xtv.numpy(), atol=1e-9)


def test_kron_direct_batched_factors_and_per_batch_scale():
    rng = np.random.default_rng(3)
    f1 = _spd(rng, 4, batch=(3,)) * np.array([1.0, 1e-3, 1e3])[:, None, None]
    f2 = _spd(rng, 3)
    Aj, At = _ops("KronSumOperator", [f1, f2])
    b = rng.standard_normal((3, 12, 2))
    xjv, ij = jsolve(Aj, jnp.asarray(b), method="kron_direct", return_info=True)
    xtv, it = tsolve(At, torch.as_tensor(b), method="kron_direct", return_info=True)
    assert float(it["converged"]) == float(ij["converged"]) == 1.0
    np.testing.assert_allclose(xtv.numpy(), np.asarray(xjv), atol=1e-9, rtol=1e-9)


def test_kron_direct_with_E_and_grads_match_jax():
    rng = np.random.default_rng(4)
    a1, a2 = _spd(rng, 4), _spd(rng, 3)
    b = rng.standard_normal((12, 2))
    E = np.array([0.07, -0.11])

    def runj(a1m, bm, em):
        op = xj.KronSumOperator((a1m + a1m.T) / 2, jnp.asarray(a2), is_hermitian=True)
        return jsolve(op, bm, E=em, method="kron_direct")

    def runt(a1m, bm, em):
        # a hermitian flag promises hermitian factors under perturbation too
        op = xt.KronSumOperator((a1m + a1m.mT) / 2, torch.as_tensor(a2), is_hermitian=True)
        return tsolve(op, bm, E=em, method="kron_direct")

    ts = [torch.tensor(v, requires_grad=True) for v in (a1, b, E)]
    x = runt(*ts)
    dense = _dense("KronSumOperator", [a1, a2])
    np.testing.assert_allclose(dense @ x.detach().numpy() - x.detach().numpy() * E, b, atol=1e-9)
    np.testing.assert_allclose(x.detach().numpy(),
                               np.asarray(runj(*map(jnp.asarray, (a1, b, E)))), atol=1e-9)
    gj = jax.grad(lambda *a: jnp.sum(runj(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (a1, b, E)))
    gt = torch.autograd.grad((x ** 2).sum(), ts)
    for j, t in zip(gj, gt):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7, rtol=0)
    # implicit gradients through the direct solve, first and second order
    assert torch.autograd.gradcheck(runt, ts)
    assert torch.autograd.gradgradcheck(runt, ts)


def test_kron_direct_second_order_matches_jax_hessian():
    rng = np.random.default_rng(5)
    a1, a2 = _spd(rng, 3), _spd(rng, 2)
    b = rng.standard_normal((6, 1))

    def fj(a1m):
        op = xj.KronSumOperator((a1m + a1m.T) / 2, jnp.asarray(a2), is_hermitian=True)
        return jnp.sum(jsolve(op, jnp.asarray(b), method="kron_direct") ** 2)

    def ft(a1m):
        op = xt.KronSumOperator((a1m + a1m.mT) / 2, torch.as_tensor(a2), is_hermitian=True)
        return (tsolve(op, torch.as_tensor(b), method="kron_direct") ** 2).sum()

    hj = np.asarray(jax.hessian(fj)(jnp.asarray(a1)))
    ht = torch.autograd.functional.hessian(ft, torch.as_tensor(a1))
    np.testing.assert_allclose(ht.numpy(), hj, atol=1e-7, rtol=1e-6)


def test_kron_direct_falls_back_to_cg_for_nonhermitian():
    rng = np.random.default_rng(6)
    a1 = rng.standard_normal((4, 4)) + 6 * np.eye(4)
    # non-hermitian factors -> operator not hermitian -> cg (which itself
    # goes to the normal equations)
    Aj, At = _ops("KronOperator", [a1, np.eye(3)], is_hermitian=None)
    assert not At.is_hermitian
    b = np.ones((12, 1))
    x = tsolve(At, torch.as_tensor(b), method="kron_direct", max_niter=400)
    assert torch.equal(x, tsolve(At, torch.as_tensor(b), method="cg", max_niter=400))
    xjv = jsolve(Aj, jnp.asarray(b), method="kron_direct", max_niter=400)
    np.testing.assert_allclose(x.numpy(), np.asarray(xjv), atol=1e-6)
    np.testing.assert_allclose(At.mm(x).numpy(), b, atol=1e-5)
    # an M-generalized problem goes to cg as well
    _, Ah = _ops("KronSumOperator", [_spd(rng, 4), _spd(rng, 3)])
    Mt = xt.LinearOperator.m(torch.eye(12, dtype=torch.float64) * 2.0, is_hermitian=True)
    E = torch.tensor([0.1], dtype=torch.float64)
    bt = torch.as_tensor(b)
    kw = dict(E=E, M=Mt, posdef=True, rtol=1e-10, atol=1e-12)
    assert torch.equal(tsolve(Ah, bt, method="kron_direct", **kw),
                       tsolve(Ah, bt, method="cg", **kw))


@pytest.mark.parametrize("kind", list(CLASSES))
@pytest.mark.parametrize("mode", ["lowest", "uppest"])
def test_kron_exact_symeig_matches_jax(kind, mode):
    rng = np.random.default_rng(7)
    factors = [_spd(rng, 6), _spd(rng, 5)]
    Aj, At = _ops(kind, factors)
    evj, _ = jsymeig(Aj, 4, mode, method="kron_exact")
    ev, evec, info = tsymeig(At, 4, mode, method="kron_exact", return_info=True)
    assert float(info["converged"]) == 1.0
    dense = _dense(kind, factors)
    ev0 = np.linalg.eigvalsh(dense)
    np.testing.assert_allclose(ev.numpy(), ev0[:4] if mode == "lowest" else ev0[-4:], atol=1e-10)
    np.testing.assert_allclose(ev.numpy(), np.asarray(evj), atol=1e-10)
    assert np.max(np.abs(dense @ evec.numpy() - evec.numpy() * ev.numpy())) < 1e-9
    np.testing.assert_allclose(evec.numpy().T @ evec.numpy(), np.eye(4), atol=1e-12)


def test_kron_exact_symeig_batched_factors():
    rng = np.random.default_rng(8)
    factors = [_spd(rng, 4, batch=(2,)), _spd(rng, 3)]
    Aj, At = _ops("KronSumOperator", factors)
    evj, _ = jsymeig(Aj, 3, "lowest", method="kron_exact")
    ev, evec = tsymeig(At, 3, "lowest", method="kron_exact")
    assert tuple(ev.shape) == (2, 3) and tuple(evec.shape) == (2, 12, 3)
    np.testing.assert_allclose(ev.numpy(), np.asarray(evj), atol=1e-10)
    dense = At.fullmatrix().numpy()
    assert np.max(np.abs(dense @ evec.numpy() - evec.numpy() * ev.numpy()[:, None, :])) < 1e-9


def test_kron_exact_symeig_grads_match_jax():
    rng = np.random.default_rng(9)
    a1, a2 = _spd(rng, 5), _spd(rng, 4)

    def lossj(a1m):
        op = xj.KronSumOperator((a1m + a1m.T) / 2, jnp.asarray(a2), is_hermitian=True)
        ev, evec = jsymeig(op, 3, "lowest", method="kron_exact")
        return jnp.sum(ev ** 2) + jnp.sum(evec[..., 0] ** 4)

    def losst(a1m):
        op = xt.KronSumOperator((a1m + a1m.mT) / 2, torch.as_tensor(a2), is_hermitian=True)
        ev, evec = tsymeig(op, 3, "lowest", method="kron_exact")
        return (ev ** 2).sum() + (evec[..., 0] ** 4).sum()

    leaf = torch.tensor(a1, requires_grad=True)
    (gt,) = torch.autograd.grad(losst(leaf), leaf)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jax.grad(lossj)(jnp.asarray(a1))),
                               atol=1e-7, rtol=0)
    assert torch.autograd.gradcheck(losst, (leaf,))
    assert torch.autograd.gradgradcheck(losst, (leaf,))


def test_kron_exact_rejects():
    eye = torch.eye(4, dtype=torch.float64)
    op = xt.KronOperator(eye, eye)  # not declared hermitian
    with pytest.raises(RuntimeError, match="Hermitian"):
        tsymeig(op, 2, "lowest", method="kron_exact")
    Adense = xt.LinearOperator.m(torch.eye(8, dtype=torch.float64), is_hermitian=True)
    with pytest.raises(RuntimeError, match="requires a KronOperator"):
        tsymeig(Adense, 2, "lowest", method="kron_exact")
    oph = xt.KronOperator(eye, eye, is_hermitian=True)
    M = xt.LinearOperator.m(torch.eye(16, dtype=torch.float64), is_hermitian=True)
    with pytest.raises(RuntimeError, match="generalized"):
        tsymeig(oph, 2, "lowest", M=M, method="kron_exact")


def test_kron_three_factors_all_paths():
    rng = np.random.default_rng(10)
    factors = [_spd(rng, 5), _spd(rng, 4), _spd(rng, 3)]
    v = rng.standard_normal((60, 2))
    for kind in CLASSES:
        Aj, At = _ops(kind, factors)
        ref = _dense(kind, factors)
        np.testing.assert_allclose(At.fullmatrix().numpy(), ref, atol=1e-10)
        np.testing.assert_allclose(At.mm(torch.as_tensor(v)).numpy(), ref @ v, atol=1e-9)
        x = tsolve(At, torch.as_tensor(v), method="kron_direct")
        np.testing.assert_allclose(ref @ x.numpy(), v, atol=1e-8)
        np.testing.assert_allclose(
            x.numpy(), np.asarray(jsolve(Aj, jnp.asarray(v), method="kron_direct")),
            atol=1e-9, rtol=1e-9)
        ev, evec = tsymeig(At, 5, "lowest", method="kron_exact")
        np.testing.assert_allclose(ev.numpy(), np.linalg.eigvalsh(ref)[:5], atol=1e-9)
        assert np.max(np.abs(ref @ evec.numpy() - evec.numpy() * ev.numpy())) < 1e-8


def test_kron_complex_hermitian_factors():
    # conjugations in the eigenbasis transforms and the kron eigenvector
    # products must line up
    rng = np.random.default_rng(11)

    def herm(n):
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return a @ a.conj().T + n * np.eye(n)

    factors = [herm(5), herm(4)]
    Aj, At = _ops("KronSumOperator", factors)
    dense = _dense("KronSumOperator", factors)
    b = rng.standard_normal((20, 2)) + 1j * rng.standard_normal((20, 2))
    x = tsolve(At, torch.as_tensor(b), method="kron_direct")
    assert np.max(np.abs(dense @ x.numpy() - b)) < 1e-12
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jsolve(Aj, jnp.asarray(b), method="kron_direct")), atol=1e-12)
    ev, evec = tsymeig(At, 3, "lowest", method="kron_exact")
    assert not ev.is_complex() and evec.is_complex()
    assert np.max(np.abs(dense @ evec.numpy() - evec.numpy() * ev.numpy())) < 1e-12


def test_kron_direct_singular_shift_is_flagged_not_inf():
    # E at an exact eigenvalue sum: the denominator is floored, x stays
    # finite and info says converged = 0, in both packages
    f = np.diag([1.0, 2.0, 4.0])
    Aj, At = _ops("KronSumOperator", [f, f])
    b = np.ones((9, 2))
    E = np.array([3.0, 0.5])  # 3 = 1 + 2 is an eigenvalue sum; 0.5 is regular
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xjv, ij = jsolve(Aj, jnp.asarray(b), E=jnp.asarray(E), method="kron_direct",
                         return_info=True)
    with pytest.warns(xt.ConvergenceWarning):
        xtv, it = tsolve(At, torch.as_tensor(b), E=torch.as_tensor(E), method="kron_direct",
                         return_info=True)
    assert bool(torch.isfinite(xtv).all()) and np.all(np.isfinite(np.asarray(xjv)))
    assert float(it["converged"]) == float(ij["converged"]) == 0.0
    # the regular column is solved all the same
    np.testing.assert_allclose(xtv.numpy()[:, 1], 1.0 / (np.add.outer([1, 2, 4], [1, 2, 4])
                                                       .reshape(-1) - 0.5), atol=1e-12)
    _, ok = tsolve(At, torch.as_tensor(b), E=torch.as_tensor([0.3, 0.5]), method="kron_direct",
                   return_info=True)
    assert float(ok["converged"]) == 1.0


def test_default_routing_of_solve_and_symeig_for_kron_operators(monkeypatch):
    rng = np.random.default_rng(12)
    factors = [_spd(rng, 4), _spd(rng, 3)]
    _, At = _ops("KronSumOperator", factors)
    _, An = _ops("KronSumOperator", factors, is_hermitian=None)
    M = xt.LinearOperator.m(torch.eye(12, dtype=torch.float64), is_hermitian=True)
    E = torch.ones(2, dtype=torch.float64)
    assert _default_method(At, None, None) == "kron_direct"
    assert _default_method(At, E, None) == "kron_direct"
    # outside the guard a Kron operator stays matrix-free, never exactsolve
    assert _default_method(At, E, M) == "minres"
    assert _default_method(An, None, None) == "bicgstab"
    assert _default_method(M, E, At) == "minres"
    # nothing on the default routes may materialise the operator
    monkeypatch.setattr(xt.KronSumOperator, "_fullmatrix",
                        lambda self: pytest.fail("a Kron operator was materialised"))
    b = torch.as_tensor(rng.standard_normal((12, 2)))
    x = tsolve(At, b)
    assert torch.equal(x, tsolve(At, b, method="kron_direct"))
    ev, evec = tsymeig(At, 3, "lowest")
    ev2, _ = tsymeig(At, 3, "lowest", method="kron_exact")
    assert torch.equal(ev, ev2)
    # an M-generalized Kron pencil goes to davidson, not to the dense route
    evm, _ = tsymeig(At, 2, "lowest", M=M)
    np.testing.assert_allclose(evm.numpy(), ev.numpy()[:2], atol=1e-5)
    # svd of a Kron operator keeps the Gram route (symeig of A^H A)
    _, s, _ = tsvd(At, 2, mode="lowest", method="davidson", min_eps=1e-9)
    np.testing.assert_allclose(s.numpy(), ev.numpy()[:2], rtol=1e-6)
    assert jacobi_sweep_cuda.launches == 0  # CPU tensors launch no kernel
