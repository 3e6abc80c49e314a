"""BASELINE config 1 on the port: ``optimize.rootfinder`` / ``equilibrium`` /
``minimize`` against the JAX package's (tests/test_optimize.py) on the same
numpy inputs, float64: the roots, first-order gradients against
``jax.grad``, second-order ones against ``jax.hessian`` (the README example,
whose BASELINE target is 1e-6), gradients to tensors captured in the
callable's closure, and torch's own ``gradcheck``/``gradgradcheck`` on the
port.  Config 1 launches no CUDA kernel, and on the CPU nothing may."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.optimize import equilibrium as jequilibrium
from xitorch_tpu.optimize import minimize as jminimize
from xitorch_tpu.optimize import rootfinder as jrootfinder
from xitorch_tpu_torch import enable_debug
from xitorch_tpu_torch.optimize import equilibrium, minimize, rootfinder

torch.set_num_threads(1)

A0_NP = np.array([[1.1, 0.4], [0.3, 0.8]])
# the limit of the value and gradient comparisons: both sides stop at
# f_tol 1e-13 on a well-conditioned 2 x 2 root, so the roots agree to far
# better than this, and the implicit gradients are solved exactly (n <= 5
# takes exactsolve on both sides)
TOL = 1e-6


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64, requires_grad=requires_grad)


def _np(t):
    return t.detach().numpy()


def jtanh(y, A):
    return jnp.tanh(A @ y + 0.1) + y / 2.0


def ttanh(y, A):
    return torch.tanh(A @ y + 0.1) + y / 2.0


def jcontr(y, A):
    return 0.5 * jnp.tanh(A @ y) + 0.2


def tcontr(y, A):
    return 0.5 * torch.tanh(A @ y) + 0.2


def jquartic(y, A):
    return jnp.sum((A @ y) ** 2) + jnp.sum(y ** 4) + jnp.sum(y) / 2.0


def tquartic(y, A):
    return ((A @ y) ** 2).sum() + (y ** 4).sum() + y.sum() / 2.0


Y0 = np.zeros((2, 1))


def test_readme_example_values_gradient_and_hessian():
    """The README example: the root, jax.grad and jax.hessian of sum(y^2)."""
    kw = dict(f_tol=1e-13, maxiter=10000)

    def jloss(A):
        return jnp.sum(jrootfinder(jtanh, jnp.asarray(Y0), params=(A,), **kw) ** 2)

    def tloss(A):
        return (rootfinder(ttanh, _t(Y0), params=(A,), **kw) ** 2).sum()

    y = rootfinder(ttanh, _t(Y0), params=(_t(A0_NP),), f_tol=1e-12)
    # the README's value, to the reference test's bound
    np.testing.assert_allclose(_np(y), [[-0.04593078], [-0.06633125]], atol=1e-4)
    np.testing.assert_allclose(
        _np(y), np.asarray(jrootfinder(jtanh, jnp.asarray(Y0), params=(jnp.asarray(A0_NP),),
                                       f_tol=1e-12)), atol=TOL)
    A = _t(A0_NP, requires_grad=True)
    (g,) = torch.autograd.grad(tloss(A), A)
    np.testing.assert_allclose(_np(g), np.asarray(jax.grad(jloss)(jnp.asarray(A0_NP))),
                               rtol=TOL, atol=1e-12)
    H = torch.autograd.functional.hessian(tloss, _t(A0_NP))
    Hj = np.asarray(jax.hessian(jloss)(jnp.asarray(A0_NP)))
    np.testing.assert_allclose(_np(H), Hj, rtol=TOL, atol=1e-10)


@pytest.mark.parametrize("method", ["broyden1", "broyden2", "newton", "linearmixing"])
def test_rootfinder_methods_match_jax(method):
    opts = {"f_tol": 1e-12, "maxiter": 5000}
    yt = rootfinder(ttanh, _t(Y0), params=(_t(A0_NP),), method=method, **opts)
    yj = jrootfinder(jtanh, jnp.asarray(Y0), params=(jnp.asarray(A0_NP),), method=method,
                     **opts)
    np.testing.assert_allclose(_np(ttanh(yt, _t(A0_NP))), 0.0, atol=1e-9)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=TOL)


def test_gradients_to_closure_state_and_params_agree():
    """A tensor captured in the callable's closure gets the gradient a
    param gets, to first and second order; a leaf the closure reaches only
    through another tensor gets it too."""
    kw = dict(f_tol=1e-13, maxiter=10000)

    def via_closure(A):
        return (rootfinder(lambda y: ttanh(y, A), _t(Y0), **kw) ** 2).sum()

    def via_params(A):
        return (rootfinder(ttanh, _t(Y0), params=(A,), **kw) ** 2).sum()

    A = _t(A0_NP, requires_grad=True)
    (gc,) = torch.autograd.grad(via_closure(A), A)
    (gp,) = torch.autograd.grad(via_params(A), A)
    gj = jax.grad(lambda A: jnp.sum(jrootfinder(lambda y: jtanh(y, A), jnp.asarray(Y0),
                                                **kw) ** 2))(jnp.asarray(A0_NP))
    np.testing.assert_allclose(_np(gc), _np(gp), rtol=1e-12)
    np.testing.assert_allclose(_np(gc), np.asarray(gj), rtol=TOL, atol=1e-12)
    Hc = torch.autograd.functional.hessian(via_closure, _t(A0_NP))
    Hp = torch.autograd.functional.hessian(via_params, _t(A0_NP))
    np.testing.assert_allclose(_np(Hc), _np(Hp), rtol=1e-10, atol=1e-14)
    # the closure holds W = 2 A: the gradient reaches the leaf A
    W = 2.0 * A
    (gw,) = torch.autograd.grad(via_closure(W), A)
    np.testing.assert_allclose(_np(gw), 2.0 * _np(torch.autograd.grad(via_params(W), W)[0]),
                               rtol=1e-10)


def test_gradcheck_and_gradgradcheck_on_the_port():
    A = _t(A0_NP, requires_grad=True)

    def f(A):
        return rootfinder(ttanh, _t(Y0), params=(A,), f_tol=1e-13, maxiter=10000)

    assert torch.autograd.gradcheck(f, (A,))
    assert torch.autograd.gradgradcheck(f, (A,))


@pytest.mark.parametrize("method", ["broyden1", "anderson_acc", "linearmixing"])
def test_equilibrium_methods_match_jax(method):
    opts = dict(f_tol=1e-11, x_tol=1e-11, maxiter=5000)
    yt = equilibrium(tcontr, _t(Y0), params=(_t(A0_NP),), method=method, **opts)
    yj = jequilibrium(jcontr, jnp.asarray(Y0), params=(jnp.asarray(A0_NP),), method=method,
                      **opts)
    np.testing.assert_allclose(_np(tcontr(yt, _t(A0_NP))), _np(yt), atol=1e-9)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=TOL)


def test_equilibrium_gradient_matches_jax():
    kw = dict(f_tol=1e-13, x_tol=1e-13, maxiter=5000)

    def tloss(A, method):
        return (equilibrium(tcontr, _t(Y0), params=(A,), method=method, **kw) ** 2).sum()

    gj = jax.grad(lambda A: jnp.sum(jequilibrium(jcontr, jnp.asarray(Y0), params=(A,),
                                                 method="broyden1", **kw) ** 2))(
        jnp.asarray(A0_NP))
    for method in ("broyden1", "anderson_acc"):
        A = _t(A0_NP, requires_grad=True)
        (g,) = torch.autograd.grad(tloss(A, method), A)
        np.testing.assert_allclose(_np(g), np.asarray(gj), rtol=TOL, atol=1e-12)
    A = _t(A0_NP, requires_grad=True)
    assert torch.autograd.gradgradcheck(lambda A: tloss(A, "broyden1"), (A,))


@pytest.mark.parametrize("method", ["broyden1", "gd", "adam", "lbfgs"])
def test_minimize_methods_match_jax(method):
    opts = {"maxiter": 20000}
    if method in ("gd", "adam"):
        opts.update({"step": 2e-2, "f_rtol": 1e-14, "x_rtol": 1e-12})
    elif method == "lbfgs":
        opts.update({"f_rtol": 1e-15, "x_rtol": 1e-13, "gtol": 1e-10})
    else:
        opts.update({"f_tol": 1e-12})
    yt = minimize(tquartic, _t(Y0), params=(_t(A0_NP),), method=method, **opts)
    yj = jminimize(jquartic, jnp.asarray(Y0), params=(jnp.asarray(A0_NP),), method=method,
                   **opts)
    yv = _t(_np(yt), requires_grad=True)
    (g,) = torch.autograd.grad(tquartic(yv, _t(A0_NP)), yv)
    assert float(g.abs().max()) < 5e-4, method
    # the same iteration in the same arithmetic on both sides
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=TOL)


def test_minimize_gradient_matches_jax_to_second_order():
    def tloss(A):
        y = minimize(tquartic, _t(Y0), params=(A,), method="broyden1", f_tol=1e-13,
                     maxiter=10000)
        return ((y - 1.0) ** 2).sum()

    def jloss(A):
        y = jminimize(jquartic, jnp.asarray(Y0), params=(A,), method="broyden1",
                      f_tol=1e-13, maxiter=10000)
        return jnp.sum((y - 1.0) ** 2)

    A = _t(A0_NP, requires_grad=True)
    (g,) = torch.autograd.grad(tloss(A), A)
    np.testing.assert_allclose(_np(g), np.asarray(jax.grad(jloss)(jnp.asarray(A0_NP))),
                               rtol=TOL, atol=1e-12)
    H = torch.autograd.functional.hessian(tloss, _t(A0_NP))
    np.testing.assert_allclose(_np(H), np.asarray(jax.hessian(jloss)(jnp.asarray(A0_NP))),
                               rtol=1e-5, atol=1e-9)


def test_lbfgs_rosenbrock_and_quadratic_gradient():
    def rosen(y, a, b):
        return (a - y[0]) ** 2 + b * (y[1] - y[0] ** 2) ** 2

    y, info = minimize(rosen, _t([-1.2, 1.0]), params=(_t(1.0), _t(100.0)),
                       method="lbfgs", maxiter=200, return_info=True)
    np.testing.assert_allclose(_np(y), [1.0, 1.0], atol=1e-5)
    assert float(info["converged"]) == 1.0 and float(info["iterations"]) < 120

    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 6))
    A_np = M @ M.T + 6 * np.eye(6)
    bb_np = rng.standard_normal(6)

    def tloss(bb):
        y = minimize(lambda y, A, bb: 0.5 * (y * (A @ y)).sum() - (bb * y).sum(),
                     torch.zeros(6, dtype=torch.float64), params=(_t(A_np), bb),
                     # gradgradcheck differences the gradient over steps of
                     # 1e-6, so the root must be converged far below that:
                     # by the gradient alone, not by a stall in f or y
                     method="lbfgs", f_rtol=0.0, x_rtol=0.0, gtol=1e-11)
        return ((y - 0.3) ** 2).sum()

    bb = _t(bb_np, requires_grad=True)
    (g,) = torch.autograd.grad(tloss(bb), bb)
    # y = A^-1 bb, so the gradient is 2 A^-1 (y - 0.3)
    yref = np.linalg.solve(A_np, bb_np)
    np.testing.assert_allclose(_np(g), 2 * np.linalg.solve(A_np, yref - 0.3), rtol=1e-6)
    assert torch.autograd.gradgradcheck(tloss, (bb,))


def test_complex_root_and_return_info():
    c = torch.tensor(0.5 + 0.8j, dtype=torch.complex128)
    y = rootfinder(lambda y, c: y ** 2 - c, torch.tensor(1.0 + 1.0j, dtype=torch.complex128),
                   params=(c,), method="broyden1", f_tol=1e-12)
    assert abs(complex(y ** 2 - c)) < 1e-7

    y, info = rootfinder(ttanh, _t(Y0), params=(_t(A0_NP),), method="broyden1",
                         f_tol=1e-12, return_info=True)
    assert float(info["converged"]) == 1.0 and float(info["iterations"]) > 0
    assert float(info["best_fnorm"]) < 1e-10
    _, info2 = rootfinder(ttanh, _t(Y0), params=(_t(A0_NP),), method="broyden1",
                          f_tol=1e-12, maxiter=2, return_info=True)
    assert float(info2["converged"]) == 0.0
    # gradients flow through y; the info carries none
    A = _t(A0_NP, requires_grad=True)
    y, info = rootfinder(ttanh, _t(Y0), params=(A,), f_tol=1e-13, maxiter=10000,
                         return_info=True)
    assert not info["best_fnorm"].requires_grad
    (g,) = torch.autograd.grad((y ** 2).sum(), A)
    assert bool(torch.isfinite(g).all())
    _, ie = equilibrium(tcontr, _t(Y0), params=(_t(A0_NP),), method="anderson_acc",
                        f_tol=1e-10, x_tol=1e-10, return_info=True)
    assert float(ie["converged"]) == 1.0


def test_newton_with_an_iterative_inner_solve_matches_exact(rng):
    A = _t(rng.standard_normal((6, 6)) * 0.2)
    b = _t(rng.standard_normal((6,)))

    def fcn(y, A, b):
        return torch.tanh(A @ y + b) + y / 2.0

    y0 = torch.zeros(6, dtype=torch.float64)
    y_exact = rootfinder(fcn, y0, params=(A, b), method="newton",
                         solver_method="exactsolve", maxiter=60)
    y_ew, info = rootfinder(fcn, y0, params=(A, b), method="newton",
                            solver_method="gmres", maxiter=60, return_info=True)
    assert float(info["converged"]) == 1.0
    np.testing.assert_allclose(_np(y_ew), _np(y_exact), rtol=1e-6, atol=1e-8)


def test_backward_options_reach_the_adjoint_solve(rng):
    """bck_options pick the adjoint solve's method: cg_ir on minimize's
    (hermitian) Hessian, and on a non-hermitian equilibrium Jacobian, where
    cg_ir falls back to cg; either way the gradient is exactsolve's."""
    n = 6
    a = _t(rng.standard_normal((n, n)) * 0.4, requires_grad=True)
    b = _t(rng.standard_normal(n))

    def mloss(bck):
        y = minimize(lambda y, a, b: ((a @ y - b) ** 2).sum() + 0.1 * (y ** 4).sum(),
                     torch.zeros(n, dtype=torch.float64), params=(a, b), method="broyden1",
                     maxiter=400, f_tol=1e-12, bck_options=bck)
        return torch.autograd.grad((y ** 2).sum(), a)[0]

    np.testing.assert_allclose(_np(mloss({"method": "cg_ir", "rtol": 1e-10, "atol": 1e-12})),
                               _np(mloss({"method": "exactsolve"})), rtol=1e-6, atol=1e-9)
    W = _t(rng.standard_normal((8, 8)) * 0.2, requires_grad=True)
    c = _t(rng.standard_normal(8))

    def eloss(bck):
        y = equilibrium(lambda y, W, c: torch.tanh(W @ y + c), torch.zeros(8, dtype=torch.float64),
                        params=(W, c), f_tol=1e-12, bck_options=bck)
        return torch.autograd.grad((y ** 2).sum(), W)[0]

    np.testing.assert_allclose(_np(eloss({"method": "cg_ir", "rtol": 1e-10})),
                               _np(eloss({})), rtol=1e-6, atol=1e-9)


def test_errors_debug_checks_and_docstrings():
    with pytest.raises(RuntimeError, match="scalar"):
        minimize(lambda y: y ** 2, _t([1.0, 2.0]), method="gd", maxiter=3)
    with pytest.raises(AssertionError):
        minimize(lambda y: (y.abs() ** 2).sum(), torch.ones(2, dtype=torch.complex128))
    with pytest.raises(RuntimeError, match="Unknown rootfinder method"):
        rootfinder(ttanh, _t(Y0), params=(_t(A0_NP),), method="nope")
    with enable_debug():
        with pytest.raises(RuntimeError, match="does not match"):
            rootfinder(lambda y, A: (A @ y)[:1], _t(Y0), params=(_t(A0_NP),))
        with pytest.raises(RuntimeError, match="failed to evaluate"):
            rootfinder(lambda y, A: A @ y, _t(Y0), params=())
    for fn, name in ((rootfinder, "broyden1"), (equilibrium, "anderson_acc"),
                     (minimize, "lbfgs")):
        assert 'method="%s"' % name in fn.__doc__


def test_cpu_run_launches_no_kernel():
    from xitorch_tpu_torch.ops import (
        fused_cg_cuda, jacobi_sweep_cuda, structured_cg_cuda, thomas_cuda,
    )
    for k in (fused_cg_cuda, jacobi_sweep_cuda, structured_cg_cuda, thomas_cuda):
        k.launches = 0
    A = _t(A0_NP, requires_grad=True)
    torch.autograd.grad((rootfinder(ttanh, _t(Y0), params=(A,)) ** 2).sum(), A)
    assert all(k.launches == 0 for k in (fused_cg_cuda, jacobi_sweep_cuda,
                                         structured_cg_cuda, thomas_cuda))
