"""``linalg.solve`` by bicgstab, gmres, cg_ir, fused_cg and scipy_gmres: the
port against xitorch_tpu's on the same numpy inputs.

At float64 converged results agree to 1e-6 (both run the same recurrences,
summed in another order, and stop below the solve's rtol).  cg_ir's inner
solves run in bfloat16, which rounds differently in the two frameworks, so
it is held at the refinement's own outer tolerance.  float32 results are
held at the solve's tolerance times the conditioning (kappa = 10).
Gradients at float64 agree with ``jax.grad`` to 1e-6 and pass
gradcheck/gradgradcheck.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu as xj
import xitorch_tpu_torch as xt
from xitorch_tpu.linalg import solve as jsolve
from xitorch_tpu_torch._impls.linalg import solve as timpl
from xitorch_tpu_torch.linalg import solve as tsolve
from xitorch_tpu_torch.linalg.solve import _default_method
from xitorch_tpu_torch.ops import fused_cg as tfused

torch.set_num_threads(1)

N = 24
TIGHT = dict(rtol=1e-10, atol=1e-12)


def _herm(seed=0, batch=(2,), n=N, lo=1.0, hi=10.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((*batch, n, n)))
    a = (q * np.linspace(lo, hi, n)) @ np.swapaxes(q, -1, -2)
    return (a + np.swapaxes(a, -1, -2)) / 2, rng


def _nonherm(seed=0, batch=(2,), n=N):
    """The recipe of create_random_square_matrix: real eigenvalues in
    [1, 2] under a random (non-orthogonal) similarity."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((*batch, n, n))
    a = a / np.linalg.norm(a, axis=-2, keepdims=True)
    return np.linalg.solve(a, np.linspace(1.0, 2.0, n)[:, None] * a), rng


def _pair(a, herm, dtype=np.float64):
    a = a.astype(dtype)
    return (xj.LinearOperator.m(jnp.asarray(a), is_hermitian=herm),
            xt.LinearOperator.m(torch.as_tensor(a), is_hermitian=herm))


def _both(Aj, At, b, method, E=None, Mj=None, Mt=None, **kw):
    tkw = dict(kw)
    for k in ("precond_l", "precond_r"):
        if k in kw:
            tkw[k] = kw[k][1]
            kw[k] = kw[k][0]
    xjv = jsolve(Aj, jnp.asarray(b), E=None if E is None else jnp.asarray(E), M=Mj,
                 method=method, **kw)
    xtv = tsolve(At, torch.as_tensor(b), E=None if E is None else torch.as_tensor(E),
                 M=Mt, method=method, **tkw)
    return np.asarray(xjv), xtv.numpy()


METHODS = [("bicgstab", {}), ("gmres", {}), ("gmres", {"restart": 7, "max_niter": 200}),
           ("cg_ir", {}), ("fused_cg", {}), ("scipy_gmres", {})]
IDS = ["bicgstab", "gmres", "gmres-restart", "cg_ir", "fused_cg", "scipy_gmres"]


@pytest.mark.parametrize("method, opts", METHODS, ids=IDS)
@pytest.mark.parametrize("herm", [True, False], ids=["hermitian", "nonhermitian"])
def test_methods_match_jax_f64(method, opts, herm):
    batch = () if method == "scipy_gmres" else (2,)
    a, rng = _herm(batch=batch) if herm else _nonherm(batch=batch)
    b = rng.standard_normal((*batch, N, 3))
    Aj, At = _pair(a, herm)
    # (on a non-hermitian operator cg_ir and fused_cg go to cg's normal
    # equations, in both packages)
    kw = dict(opts) if method == "scipy_gmres" else dict(TIGHT, **opts)
    if method in ("cg_ir", "fused_cg") and not herm:
        kw["max_niter"] = 400
    xjv, xtv = _both(Aj, At, b, method, **kw)
    tol = 1e-6
    np.testing.assert_allclose(xtv, xjv, atol=tol, rtol=0)
    np.testing.assert_allclose(xtv, np.linalg.solve(a, b), atol=tol, rtol=0)


@pytest.mark.parametrize("method, opts", METHODS[:4], ids=IDS[:4])
def test_e_shifted_methods_match_jax_f64(method, opts):
    a, rng = _herm(seed=1)
    b = rng.standard_normal((2, N, 2))
    E = np.array([-1.0, 0.5])  # below the spectrum: the pencil stays posdef
    Aj, At = _pair(a, True)
    kw = dict(TIGHT, **opts)
    if method == "cg_ir":
        kw["posdef"] = True
    xjv, xtv = _both(Aj, At, b, method, E=E, **kw)
    np.testing.assert_allclose(xtv, xjv, atol=1e-6, rtol=0)
    np.testing.assert_allclose(a @ xtv - xtv * E, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("method, opts", METHODS[:3], ids=IDS[:3])
def test_generalized_pencil_matches_jax_f64(method, opts):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, N, N)) * 0.3 + 3.0 * np.eye(N)
    m, _ = _herm(seed=3, lo=1.0, hi=2.0)
    b = rng.standard_normal((2, N, 2))
    E = np.array([-0.3, 0.2])
    Aj, At = _pair(a, False)
    Mj, Mt = _pair(m, True)
    xjv, xtv = _both(Aj, At, b, method, E=E, Mj=Mj, Mt=Mt, **dict(TIGHT, **opts))
    np.testing.assert_allclose(xtv, xjv, atol=1e-6, rtol=0)
    np.testing.assert_allclose(a @ xtv - (m @ xtv) * E, b, atol=1e-6, rtol=0)


def test_bicgstab_preconditioners_and_residual_cadence_match_jax():
    a, rng = _nonherm(seed=4)
    b = rng.standard_normal((2, N, 2))
    Aj, At = _pair(a, False)
    dinv = 1.0 / np.diagonal(a, axis1=-2, axis2=-1)[..., None]
    pj, pt = (lambda x: jnp.asarray(dinv) * x), (lambda x: torch.as_tensor(dinv) * x)
    want = np.linalg.solve(a, b)
    for kw in (dict(precond_l=(pj, pt)), dict(precond_r=(pj, pt)),
               dict(precond_l=(pj, pt), precond_r=(pj, pt), resid_calc_every=3),
               dict(resid_calc_every=0, posdef=True)):
        xjv, xtv = _both(Aj, At, b, "bicgstab", **dict(TIGHT, **kw))
        np.testing.assert_allclose(xtv, xjv, atol=1e-6, rtol=0)
        np.testing.assert_allclose(xtv, want, atol=1e-6, rtol=0)
    # a LinearOperator as preconditioner
    Pt = xt.LinearOperator.m(torch.diag_embed(torch.as_tensor(dinv[..., 0])))
    x = tsolve(At, torch.as_tensor(b), method="bicgstab", precond_r=Pt, **TIGHT)
    np.testing.assert_allclose(x.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(TypeError):
        tsolve(At, torch.as_tensor(b), method="bicgstab", precond_l=3.0)


@pytest.mark.parametrize("method", ["fused_cg", "cg_ir", "bicgstab", "gmres"])
def test_methods_match_jax_f32(method):
    a, rng = _herm(seed=5, lo=0.1, hi=1.0)  # the benchmark grid's (0, 1) range
    b = rng.standard_normal((2, N, 4)).astype(np.float32)
    Aj, At = _pair(a, True, np.float32)
    xjv, xtv = _both(Aj, At, b, method, rtol=1e-5, atol=1e-7)
    want = np.linalg.solve(a, b)
    scale = np.max(np.abs(want))
    # rtol 1e-5 on the residual times kappa = 10
    assert np.max(np.abs(xtv - want)) <= 2e-4 * scale
    assert np.max(np.abs(xtv - xjv)) <= 2e-4 * scale


def _infos(Aj, At, b, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, ij = jsolve(Aj, jnp.asarray(b), return_info=True, **kw)
        _, it = tsolve(At, torch.as_tensor(b), return_info=True, **kw)
    return ij, it


@pytest.mark.parametrize("method, kw, same_count, resid_rtol", [
    ("bicgstab", dict(rtol=1e-8, atol=1e-10), True, 1e-3),
    ("bicgstab", dict(rtol=1e-8, atol=1e-10, max_niter=2), True, 1e-3),
    ("gmres", dict(rtol=1e-8, atol=1e-10), True, 1e-3),
    ("gmres", dict(rtol=1e-8, atol=1e-10, restart=5, max_niter=100), True, 1e-3),
    ("gmres", dict(rtol=1e-12, atol=1e-14, max_niter=3), True, 1e-3),
    # bfloat16 inner solves round differently in the two frameworks: the
    # refinement count may differ, and one refinement's residual (inner
    # tolerance 5e-2) by a fraction of itself
    ("cg_ir", dict(rtol=1e-8, atol=1e-10), False, None),
    ("cg_ir", dict(rtol=1e-8, atol=1e-10, max_refine=1), True, 0.5),
])
def test_return_info_matches_jax(method, kw, same_count, resid_rtol):
    a, rng = _herm(seed=6)
    b = rng.standard_normal((2, N, 2))
    ij, it = _infos(*_pair(a, True), b, method=method, **kw)
    assert set(it) == set(ij) == {"converged", "iterations", "resid", "resid_rel"}
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in it.values())
    assert float(it["converged"]) == float(ij["converged"])
    if same_count:
        assert float(it["iterations"]) == float(ij["iterations"])
        if float(it["converged"]) == 0.0:
            # an unconverged residual is far above round-off: the same number
            np.testing.assert_allclose(float(it["resid"]), float(ij["resid"]),
                                       rtol=resid_rtol)
    assert (float(it["resid_rel"]) < 1.0) == (float(it["converged"]) == 1.0)


@pytest.mark.parametrize("method", ["fused_cg", "scipy_gmres", "broyden1"])
def test_return_info_raises_for_methods_without_info(method):
    a, rng = _herm(seed=7, batch=())
    _, At = _pair(a, True)
    with pytest.raises(RuntimeError, match="return_info"):
        tsolve(At, torch.ones(N, 1, dtype=torch.float64), method=method, return_info=True)


def test_nonconvergence_warns_and_best_iterate_is_returned():
    a, rng = _nonherm(seed=8)
    b = torch.as_tensor(rng.standard_normal((2, N, 2)))
    _, At = _pair(a, False)
    for method in ("bicgstab", "gmres"):
        with pytest.warns(xt.ConvergenceWarning):
            x = tsolve(At, b, method=method, max_niter=1, **TIGHT)
        assert bool(torch.isfinite(x).all())
        with pytest.warns(xt.ConvergenceWarning):
            _, info = tsolve(At, b, method=method, max_niter=1, return_info=True, **TIGHT)
        assert float(info["converged"]) == 0.0 and float(info["iterations"]) == 1.0


@pytest.mark.parametrize("case", ["nonhermitian", "posdef_false", "max_refine_0", "complex"])
def test_cg_ir_falls_back_to_cg(case):
    """The reference's fall-backs: where the outer problem would not be the
    plain hermitian A - ME, cg_ir IS cg (tests/test_solve.py's
    test_solve_cg_ir_nonhermitian_falls_back)."""
    rng = np.random.default_rng(9)
    n = 10
    kw = dict(rtol=1e-9, atol=1e-11, max_niter=400)
    if case == "nonhermitian":
        am = rng.standard_normal((n, n)) + n * np.eye(n)
        A = xt.LinearOperator.m(torch.as_tensor(am))
        assert not A.is_hermitian
    else:
        am, _ = _herm(seed=9, batch=(), n=n)
        A = xt.LinearOperator.m(torch.as_tensor(am), is_hermitian=True)
    b = torch.as_tensor(rng.standard_normal((n, 2)))
    if case == "posdef_false":
        kw["posdef"] = False
    elif case == "max_refine_0":
        kw["max_refine"] = 0
    elif case == "complex":
        am = am + 0j
        A = xt.LinearOperator.m(torch.as_tensor(am), is_hermitian=True)
        b = b + 0j
    x = tsolve(A, b, method="cg_ir", **kw)
    kw.pop("max_refine", None)
    assert torch.equal(x, tsolve(A, b, method="cg", **kw))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(am, b.numpy()), atol=1e-7, rtol=1e-5)


def test_cg_ir_probe_sends_an_operator_that_cannot_take_the_low_type_to_cg():
    a, rng = _herm(seed=10, batch=(), n=12)
    mat = torch.as_tensor(a)

    class Frozen(xt.LinearOperator):
        # its matvec closes over a float64 tensor that is no parameter
        def __init__(self):
            super().__init__(shape=(12, 12), is_hermitian=True, dtype=torch.float64)

        def _mv(self, x):
            return (mat @ x[..., None])[..., 0]

    class Refusing(Frozen):
        def _mv(self, x):
            if x.dtype != torch.float64:
                raise TypeError("float64 only")
            return super()._mv(x)

    b = torch.as_tensor(rng.standard_normal((12, 2)))
    for A in (Frozen(), Refusing()):
        x = tsolve(A, b, method="cg_ir", posdef=True, **TIGHT)
        assert torch.equal(x, tsolve(A, b, method="cg", posdef=True, **TIGHT))


def test_cg_ir_inner_solves_run_at_the_low_type_and_restore_the_operator():
    a, rng = _herm(seed=11, batch=())
    At = xt.LinearOperator.m(torch.as_tensor(a.astype(np.float32)), is_hermitian=True)
    b = torch.as_tensor(rng.standard_normal((N, 2)).astype(np.float32))
    seen = []
    inner = timpl.cg

    def spy(A, B, *args, **kw):
        seen.append((A.mat.dtype, B.dtype))
        return inner(A, B, *args, **kw)

    timpl.cg = spy
    try:
        x, info = tsolve(At, b, method="cg_ir", rtol=1e-6, atol=1e-7, posdef=True,
                         return_info=True)
    finally:
        timpl.cg = inner
    assert seen and set(seen) == {(torch.bfloat16, torch.bfloat16)}
    assert At.mat.dtype == torch.float32 and x.dtype == torch.float32
    assert float(info["converged"]) == 1.0 and float(info["iterations"]) == len(seen)
    # as tests/test_solve.py::test_solve_cg_ir_mixed_precision
    assert float(torch.linalg.norm(At.mm(x) - b, dim=-2).max()) < 1e-4


def test_gmres_zero_column_gives_zero_not_nan():
    """A zero right-hand side breaks the Arnoldi process down at step one
    with a zero triangular factor; the JAX package returns NaN for that
    column (ROADMAP.md queue 3), the port its solution, zero."""
    a, rng = _nonherm(seed=20, batch=())
    b = rng.standard_normal((N, 3))
    b[:, 1] = 0.0
    Aj, At = _pair(a, False)
    for kw in (dict(), dict(restart=5, max_niter=100)):
        x = tsolve(At, torch.as_tensor(b), method="gmres", **TIGHT, **kw)
        assert bool((x[:, 1] == 0).all())
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), atol=1e-6, rtol=0)
    xjv = np.asarray(jsolve(Aj, jnp.asarray(b), method="gmres", **TIGHT))
    assert np.all(np.isnan(xjv[:, 1]))  # the reference's fault, as logged
    np.testing.assert_allclose(xjv[:, [0, 2]], x.numpy()[:, [0, 2]], atol=1e-6, rtol=0)


def test_scipy_gmres_rejects_what_the_bridge_cannot_do():
    a, rng = _nonherm(seed=12)
    b = torch.ones(2, N, 1, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="unbatched"):
        tsolve(xt.LinearOperator.m(torch.as_tensor(a)), b, method="scipy_gmres")
    A1 = xt.LinearOperator.m(torch.as_tensor(a[0]))
    with pytest.raises(RuntimeError, match="AX=B"):
        tsolve(A1, b[0], E=torch.ones(1, dtype=torch.float64), method="scipy_gmres")
    # a batch of B against one matrix is solved column by column
    x = tsolve(A1, b, method="scipy_gmres")
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a[0], b.numpy()), atol=1e-6)


def test_broyden1_names_the_slice_that_brings_it():
    # broyden1 is ported: with a shift E it solves (A - E) X = B column by
    # column as one joint system, as the reference does
    a, rng = _herm(seed=13, batch=(), lo=2.0, hi=10.0)
    b = rng.standard_normal((N, 2))
    e = np.array([0.5, -0.25])
    Aj, At = _pair(a, True)
    kw = dict(f_tol=1e-10, maxiter=2000)
    xjv, xtv = _both(Aj, At, b, "broyden1", E=e, **kw)
    np.testing.assert_allclose(xtv, xjv, atol=1e-8)
    np.testing.assert_allclose(a @ xtv - xtv * e, b, atol=1e-9)


class _Roll(xt.LinearOperator):
    """A matrix-free non-hermitian operator: 3 x + s * roll(x)."""

    def __init__(self, s):
        super().__init__(shape=(N, N), dtype=s.dtype)
        self.s = s

    def _getparamnames(self, prefix=""):
        return [prefix + "s"]

    def _mv(self, x):
        return 3.0 * x + self.s * torch.roll(x, 1, dims=-1)


def test_default_routing_of_explicit_and_hermitian_operators_is_unchanged():
    a, _ = _nonherm(seed=15, batch=())
    assert _default_method(_pair(a, False)[1], None, None) == "exactsolve"
    # (tests/test_torch_solve.py holds the matrix-free non-hermitian route
    # against the JAX package)
    assert _default_method(_Roll(torch.ones(N, dtype=torch.float64)), None, None) == "bicgstab"

    class Herm(_Roll):
        def __init__(self, s):
            xt.LinearOperator.__init__(self, shape=(N, N), is_hermitian=True, dtype=s.dtype)
            self.s = s

        def _mv(self, x):
            return 3.0 * x

    H = Herm(torch.ones(N, dtype=torch.float64))
    assert _default_method(H, None, None) == "cg"
    assert _default_method(H, torch.ones(1), None) == "minres"


def test_fused_cg_goes_to_the_kernels_plain_version_or_to_cg(monkeypatch):
    a, rng = _herm(seed=16)
    b = torch.as_tensor(rng.standard_normal((2, N, 2)).astype(np.float32))
    At = xt.LinearOperator.m(torch.as_tensor(a.astype(np.float32)), is_hermitian=True)
    calls = []
    plain = tfused.fused_cg_plain
    monkeypatch.setattr(tfused, "fused_cg_plain",
                        lambda *args, **kw: calls.append(kw.get("group")) or plain(*args, **kw))
    x = tsolve(At, b, method="fused_cg", rtol=1e-6, atol=1e-8)
    assert calls == [None]  # a CPU tensor: the plain version, the joint stop rule
    # the adjoint solve of the gradient takes it again
    leaf = torch.as_tensor(a.astype(np.float32)).requires_grad_()
    xg = tsolve(xt.LinearOperator.m((leaf + leaf.mT) / 2, is_hermitian=True), b,
                method="fused_cg")
    xg.sum().backward()
    assert len(calls) == 3 and bool(torch.isfinite(leaf.grad).all())
    # outside the explicit-hermitian-unshifted case: cg
    for kw in (dict(E=torch.tensor([0.5, -0.5])),):
        xe = tsolve(At, b, method="fused_cg", **kw)
        assert torch.equal(xe, tsolve(At, b, method="cg", **kw))
    assert len(calls) == 3
    An = xt.LinearOperator.m(torch.as_tensor(a.astype(np.float32)), is_hermitian=False)
    assert torch.equal(tsolve(An, b, method="fused_cg", max_niter=300),
                       tsolve(An, b, method="cg", max_niter=300))
    assert len(calls) == 3 and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("method", ["bicgstab", "fused_cg", "gmres"])
def test_gradcheck_and_gradgradcheck_f64(method):
    rng = np.random.default_rng(17)
    n = 6
    herm = method == "fused_cg"
    a0 = rng.standard_normal((n, n)) * 0.3
    a = torch.tensor(a0 @ a0.T + np.eye(n) if herm else a0 + 3.0 * np.eye(n),
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal((n, 2)), requires_grad=True)

    def f(a, b):
        # a hermitian flag promises a hermitian matrix under perturbation too
        A = xt.LinearOperator.m((a + a.mT) / 2 if herm else a, is_hermitian=herm)
        return tsolve(A, b, method=method, rtol=1e-13, atol=1e-15, max_niter=200)

    assert torch.autograd.gradcheck(f, (a, b))
    assert torch.autograd.gradgradcheck(f, (a, b))


@pytest.mark.parametrize("method", ["bicgstab", "fused_cg", "cg_ir"])
def test_grads_match_jax_grad_f64(method):
    herm = method != "bicgstab"
    a, rng = _herm(seed=18, n=10) if herm else _nonherm(seed=18, n=10)
    b = rng.standard_normal((2, 10, 2))
    w = rng.standard_normal(b.shape)
    kw = dict(rtol=1e-12, atol=1e-14, max_niter=200)
    if method == "cg_ir":
        kw = dict(rtol=1e-10, atol=1e-12, posdef=True)

    def fj(a, b):
        A = xj.LinearOperator.m((a + jnp.swapaxes(a, -1, -2)) / 2 if herm else a,
                                is_hermitian=herm)
        return jnp.sum(jsolve(A, b, method=method, **kw) * w)

    gj = jax.grad(fj, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ts = [torch.tensor(v, requires_grad=True) for v in (a, b)]
    A = xt.LinearOperator.m((ts[0] + ts[0].mT) / 2 if herm else ts[0], is_hermitian=herm)
    x = tsolve(A, ts[1], method=method, **kw)
    gt = torch.autograd.grad((x * torch.as_tensor(w)).sum(), ts)
    for j, t in zip(gj, gt):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)


def test_second_order_grads_through_bicgstab_match_jax_hessian():
    rng = np.random.default_rng(19)
    n = 5
    a = rng.standard_normal((n, n)) * 0.3 + 3.0 * np.eye(n)
    b = rng.standard_normal((n, 1))
    kw = dict(method="bicgstab", rtol=1e-13, atol=1e-15, max_niter=100)

    def fj(b):
        A = xj.LinearOperator.m(jnp.asarray(a), is_hermitian=False)
        return jnp.sum(jsolve(A, b, **kw) ** 3)

    hj = np.asarray(jax.hessian(fj)(jnp.asarray(b))).reshape(n, n)

    def ft(b):
        A = xt.LinearOperator.m(torch.as_tensor(a), is_hermitian=False)
        return (tsolve(A, b, **kw) ** 3).sum()

    ht = torch.autograd.functional.hessian(ft, torch.as_tensor(b)).reshape(n, n)
    np.testing.assert_allclose(ht.numpy(), hj, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("method, opts", [("bicgstab", {"posdef": True}),
                                          ("gmres", {"restart": 100})],
                         ids=["bicgstab", "gmres"])
@pytest.mark.parametrize("lo", [0.0, 0.2, 0.5])
def test_float32_nonhermitian_grid_point_reaches_the_direct_solves_floor(method, opts, lo):
    """The upstream solve benchmark's non-hermitian matrices (a definite
    spectrum under a random non-orthogonal similarity) at n = 100, float32:
    the similarity's conditioning floors the residual above rtol 1e-5, so
    the solvers warn there.  Both packages' iterates must still come within
    10 times the residual a float32 direct solve leaves on the same system
    (the gate ``chip_smoke.py`` holds the card's runs to), and never stay
    at x = 0, which the benchmark's own loose gate would let pass."""
    from xitorch_tpu.utils.tensor import create_random_square_matrix

    n = 100
    a64 = np.asarray(create_random_square_matrix(n, False, lo, 1.0, minabs_eival=0.1, seed=12))
    a = a64.astype(np.float32)
    b = np.random.default_rng(0).standard_normal((n, 50)).astype(np.float32)

    def resid(x):
        return np.linalg.norm(a.astype(np.float64) @ np.asarray(x, np.float64) - b, axis=0).max()

    # (numpy's solve computes float32 input in float64: not a float32 solve)
    floor = resid(torch.linalg.solve(torch.as_tensor(a), torch.as_tensor(b)).numpy())
    kw = dict(rtol=1e-5, atol=1e-7, max_niter=8 * n, **opts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xjv, xtv = _both(*_pair(a, False, np.float32), b, method, **kw)
    assert xtv.dtype == np.float32
    for x in (xjv, xtv):
        assert resid(x) <= 10.0 * floor
        assert resid(x) < 0.01 * np.linalg.norm(b, axis=0).min()
