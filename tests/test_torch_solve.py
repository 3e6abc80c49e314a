"""``linalg.solve`` of the port against xitorch_tpu's, on the same inputs.

Methods at float64 agree to 1e-6 (the solvers' own rtol: both iterate the
same recurrences, summed in another order); structured_cg at float32 to
1e-4 (per-system vs tile stop, see test_torch_kernels_cpu.py).  Gradients
at float64 agree to 1e-6 with jax.grad and pass gradcheck/gradgradcheck.
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
from xitorch_tpu_torch.linalg import solve as tsolve
from xitorch_tpu_torch.ops import tridiag as ttri

torch.set_num_threads(1)

N = 24


def _spd(seed=0, batch=2, n=N):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    ev = np.linspace(1.0, 10.0, n)
    return (q * ev[..., None, :]) @ np.swapaxes(q, -1, -2), rng


def _tridiag_np(seed=0, batch=3, n=N, r=2, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = 4.0 + rng.uniform(size=(batch, n))
    c = 0.5 + 0.1 * rng.uniform(size=(batch, n - 1))
    V = rng.standard_normal((batch, n, r)) / np.sqrt(n)
    b = rng.standard_normal((batch, n, 2))
    return [a.astype(dtype) for a in (d, c, V, b)]


def _ops(d, c, V):
    Aj = xj.TridiagLowRankOperator(jnp.asarray(d), jnp.asarray(c),
                                   None if V is None else jnp.asarray(V))
    At = xt.TridiagLowRankOperator(torch.as_tensor(d), torch.as_tensor(c),
                                   None if V is None else torch.as_tensor(V))
    return Aj, At


@pytest.mark.parametrize("method", ["cg", "minres", "exactsolve", "custom_exactsolve"])
@pytest.mark.parametrize("op", ["matrix", "tridiag"])
def test_methods_match_jax_f64(method, op):
    if op == "matrix":
        a, rng = _spd()
        b = rng.standard_normal((2, N, 3))
        Aj, At = xj.LinearOperator.m(jnp.asarray(a)), xt.LinearOperator.m(torch.as_tensor(a))
    else:
        d, c, V, b = _tridiag_np()
        Aj, At = _ops(d, c, V)
    kw = dict(rtol=1e-10, atol=1e-12) if method in ("cg", "minres") else {}
    xjv = jsolve(Aj, jnp.asarray(b), method=method, **kw)
    xtv = tsolve(At, torch.as_tensor(b), method=method, **kw)
    np.testing.assert_allclose(xtv.numpy(), np.asarray(xjv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["cg", "minres", "exactsolve"])
def test_e_shifted_methods_match_jax_f64(method):
    d, c, V, b = _tridiag_np(seed=1)
    Aj, At = _ops(d, c, V)
    E = np.array([-1.0, 0.5])
    kw = dict(rtol=1e-10, atol=1e-12) if method != "exactsolve" else {}
    if method == "cg":
        kw["posdef"] = True  # -1 and 0.5 lie below the spectrum (>= ~3)
    xjv = jsolve(Aj, jnp.asarray(b), E=jnp.asarray(E), method=method, **kw)
    xtv = tsolve(At, torch.as_tensor(b), E=torch.as_tensor(E), method=method, **kw)
    np.testing.assert_allclose(xtv.numpy(), np.asarray(xjv), atol=1e-6, rtol=0)


def test_cg_posdef_probe_and_lean_loop_match_jax():
    a, rng = _spd(seed=3)
    a = -a  # negative definite: the probe sends cg to the normal equations
    b = rng.standard_normal((2, N, 1))
    Aj, At = xj.LinearOperator.m(jnp.asarray(a)), xt.LinearOperator.m(torch.as_tensor(a))
    for kw in (dict(), dict(track_best=False, posdef=False)):
        xjv = jsolve(Aj, jnp.asarray(b), method="cg", rtol=1e-10, atol=1e-12,
                     max_niter=400, **kw)
        xtv = tsolve(At, torch.as_tensor(b), method="cg", rtol=1e-10, atol=1e-12,
                     max_niter=400, **kw)
        np.testing.assert_allclose(xtv.numpy(), np.asarray(xjv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("op", ["tridiag", "banded"])
def test_structured_cg_matches_jax_f32(op):
    d, c, V, b = _tridiag_np(seed=4, dtype=np.float32)
    if op == "tridiag":
        Aj, At = _ops(d, c, V)
    else:
        c2 = (0.3 * np.ones((3, N - 2))).astype(np.float32)
        Aj = xj.BandedLowRankOperator(jnp.asarray(d), {1: jnp.asarray(c), 2: jnp.asarray(c2)},
                                      jnp.asarray(V))
        At = xt.BandedLowRankOperator(torch.as_tensor(d), {1: torch.as_tensor(c),
                                                          2: torch.as_tensor(c2)},
                                      torch.as_tensor(V))
    xjv, ij = jsolve(Aj, jnp.asarray(b), method="structured_cg", interpret=True,
                     return_info=True)
    xtv, it = tsolve(At, torch.as_tensor(b), method="structured_cg", return_info=True)
    xjv = np.asarray(xjv)
    # f32; per-system vs tile-uniform stop, both below rtol/2
    assert np.max(np.abs(xtv.numpy() - xjv)) <= 1e-4 * np.max(np.abs(xjv))
    assert float(it["converged"]) == float(ij["converged"]) == 1.0


def _infos(Aj, At, b, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, ij = jsolve(Aj, jnp.asarray(b), return_info=True, **kw)
        _, it = tsolve(At, torch.as_tensor(b), return_info=True,
                       **{k: (torch.as_tensor(np.asarray(v)) if k == "E" else v)
                          for k, v in kw.items() if k != "interpret"})
    return ij, it


@pytest.mark.parametrize("method, kw", [
    ("cg", dict(rtol=1e-8, atol=1e-10)),
    ("cg", dict(rtol=1e-8, atol=1e-10, max_niter=2)),
    ("minres", dict(rtol=1e-8, atol=1e-10)),
    ("exactsolve", dict()),
])
def test_return_info_matches_jax(method, kw):
    d, c, V, b = _tridiag_np(seed=5)
    Aj, At = _ops(d, c, V)
    ij, it = _infos(Aj, At, b, method=method, **kw)
    assert float(it["converged"]) == float(ij["converged"])
    assert float(it["iterations"]) == float(ij["iterations"])
    # the measured residual: equal up to f64 round-off of the residual itself
    np.testing.assert_allclose(float(it["resid"]), float(ij["resid"]), rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("shift, converged", [("eigenvalue", 0.0), ("regular", 1.0)])
def test_thomas_singular_shift_reports_failure(shift, converged):
    n = 16
    d = np.full((n,), 2.0, np.float32)
    c = np.full((n - 1,), -1.0, np.float32)
    Aj, At = _ops(d, c, None)
    lam0 = float(np.linalg.eigvalsh(np.asarray(Aj.fullmatrix()))[0])
    E = np.asarray([lam0 if shift == "eigenvalue" else 0.11], np.float32)
    b = np.ones((n, 1), np.float32)
    ij, it = _infos(Aj, At, b, E=E, method="structured_cg", interpret=True)
    assert float(it["converged"]) == float(ij["converged"]) == converged


def test_nonconvergence_warns_and_assert_converged_raises():
    d, c, V, b = _tridiag_np(seed=6)
    _, At = _ops(d, c, V)
    with pytest.warns(xt.ConvergenceWarning):
        tsolve(At, torch.as_tensor(b), method="cg", max_niter=1)
    with pytest.warns(xt.ConvergenceWarning):
        _, info = tsolve(At, torch.as_tensor(b), method="cg", max_niter=1, return_info=True)
    with pytest.raises(RuntimeError, match="did not converge"):
        xt.assert_converged(info)


def test_default_routing_e_shift_goes_to_minres():
    d, c, V, b = _tridiag_np(seed=7)
    _, At = _ops(d, c, V)
    E = torch.tensor([0.3, -0.2], dtype=torch.float64)
    x_default = tsolve(At, torch.as_tensor(b), E=E)
    x_minres = tsolve(At, torch.as_tensor(b), E=E, method="minres")
    assert torch.equal(x_default, x_minres)


def test_default_routing_pure_tridiag_takes_thomas(monkeypatch):
    d, c, _, b = _tridiag_np(seed=8, dtype=np.float32)
    Aj, At = _ops(d, c, None)
    calls = []
    plain = ttri.thomas_plain
    monkeypatch.setattr(ttri, "thomas_plain", lambda *a: calls.append(1) or plain(*a))
    xtv = tsolve(At, torch.as_tensor(b))
    assert calls  # the direct Thomas solve, not an iteration
    xjv = np.asarray(jsolve(Aj, jnp.asarray(b), method="structured_cg", interpret=True))
    assert np.max(np.abs(xtv.numpy() - xjv)) <= 1e-5 * np.max(np.abs(xjv))


@pytest.mark.parametrize("method", ["broyden1"])
def test_unported_method_raises(method):
    # the last method that was not ported, broyden1, now is: the Broyden
    # rootfinder on the residual, one joint system, against the reference's
    d, c, V, b = _tridiag_np()
    Aj, At = _ops(d, c, V)
    kw = dict(f_tol=1e-10, maxiter=2000)
    xt_ = tsolve(At, torch.as_tensor(b), method=method, **kw)
    xj = jsolve(Aj, jnp.asarray(b), method=method, **kw)
    assert xt_.shape == (3, N, 2)
    np.testing.assert_allclose(xt_.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_allclose((At.mm(xt_) - torch.as_tensor(b)).numpy(), 0.0, atol=1e-9)


def test_non_hermitian_default_routes_to_bicgstab_and_agrees_with_jax():
    rng = np.random.default_rng(9)
    s = rng.uniform(size=N)

    class Shift(xt.LinearOperator):
        def __init__(self, s):
            super().__init__(shape=(N, N), dtype=s.dtype)
            self.s = s

        def _getparamnames(self, prefix=""):
            return [prefix + "s"]

        def _mv(self, x):
            return 3.0 * x + self.s * torch.roll(x, 1, dims=-1)

    class ShiftJ(xj.LinearOperator):
        def __init__(self, s):
            super().__init__(shape=(N, N), dtype=s.dtype)
            self.s = s

        def _getparamnames(self, prefix=""):
            return [prefix + "s"]

        def _mv(self, x):
            return 3.0 * x + self.s * jnp.roll(x, 1, axis=-1)

    A = Shift(torch.as_tensor(s))
    b = torch.ones(N, 1, dtype=torch.float64)
    x = tsolve(A, b)
    assert torch.equal(x, tsolve(A, b, method="bicgstab"))
    xjv = jsolve(ShiftJ(jnp.asarray(s)), jnp.ones((N, 1)))
    np.testing.assert_allclose(x.numpy(), np.asarray(xjv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["cg", "minres", "custom_exactsolve", "structured_cg"])
def test_gradcheck_and_gradgradcheck_f64(method):
    d, c, V, b = (torch.tensor(a, requires_grad=True)
                  for a in _tridiag_np(seed=10, batch=2, n=6, r=1))
    E = torch.tensor([-0.5, 0.25], dtype=torch.float64, requires_grad=True)

    def f(d, c, V, b, E):
        A = xt.TridiagLowRankOperator(d, c, V)
        return tsolve(A, b, E=E if method != "structured_cg" else None, method=method,
                      rtol=1e-12, atol=1e-14)

    assert torch.autograd.gradcheck(f, (d, c, V, b, E))
    assert torch.autograd.gradgradcheck(f, (d, c, V, b, E))


@pytest.mark.parametrize("method", ["cg", "minres", "exactsolve"])
def test_grads_match_jax_grad_f64(method):
    d, c, V, b = _tridiag_np(seed=11, batch=2, n=10)
    E = np.array([-0.5, 0.25])
    w = np.random.default_rng(12).standard_normal(b.shape)
    kw = dict(rtol=1e-12, atol=1e-14) if method != "exactsolve" else {}
    if method == "cg":
        kw["posdef"] = True

    def fj(d, c, V, b, E):
        A = xj.TridiagLowRankOperator(d, c, V)
        return jnp.sum(jsolve(A, b, E=E, method=method, **kw) * w)

    gj = jax.grad(fj, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (d, c, V, b, E)))
    ts = [torch.tensor(a, requires_grad=True) for a in (d, c, V, b, E)]
    x = tsolve(xt.TridiagLowRankOperator(*ts[:3]), ts[3], E=ts[4], method=method, **kw)
    gt = torch.autograd.grad((x * torch.as_tensor(w)).sum(), ts)
    for a, t in zip(gj, gt):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_shape_checks_raise():
    d, c, V, b = _tridiag_np()
    _, At = _ops(d, c, V)
    bt = torch.as_tensor(b)
    with pytest.raises(RuntimeError):
        tsolve(At, bt[:, :-1])
    with pytest.raises(RuntimeError):
        tsolve(At, bt, E=torch.ones(3, dtype=torch.float64))
    with pytest.raises(RuntimeError):
        tsolve(xt.LinearOperator.m(torch.ones(3, 4, dtype=torch.float64)), bt)
