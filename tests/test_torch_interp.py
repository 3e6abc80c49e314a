"""``interpolate.Interp1D`` and ``integrate.SQuad`` on the port against the
JAX package's (tests/test_interp.py, tests/test_integrate.py) on the same
numpy inputs, float64.

The JAX side of a gradient or of a Pallas run goes through ``jax.jit``
(one compilation instead of one a primitive); the values of the other
cases run eagerly on shared shapes, which JAX compiles once a file.

Tolerances: rtol 1e-8, atol 1e-10, the JAX package's own between its two
tridiagonal routes (tests/test_interp.py).  Both packages run the same
arithmetic in float64, so values and gradients agree to a few ulps; the
dense routes differ only in the LU of the spline system, the Thomas route
against ``lax.linalg.tridiagonal_solve`` only in its pivoting.  Gradients
to the knots x run through the tridiagonal diagonals (``(n,)`` broadcast
against ``(K, n)`` right-hand sides) and through the gathers.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from xitorch_tpu.integrate import SQuad as JSQuad
from xitorch_tpu.interpolate import Interp1D as JInterp1D
from xitorch_tpu_torch.integrate import SQuad
from xitorch_tpu_torch.interpolate import Interp1D
from xitorch_tpu_torch.ops import thomas_cuda

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
F64 = torch.float64
# the Thomas route's knot count in tests/test_interp.py (>= 128: the auto rule)
NT = 160


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=requires_grad)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# knots, queries: the dense cases' shapes
N, NQ = 12, 23


def _knots(n=N, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, (*batch, n)), axis=-1)
    y = rng.standard_normal((3, n))
    y[:, -1] = y[:, 0]  # periodic-compatible
    # queries inside, at the ends and outside the knots
    xq = np.concatenate([rng.uniform(0.02, 0.98, 17), [0.0, 1.0, -0.7, -0.2, 1.3, 2.6]])
    x[..., 0], x[..., -1] = 0.0, 1.0
    return x, y, xq


EXTRAPS = [None, "mirror", "periodic", "bound", "nan", 0.5, "callable"]


def _extrap(name):
    # the callable takes either package's arrays
    return (lambda xq: 10.0 * xq) if name == "callable" else name


@pytest.mark.parametrize("extrap", EXTRAPS, ids=str)
@pytest.mark.parametrize("bc_type", ["natural", "clamped", "not-a-knot", "periodic"])
def test_cspline_matches_jax(bc_type, extrap):
    x, y, xq = _knots()
    kw = {"method": "cspline", "bc_type": bc_type}
    want = JInterp1D(jnp.asarray(x), jnp.asarray(y), extrap=_extrap(extrap),
                     **kw)(jnp.asarray(xq))
    got = Interp1D(_t(x), _t(y), extrap=_extrap(extrap), **kw)(_t(xq))
    assert got.shape == (3, len(xq)) and got.dtype == F64
    _close(got, want)


@pytest.mark.parametrize("extrap", [None, "mirror", "periodic", "bound", 0.5])
@pytest.mark.parametrize("method", ["linear", "pchip"])
def test_linear_and_pchip_match_jax(method, extrap):
    x, y, xq = _knots(seed=1)
    want = JInterp1D(jnp.asarray(x), jnp.asarray(y), method=method, extrap=extrap)(
        jnp.asarray(xq))
    got = Interp1D(_t(x), _t(y), method=method, extrap=extrap)(_t(xq))
    _close(got, want)


@pytest.mark.parametrize("method", ["cspline", "pchip", "linear"])
def test_unsorted_x_with_y_at_call_time_matches_jax(method):
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 1.0, N)
    y = rng.standard_normal((3, N))
    xq = rng.uniform(x.min(), x.max(), NQ)
    want = JInterp1D(jnp.asarray(x), method=method)(jnp.asarray(xq), y=jnp.asarray(y))
    f = Interp1D(_t(x), method=method)
    _close(f(_t(xq), y=_t(y)), want)
    # y given at construction: the same permutation
    _close(Interp1D(_t(x), _t(y), method=method)(_t(xq)), want)


@pytest.mark.parametrize("method, bc_type", [("cspline", "not-a-knot"),
                                             ("cspline", "natural"), ("pchip", None),
                                             ("linear", None)])
def test_batched_knots_against_unbatched_queries_match_jax(method, bc_type):
    x, _, xq = _knots(seed=3, batch=(3,))
    y = np.random.default_rng(3).standard_normal((3, N))
    kw = {"method": method} if bc_type is None else {"method": method, "bc_type": bc_type}
    want = JInterp1D(jnp.asarray(x), jnp.asarray(y), **kw)(jnp.asarray(xq))
    got = Interp1D(_t(x), _t(y), **kw)(_t(xq))
    assert got.shape == (3, NQ)
    _close(got, want)
    # batched y on shared knots, y at call time
    x1 = x[0]
    yb = np.random.default_rng(4).standard_normal((3, N))
    want = JInterp1D(jnp.asarray(x1), **kw)(jnp.asarray(xq), jnp.asarray(yb))
    _close(Interp1D(_t(x1), **kw)(_t(xq), _t(yb)), want)


@pytest.mark.parametrize("bc_type", ["natural", "clamped"])
def test_thomas_route_matches_jax_pallas_and_lax(bc_type):
    """n = 160 takes the tridiagonal route in both packages; JAX's runs
    its Pallas Thomas kernel (interpret mode) or lax's solver."""
    x, y, xq = _knots(NT, seed=5)
    f = Interp1D(_t(x), _t(y), method="cspline", bc_type=bc_type)
    assert f.obj._use_tridiag
    got = f(_t(xq))
    for use_pallas in (True, False):
        want = jax.jit(lambda x, y: JInterp1D(x, y, method="cspline", bc_type=bc_type,
                                              use_pallas=use_pallas)(jnp.asarray(xq)))(
            jnp.asarray(x), jnp.asarray(y))
        _close(got, want)
    # and the dense route of the same spline
    dense = Interp1D(_t(x), _t(y), method="cspline", bc_type=bc_type, use_tridiag=False)
    _close(got, dense(_t(xq)))


GRAD_CASES = [
    ("cspline", "natural", NT),      # the Thomas route
    ("cspline", "clamped", NT),      # the Thomas route, mirror extrapolation
    ("cspline", "not-a-knot", N),
    ("cspline", "periodic", N),
    ("pchip", None, N),
    ("linear", None, N),
]


@pytest.mark.parametrize("method, bc_type, n", GRAD_CASES)
def test_gradients_to_y_and_x_match_jax(method, bc_type, n):
    x, y, _ = _knots(n, seed=6)
    rng = np.random.default_rng(7)
    # inside the knots (not on one): the gathers' intervals are the same
    # on both sides; clamped's default mirror folds the outside ones in
    xq = rng.uniform(0.03, 0.97, 13)
    if bc_type == "clamped":
        xq = np.concatenate([xq, [-0.15, 1.2]])
    w = rng.standard_normal((3, len(xq)))
    kw = {"method": method} if bc_type is None else {"method": method, "bc_type": bc_type}

    def jloss(x, y):
        return jnp.sum(JInterp1D(x, y, **kw)(jnp.asarray(xq)) * w)

    jval, (gx, gy) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x, True), _t(y, True)
    loss = (Interp1D(xt, yt, **kw)(_t(xq)) * _t(w)).sum()
    _close(loss, jval)
    tgx, tgy = torch.autograd.grad(loss, (xt, yt))
    _close(tgy, gy)
    _close(tgx, gx)


def test_gradcheck_and_gradgradcheck_through_the_thomas_route():
    rng = np.random.default_rng(8)
    x = np.sort(rng.uniform(0.0, 1.0, 7))
    x[0], x[-1] = 0.0, 1.0
    xt, yt = _t(x, True), _t(rng.standard_normal(7), True)
    xq = _t(rng.uniform(0.05, 0.95, 5))

    def f(x, y):
        interp = Interp1D(x, y, method="cspline", bc_type="natural", use_tridiag=True)
        assert interp.obj._use_tridiag
        return interp(xq)

    def g(x, y):
        return Interp1D(x, y, method="cspline", bc_type="clamped", use_tridiag=True)(xq)

    for fn in (f, g):
        assert gradcheck(fn, (xt, yt))
        assert gradgradcheck(fn, (xt, yt))


def test_cpu_run_launches_no_kernel():
    thomas_cuda.launches = 0
    x, y, xq = _knots(NT, seed=9)
    yt = _t(y, True)
    out = Interp1D(_t(x), yt, method="cspline", bc_type="natural")(_t(xq)[:17])
    out.sum().backward()
    SQuad(_t(x)).integrate(yt).sum().backward()
    assert thomas_cuda.launches == 0


def test_devices_must_agree():
    x, y, xq = _knots()
    with pytest.raises(RuntimeError, match="one device"):
        Interp1D(_t(x), _t(y).to("meta"))
    f = Interp1D(_t(x), method="linear")
    with pytest.raises(RuntimeError, match="one device"):
        f(_t(xq).to("meta"), _t(y))
    with pytest.raises(RuntimeError, match="one device"):
        SQuad(_t(x)).integrate(_t(y).to("meta"))


# ------------------------------------------------------------------
# SQuad
# ------------------------------------------------------------------

def _samples(seed=10, shape=(2, 3)):
    rng = np.random.default_rng(seed)
    x = np.sort(np.concatenate([[0.0, 1.0], rng.uniform(0.0, 1.0, 29)]))
    y = rng.standard_normal((*shape, len(x)))
    return x, y


@pytest.mark.parametrize("dim, keepdim", [(-1, False), (-1, True), (0, False), (0, True),
                                          (1, False), (-2, True)])
@pytest.mark.parametrize("method", ["cspline", "simpson", "trapz"])
def test_squad_matches_jax(method, dim, keepdim):
    x, y = _samples()
    y = np.moveaxis(y, -1, dim)  # the sample axis at ``dim``
    js = JSQuad(jnp.asarray(x), method=method)
    ts = SQuad(_t(x), method=method)
    _close(ts.cumsum(_t(y), dim=dim), js.cumsum(jnp.asarray(y), dim=dim))
    want = js.integrate(jnp.asarray(y), dim=dim, keepdim=keepdim)
    got = ts.integrate(_t(y), dim=dim, keepdim=keepdim)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("nx", [2, 3, 4, 5, 8])
def test_squad_simpson_weights_at_few_samples_match_jax(nx):
    from xitorch_tpu._impls.integrate.samples_quad import get_simpson_weights as jw
    from xitorch_tpu_torch._impls.integrate.samples_quad import get_simpson_weights

    x = np.sort(np.random.default_rng(nx).uniform(0.0, 1.0, nx))
    _close(get_simpson_weights(_t(x)), jax.jit(jw)(jnp.asarray(x)))


@pytest.mark.parametrize("method", ["cspline", "simpson", "trapz"])
def test_squad_gradients_to_y_and_x_match_jax(method):
    x, y = _samples(seed=11, shape=(3,))
    w = np.random.default_rng(12).standard_normal((3, len(x)))

    def jloss(x, y):
        sq = JSQuad(x, method=method)
        return jnp.sum(sq.cumsum(y) * w) + jnp.sum(sq.integrate(y) ** 2)

    gx, gy = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x, True), _t(y, True)
    sq = SQuad(xt, method=method)
    loss = (sq.cumsum(yt) * _t(w)).sum() + (sq.integrate(yt) ** 2).sum()
    tgx, tgy = torch.autograd.grad(loss, (xt, yt))
    _close(tgy, gy)
    _close(tgx, gx)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_draws_the_benchmarks_interpolation_data(monkeypatch):
    # chip_smoke.py's interpolation phase runs bench_quad_interp.py's
    # workload as the benchmark draws it (the benchmark imports JAX, the
    # script may not)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the benchmark adds to it
    bench = _load("bench_quad_interp", "benchmarks/bench_quad_interp.py")
    smoke = _load("chip_smoke", "chip_smoke.py")
    assert (smoke.NCURVE, smoke.NKNOT, smoke.NQ) == (bench.NCURVE, bench.NKNOT, bench.NQ)
    for got, want in zip(smoke.interp_data(np), bench._interp_data(jnp.float64)[3:]):
        assert np.array_equal(got, want)
