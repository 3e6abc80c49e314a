"""BASELINE config 4's module on the port: ``integrate.solve_ivp`` (every
method, both adjoints, dict states, decreasing ``ts``, ``torch.func.vmap``
over the adaptive stepper), ``quad`` and ``mcquad`` against the JAX
package's (tests/test_integrate.py) on the same numpy inputs, float64.

Tolerances: both packages run the same arithmetic in float64, so values
and gradients agree to ~1e-14 where no sampling is involved; the limits
(1e-6 for trajectories, as the issue's parity rule sets, 1e-8 relative for
gradients and Hessians) leave room for a different summation order only.
Adaptive step counts must be equal: a step decision turns on ``err < 1``,
which a last-bit difference flips only by accident, and the same counts
mean the same discrete solution.  Metropolis-Hastings draws from a
``torch.Generator``, not from ``jax.random``, so ``mh`` is held to the
analytic moments by statistics only."""
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.integrate import mcquad as jmcquad
from xitorch_tpu.integrate import quad as jquad
from xitorch_tpu.integrate import solve_ivp as jsolve_ivp
from xitorch_tpu_torch._impls.integrate.mcmc import mh
from xitorch_tpu_torch.integrate import mcquad, quad, solve_ivp

torch.set_num_threads(1)

F64 = torch.float64
YTOL = 1e-6
GRTOL = 1e-8


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), dtype=F64, requires_grad=requires_grad)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def jfnl(t, y, a):
    return a * y + jnp.sin(t) * jnp.tanh(y)


def tfnl(t, y, a):
    return a * y + torch.sin(t) * torch.tanh(y)


Y0 = np.array([0.7, -0.2])
A0 = -0.8
TS = np.linspace(0.0, 2.0, 11)
ADAPTIVE_OPTS = {"rk45": {"atol": 1e-10, "rtol": 1e-9}, "rk23": {"atol": 1e-7, "rtol": 1e-6}}
METHODS = ["euler", "mid_point", "rk4", "rk38", "rk23", "rk45", "bwd_euler", "trapezoidal",
           "sdirk2"]


@pytest.mark.parametrize("method", METHODS)
def test_solve_ivp_method_matches_jax(method):
    """The trajectory, the adaptive methods' step accounting, and the first-
    and second-order derivatives of sum(y^2) to the parameter."""
    opts = ADAPTIVE_OPTS.get(method, {})
    jts, tts = jnp.asarray(TS), _t(TS)

    def jloss(a):
        return jnp.sum(jsolve_ivp(jfnl, jts, jnp.asarray(Y0), params=(a,), method=method,
                                  **opts) ** 2)

    a = _t(A0, requires_grad=True)
    if method in ADAPTIVE_OPTS:
        yj, ij = jsolve_ivp(jfnl, jts, jnp.asarray(Y0), params=(jnp.asarray(A0),),
                            method=method, return_info=True, **opts)
        yt, it = solve_ivp(tfnl, tts, _t(Y0), params=(a,), method=method, return_info=True,
                           **opts)
        assert {k: float(v) for k, v in it.items()} == {k: float(v) for k, v in ij.items()}
        assert float(it["converged"]) == 1.0
    else:
        yj = jsolve_ivp(jfnl, jts, jnp.asarray(Y0), params=(jnp.asarray(A0),), method=method)
        yt = solve_ivp(tfnl, tts, _t(Y0), params=(a,), method=method)
    assert yt.shape == (TS.size, 2)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0, atol=YTOL)

    (g,) = torch.autograd.grad((yt ** 2).sum(), a, create_graph=True)
    (h,) = torch.autograd.grad(g, a)
    assert _rel(g.detach(), jax.grad(jloss)(jnp.asarray(A0))) <= GRTOL
    assert _rel(h, jax.hessian(jloss)(jnp.asarray(A0))) <= GRTOL


def test_vmap_over_rk45_matches_per_trajectory_calls_and_jax_vmap():
    """torch.func.vmap over the adaptive stepper gives each trajectory its
    own steps: equal to one call per trajectory and to jax.vmap, with the
    same accepted and rejected counts per trajectory."""
    av = np.array([-0.3, -0.6, -1.0, -2.5])
    ts = np.linspace(0.0, 1.5, 6)
    opts = {"atol": 1e-9, "rtol": 1e-8}
    yj, ij = jax.vmap(lambda a: jsolve_ivp(jfnl, jnp.asarray(ts), jnp.asarray(Y0), params=(a,),
                                           method="rk45", return_info=True, **opts)
                      )(jnp.asarray(av))
    yt, it = torch.func.vmap(lambda a: solve_ivp(tfnl, _t(ts), _t(Y0), params=(a,),
                                                 method="rk45", return_info=True,
                                                 max_steps=256, **opts))(_t(av))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=YTOL)
    for key in ("iterations", "rejected", "converged"):
        np.testing.assert_array_equal(it[key].numpy(), np.asarray(ij[key]))
    assert len(set(it["iterations"].tolist())) > 1   # the steps differ by trajectory
    for k, a in enumerate(av):
        y1, i1 = solve_ivp(tfnl, _t(ts), _t(Y0), params=(_t(a),), method="rk45",
                           return_info=True, **opts)
        np.testing.assert_allclose(y1.numpy(), yt[k].numpy(), rtol=0, atol=1e-14)
        assert float(i1["iterations"]) == float(it["iterations"][k])


@pytest.mark.parametrize("method", ["rk45", "rk4"])
def test_dict_state_and_decreasing_ts_match_jax(method):
    def jf(t, y, a):
        return {"p": a * y["q"], "q": -a * y["p"] + 0.1 * jnp.sin(t)}

    def tf(t, y, a):
        return {"p": a * y["q"], "q": -a * y["p"] + 0.1 * torch.sin(t)}

    ts = np.linspace(1.0, 0.0, 7)
    y0 = {"q": np.array([0.0, 0.5]), "p": np.array([1.0, -0.3])}
    opts = {"atol": 1e-10, "rtol": 1e-9} if method == "rk45" else {}
    yj = jsolve_ivp(jf, jnp.asarray(ts), {k: jnp.asarray(v) for k, v in y0.items()},
                    params=(jnp.asarray(1.3),), method=method, **opts)
    yt = solve_ivp(tf, _t(ts), {k: _t(v) for k, v in y0.items()}, params=(_t(1.3),),
                   method=method, **opts)
    assert set(yt) == {"p", "q"}
    for k in yt:
        assert yt[k].shape == (7, 2)
        np.testing.assert_allclose(yt[k].numpy(), np.asarray(yj[k]), rtol=0, atol=YTOL)


def test_backsolve_gradients_match_jax_backsolve():
    """The continuous adjoint on a time-dependent field: gradients to ts
    (including ts[0]), the two parameters and y0, against JAX's backsolve;
    the port's backsolve also stays within the discretisation gap of its
    own autodiff gradients.  A gradient of the gradient raises."""
    def jf(t, y, a, w):
        return a * y + jnp.sin(w * t) * (1.0 + 0.3 * y)

    def tf(t, y, a, w):
        return a * y + torch.sin(w * t) * (1.0 + 0.3 * y)

    vals = (np.linspace(0.15, 1.35, 6), -0.4, 2.3, np.array([0.9, 1.4]))
    opts = {"method": "rk45", "atol": 1e-11, "rtol": 1e-10}

    def jrun(ts, a, w, y0):
        yt = jsolve_ivp(jf, ts, y0, params=(a, w), adjoint="backsolve", **opts)
        return jnp.sum(jnp.arange(1.0, ts.shape[0] + 1.0)[:, None] * yt ** 2)

    gj = jax.grad(jrun, argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in vals))
    grads, args = {}, {}
    for adjoint in ("backsolve", "autodiff"):
        args[adjoint] = [_t(v, requires_grad=True) for v in vals]
        ts, a, w, y0 = args[adjoint]
        yt = solve_ivp(tf, ts, y0, params=(a, w), adjoint=adjoint, **opts)
        loss = (torch.arange(1.0, 7.0, dtype=F64)[:, None] * yt ** 2).sum()
        grads[adjoint] = torch.autograd.grad(loss, args[adjoint],
                                             create_graph=adjoint == "backsolve")
    for a, b in zip(gj, grads["backsolve"]):
        assert _rel(b.detach(), a) <= GRTOL
    for a, b in zip(grads["autodiff"], grads["backsolve"]):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(), rtol=2e-5, atol=1e-9)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        grads["backsolve"][1].backward()


def test_return_info_budget_and_fixed_step():
    ts = np.linspace(0.0, 2.0, 6)
    # a budget that runs out: not converged, the outputs past the last
    # reached time hold the last state, as in JAX
    kw = {"atol": 1e-12, "rtol": 1e-12, "max_steps": 3, "return_info": True}
    yj, ij = jsolve_ivp(jfnl, jnp.asarray(ts), jnp.asarray(Y0), params=(jnp.asarray(A0),),
                        method="rk45", **kw)
    yt, it = solve_ivp(tfnl, _t(ts), _t(Y0), params=(_t(A0),), method="rk45", **kw)
    assert float(it["converged"]) == 0.0 == float(ij["converged"])
    assert float(it["iterations"]) == float(ij["iterations"])
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=YTOL)
    y4, i4 = solve_ivp(tfnl, _t(ts), _t(Y0), params=(_t(A0),), method="rk4", return_info=True)
    assert float(i4["converged"]) == 1.0 and float(i4["iterations"]) == ts.size - 1
    with pytest.raises(RuntimeError, match="return_info"):
        solve_ivp(tfnl, _t(ts), _t(Y0), params=(_t(A0),), adjoint="backsolve",
                  return_info=True)
    with pytest.raises(RuntimeError, match="1D"):
        solve_ivp(tfnl, _t(ts)[None], _t(Y0), params=(_t(A0),))


# examples/02-molecular-dynamics's problem at its own start: the example
# draws pos0 in float32 (JAX's default; under x64 the same key draws another
# start), 4 bodies at rest, a dict state, 20 times over 2 s, rk45 at atol
# 1e-8, rtol 1e-7.  Bodies 2 and 3 pass within 0.02 of each other near
# t = 1.95 (the softening is 1e-6 in r^2).
MD_POS0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 2), jnp.float32) * 1.5,
                     np.float64)
MD_TARGET = np.array([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]])
MD_TOL = {"atol": 1e-8, "rtol": 1e-7, "max_steps": 512}


def _jdydt(t, s, m):
    disp = s["pos"][None, :, :] - s["pos"][:, None, :]
    dist3 = (jnp.sum(disp ** 2, axis=-1) + 1e-6) ** 1.5
    return {"pos": s["vel"], "vel": jnp.sum(m[None, :, None] * disp / dist3[..., None], 1)}


def _tdydt(t, s, m):
    disp = s["pos"][None, :, :] - s["pos"][:, None, :]
    dist3 = ((disp ** 2).sum(-1) + 1e-6) ** 1.5
    return {"pos": s["vel"], "vel": (m[None, :, None] * disp / dist3[..., None]).sum(1)}


def _md_jax(dt, adjoint="autodiff", tol=MD_TOL):
    """JAX's loss and gradient to v0 = 0."""
    def jloss(v0):
        yt = jsolve_ivp(_jdydt, jnp.linspace(0.0, 2.0, 20, dtype=dt),
                        {"pos": jnp.asarray(MD_POS0, dt), "vel": v0},
                        params=(jnp.ones(4, dt),), method="rk45", adjoint=adjoint,
                        **tol)
        return jnp.mean((yt["pos"][-1] - jnp.asarray(MD_TARGET, dt)) ** 2)

    loss, g = jax.value_and_grad(jloss)(jnp.zeros((4, 2), dt))
    return float(loss), np.asarray(g, np.float64)


def _md_port(dt, adjoint="autodiff", tol=MD_TOL):
    """The port's loss and gradient to v0 = 0."""
    v0 = torch.zeros((4, 2), dtype=dt, requires_grad=True)
    yt = solve_ivp(_tdydt, torch.linspace(0.0, 2.0, 20, dtype=dt),
                   {"pos": torch.tensor(MD_POS0, dtype=dt), "vel": v0},
                   params=(torch.ones(4, dtype=dt),), method="rk45", adjoint=adjoint, **tol)
    loss = ((yt["pos"][-1] - torch.tensor(MD_TARGET, dtype=dt)) ** 2).mean()
    return float(loss.detach()), torch.autograd.grad(loss, v0)[0].double().numpy()


def _l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_md_example_matches_jax_and_its_float32_gradient_is_ill_conditioned():
    """examples/02's problem: in float64 the port's loss and gradient to v0
    equal the JAX package's.  In float32 neither package's gradient is near
    its float64 one: rtol 1e-7 lies below float32's eps and the close
    encounter amplifies the rounding (a property of the example, logged in
    ROADMAP.md queue 3)."""
    l64, g64 = _md_port(F64)
    lj, gj = _md_jax(jnp.float64)
    assert abs(l64 - lj) <= 1e-9 * abs(lj)
    assert _rel(g64, gj) <= 1e-6
    _, g32 = _md_port(torch.float32)
    _, gj32 = _md_jax(jnp.float32)
    scale = np.abs(g64).max()
    assert np.abs(g32 - g64).max() > scale and np.abs(gj32 - g64).max() > scale


def test_md_example_backsolve_matches_jax_backsolve_and_its_gap_closes_with_the_tolerance():
    """examples/02's problem in float64 by the continuous adjoint: the
    port's backsolve gradient equals JAX's (the limit, 1e-6 in L2, is the
    two packages' summation order amplified through the encounter; their
    autodiff gradients differ by ~2e-7).  At the example's tolerances both
    packages' backsolve gradients lie ~0.5 in L2 from their autodiff ones,
    the same gap to 1e-6: each adjoint carries its own discretisation error
    through the encounter.  At rtol 1e-9, atol 1e-10 the port's backsolve
    comes within 5e-3 of JAX's autodiff (measured 1.8e-3 against the
    port's autodiff): the gap closes as the tolerance tightens, so it is
    the method's, not a fault.  chip_smoke.py holds the card's float64
    gradients against the values it keeps, which are JAX's."""
    _, ga = _md_port(F64)
    lb, gb = _md_port(F64, "backsolve")
    _, gja = _md_jax(jnp.float64)
    ljb, gjb = _md_jax(jnp.float64, "backsolve")
    assert abs(lb - ljb) <= 1e-9 * abs(ljb)
    assert _l2(gb, gjb) <= 1e-6
    gap, jgap = _l2(gb, ga), _l2(gjb, gja)
    assert 0.4 <= gap <= 0.6 and abs(gap - jgap) <= 1e-6
    tight = {"atol": 1e-10, "rtol": 1e-9, "max_steps": 4096}
    _, gbt = _md_port(F64, "backsolve", tight)
    _, gjt = _md_jax(jnp.float64, "autodiff", tight)
    assert _l2(gbt, gjt) <= 5e-3
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    np.testing.assert_array_equal(np.asarray(smoke.EXAMPLE_POS0), MD_POS0)
    assert _l2(np.asarray(smoke.EXAMPLE_GRAD["autodiff"]), gja) <= 1e-12
    assert _l2(np.asarray(smoke.EXAMPLE_GRAD["backsolve"]), gjb) <= 1e-12


# ------------------------- quad -------------------------

def jgauss(x, g, w):
    return jnp.exp(-0.5 * ((x - g) / w) ** 2) / w


def tgauss(x, g, w):
    return torch.exp(-0.5 * ((x - g) / w) ** 2) / w


@pytest.mark.parametrize("method", ["leggauss", "tanhsinh"])
def test_quad_matches_jax_to_second_order(method):
    vals = (-3.0, 4.0, 0.2, 1.3)

    def jres(xl, xu, g, w):
        return jquad(jgauss, xl, xu, params=(g, w), method=method, n=120)

    args = [_t(v, requires_grad=True) for v in vals]
    val = quad(tgauss, args[0], args[1], params=(args[2], args[3]), method=method, n=120)
    grads = torch.autograd.grad(val, args, create_graph=True)
    hess = torch.stack([torch.stack(torch.autograd.grad(g, args, retain_graph=True))
                        for g in grads])
    jargs = [jnp.asarray(v) for v in vals]
    assert _rel(val.detach(), jres(*jargs)) <= GRTOL
    assert _rel(torch.stack(grads).detach(),
                jnp.stack(jax.grad(jres, argnums=(0, 1, 2, 3))(*jargs))) <= GRTOL
    jh = jax.hessian(jres, argnums=(0, 1, 2, 3))(*jargs)
    assert _rel(hess, np.array([[float(v) for v in row] for row in jh])) <= GRTOL
    # d/dxu = f(xu)
    assert _rel(grads[1].detach(), tgauss(args[1], args[2], args[3]).detach()) <= 1e-6


def test_quad_infinite_bounds_and_tree_output():
    w = _t(1.1, requires_grad=True)
    val = quad(lambda x, w: torch.exp(-0.5 * (x / w) ** 2), -math.inf, math.inf,
               params=(w,), n=200)
    jval = jquad(lambda x, w: jnp.exp(-0.5 * (x / w) ** 2), -np.inf, np.inf,
                 params=(jnp.asarray(1.1),), n=200)
    assert _rel(val.detach(), jval) <= GRTOL
    (g,) = torch.autograd.grad(val, w)
    assert abs(float(g) - math.sqrt(2 * math.pi)) <= 1e-5 * math.sqrt(2 * math.pi)
    r1, r2 = quad(lambda x, a: (a * x, {"sq": x ** 2, "cu": x ** 3}), 0.0, 1.0,
                  params=(_t(1.5),), n=32)
    assert abs(float(r1) - 0.75) < 1e-12
    assert abs(float(r2["sq"]) - 1 / 3) < 1e-12 and abs(float(r2["cu"]) - 0.25) < 1e-12
    # tanhsinh through an endpoint singularity, a float32 CPU bound (whose
    # nodes stop ~1e-7 from the ends)
    r = quad(lambda x: 1.0 / torch.sqrt(x), torch.tensor(0.0), 1.0, method="tanhsinh")
    assert r.dtype == torch.float32 and abs(float(r) - 2.0) < 1e-3
    with pytest.raises(RuntimeError, match="1-element"):
        quad(tgauss, _t([0.0, 1.0]), 1.0, params=(_t(0.0), _t(1.0)))


def test_quad_goes_to_the_card_unless_told():
    """With no tensor among the bounds and params, the integral runs on the
    card: without one it raises, it does not carry on on the CPU.  A CPU
    tensor bound asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        quad(lambda x: x * x, 0.0, 1.0)
    assert float(quad(lambda x: x * x, _t(0.0), 1.0)) == pytest.approx(1 / 3)


# ------------------------- mcquad -------------------------

def _logp(x, mu, sigma):
    return -0.5 * ((x - mu) / sigma) ** 2


def test_mcquad_dummy1d_matches_jax_to_second_order():
    def jepf(a, mu, sigma):
        return jmcquad(lambda x, a: a * x * x, _logp, jnp.asarray(0.0), fparams=(a,),
                       pparams=(mu, sigma), method="dummy1d", nsamples=200)

    vals = (2.0, 0.3, 0.8)
    args = [_t(v, requires_grad=True) for v in vals]
    val = mcquad(lambda x, a: a * x * x, _logp, _t(0.0), fparams=(args[0],),
                 pparams=(args[1], args[2]), method="dummy1d", nsamples=200)
    grads = torch.autograd.grad(val, args, create_graph=True)
    (h,) = torch.autograd.grad(grads[1], args[1])
    jargs = [jnp.asarray(v) for v in vals]
    assert _rel(val.detach(), jepf(*jargs)) <= GRTOL
    for i in range(3):
        assert _rel(grads[i].detach(), jax.grad(jepf, argnums=i)(*jargs)) <= GRTOL
    assert _rel(h, jax.hessian(jepf, argnums=1)(*jargs)) <= GRTOL
    # the analytic moment a (sigma^2 + mu^2)
    assert _rel(val.detach(), 2.0 * (0.8 ** 2 + 0.3 ** 2)) <= 1e-5


def test_mcquad_mh_statistics_and_gradient():
    """The chains' pooled mean and the gradient of E[|x|^2] to mu land on
    the analytic values within about 4 standard errors (tests/
    test_integrate.py's bounds), the chains agree with each other, and a
    seed reproduces its draws."""
    mu = _t([0.5, -0.2], requires_grad=True)

    def logp(x, mu):
        return -0.5 * ((x - mu) ** 2).sum()

    ev = mcquad(lambda x: x, logp, torch.zeros(2, dtype=F64), pparams=(mu,), method="mh",
                nsamples=20000, nburnout=2000, step_size=0.8)
    np.testing.assert_allclose(ev.detach().numpy(), [0.5, -0.2], atol=0.08)
    ex2 = mcquad(lambda x: (x ** 2).sum(), logp, torch.zeros(2, dtype=F64), pparams=(mu,),
                 method="mh", nsamples=32000, nburnout=500, step_size=0.8)
    (g,) = torch.autograd.grad(ex2, mu)
    assert abs(float(ex2.detach()) - (0.29 + 2.0)) < 0.25
    np.testing.assert_allclose(g.numpy(), [1.0, -0.4], atol=0.25)

    nchains, spc = 64, 400
    xs, ws = mh(lambda x, m: logp(x, m), torch.zeros(2, dtype=F64), (mu.detach(),),
                nsamples=nchains * spc, nburnout=500, step_size=0.8, nchains=nchains)
    assert xs.shape == (nchains * spc, 2) and abs(float(ws.sum()) - 1.0) < 1e-12
    chains = xs.reshape(nchains, spc, 2)
    cmeans = chains.mean(1)
    np.testing.assert_allclose(cmeans.mean(0).numpy(), [0.5, -0.2], atol=0.06)
    np.testing.assert_allclose(xs.var(0, unbiased=False).numpy(), [1.0, 1.0], atol=0.12)
    ratio = cmeans.var(0, unbiased=False) / (chains.var(1, unbiased=False).mean(0) / spc)
    assert bool((ratio < 30.0).all()), ratio
    xs2, _ = mh(lambda x, m: logp(x, m), torch.zeros(2, dtype=F64), (mu.detach(),),
                nsamples=nchains * spc, nburnout=500, step_size=0.8, nchains=nchains)
    assert torch.equal(xs, xs2)
    xs1, ws1 = mh(lambda x, m: logp(x, m), torch.zeros(2, dtype=F64), (mu.detach(),),
                  nsamples=100, nburnout=50, nchains=1)
    assert xs1.shape == (100, 2) and ws1.shape == (100,)
