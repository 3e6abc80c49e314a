"""The port's stateless-function surface and small utils (``Packer``,
``EditableModule``, ``make_pure``, the attribute paths, the dtype maps,
``debug``, the ``LinearOperator`` capability flags and scipy bridge)
against tests/test_core_misc.py's cases, and an ``nn.Linear`` captured in
a closure through ``rootfinder`` and ``equilibrium`` against the same
weights passed as ``params`` and against the JAX package with them as
explicit parameters (the counterpart of tests/test_wrap_module.py).

Float64 throughout.  The implicit gradients of the closure and of the
``params`` routes come from the same solves on the same tensors, so they
agree to 1e-12; JAX's run reaches the same root to f_tol 1e-12 by its own
iterations, so the roots and the gradients are held to 1e-9.
"""
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu as xj
import xitorch_tpu_torch as xt
from xitorch_tpu.optimize import equilibrium as jequilibrium
from xitorch_tpu.optimize import rootfinder as jrootfinder
from xitorch_tpu_torch import EditableModule, Packer, make_pure
from xitorch_tpu_torch.optimize import equilibrium, rootfinder
from xitorch_tpu_torch.utils import (
    create_random_ortho_matrix, create_random_square_matrix, deprecated, del_attr,
    get_and_pop_keys, get_attr, get_complex_dtype, get_np_dtype, get_real_dtype,
    get_torch_dtype, match_dim, set_attr, set_default_option,
)
from xitorch_tpu_torch.utils.tupleops import tuple_axpy1

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=requires_grad)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, want, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ------------------------- Packer -------------------------

def test_packer_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    arrs = {"a": rng.standard_normal(3), "b": (rng.standard_normal((2, 2)),
                                              rng.standard_normal(1))}
    jp = xj.Packer({"a": jnp.asarray(arrs["a"]),
                    "b": tuple(jnp.asarray(v) for v in arrs["b"])})
    obj = {"a": _t(arrs["a"]), "b": tuple(_t(v) for v in arrs["b"])}
    p = Packer(obj)
    flat = p.get_param_tensor()
    assert flat.shape == (8,)
    _close(flat, jp.get_param_tensor())
    obj2 = p.construct_from_tensor(flat * 2)
    _close(obj2["a"], arrs["a"] * 2)
    _close(obj2["b"][0], arrs["b"][0] * 2)
    assert isinstance(obj2["b"], tuple)
    obj3 = p.construct_from_tensor_list(p.get_param_tensor_list())
    assert obj3["a"] is obj["a"] and p.obj is obj
    with pytest.raises(RuntimeError):
        p.construct_from_tensor(torch.zeros(5))


def test_packer_grad():
    w = _t(np.random.default_rng(1).standard_normal((3, 3)))
    flat = Packer({"w": w}).get_param_tensor().clone().requires_grad_()
    loss = (Packer({"w": w}).construct_from_tensor(flat)["w"] ** 2).sum()
    (g,) = torch.autograd.grad(loss, flat)
    _close(g, 2 * flat.detach())


# ------------------------- EditableModule -------------------------

class Mod(EditableModule):
    def __init__(self, a, b, declare_b=True):
        self.a = a
        self.sub = {"b": b}
        self.declare_b = declare_b

    def forward(self, x):
        return self.a * x + self.sub["b"]

    def getparamnames(self, methodname, prefix=""):
        if methodname == "forward":
            return [prefix + "a"] + ([prefix + "sub[b]"] if self.declare_b else [])
        raise KeyError(methodname)


def test_editable_module_get_set():
    m = Mod(_t(2.0), _t(3.0))
    params = m.getparams("forward")
    assert len(params) == 2
    _close(params[0], 2.0)
    _close(params[1], 3.0)
    assert m.setparams("forward", _t(5.0), _t(7.0)) == 2
    _close(m.forward(_t(1.0)), 12.0)
    assert len(m.getuniqueparams("forward")) == 2
    with pytest.raises(xt.GetSetParamsError):
        m.setparams("forward", _t(5.0))


def test_editable_module_assertparams():
    x = _t(1.5)
    m = Mod(_t(2.0, True), _t(3.0, True))
    m.assertparams(m.forward, x)
    m = Mod(_t(2.0, True), _t(3.0, True), declare_b=False)
    with pytest.raises(xt.GetSetParamsError, match="missing 1"):
        m.assertparams(m.forward, x)
    # an undeclared tensor that needs no grad is not reported
    m = Mod(_t(2.0, True), _t(3.0), declare_b=False)
    m.assertparams(m.forward, x)
    # a declared non-leaf (a view of a leaf) is the tensor the method reads
    w = _t([2.0, 3.0], True)
    m2 = Mod(w[0], w[1])
    m2.assertparams(m2.forward, x)


def test_attr_utils():
    class Obj:
        pass

    o = Obj()
    o.x = [1, 2, {"k": 3}]
    o.sub = Obj()
    o.sub.y = 4
    assert get_attr(o, "x[1]") == 2
    assert get_attr(o, "x[2][k]") == 3
    assert get_attr(o, "sub.y") == 4
    set_attr(o, "x[0]", 10)
    set_attr(o, "sub.y", 5)
    assert o.x[0] == 10 and o.sub.y == 5
    del_attr(o, "sub.y")
    assert not hasattr(o.sub, "y")


# ------------------------- make_pure -------------------------

def test_make_pure_hoists_only_tensors_that_require_grad():
    x = _t([0.5, -1.0])
    w = _t([2.0, 3.0])

    def f(x):
        return torch.sin(w * x).sum()

    pure, consts = make_pure(f, x)
    assert len(consts) == 0
    _close(pure(x), f(x))

    wg = _t([2.0, 3.0], True)

    def g(x):
        return torch.sin(wg * x).sum()

    pure, consts = make_pure(g, x)
    assert len(consts) == 1 and consts[0] is wg
    _close(pure(x, *consts), g(x))
    # the tensor passed takes the captured one's place, gradients reach it
    w2 = _t([1.0, -4.0], True)
    out = pure(x, w2)
    _close(out, torch.sin(w2 * x).sum())
    (gw,) = torch.autograd.grad(out, w2)
    _close(gw, torch.cos(w2 * x).detach() * x)
    assert xt.get_pure_function is make_pure
    assert xt.make_sibling(pure)(g) is g


def test_make_pure_on_a_module_method():
    lin = torch.nn.Linear(3, 2).double()
    x = _t(np.random.default_rng(2).standard_normal(3))
    pure, consts = make_pure(lin, x)
    assert len(consts) == 2 and consts[0] is lin.weight and consts[1] is lin.bias
    W2, b2 = (c.detach() * 2 for c in consts)
    _close(pure(x, W2, b2), torch.nn.functional.linear(x, W2, b2))


# ------------------------- nn.Module in a closure -------------------------

def _cell_weights():
    rng = np.random.default_rng(3)
    return rng.standard_normal((3, 3)) * 0.5, rng.standard_normal(3) * 0.5


@pytest.mark.parametrize("solver", ["rootfinder", "equilibrium"])
def test_module_in_a_closure_gets_the_params_gradients_and_jaxs(solver):
    W, b = _cell_weights()
    z0 = np.zeros(3)
    opts = {"f_tol": 1e-12, "maxiter": 2000}
    if solver == "rootfinder":
        tsolve, jsolve = rootfinder, jrootfinder

        def tcell(z, lin):
            return torch.tanh(lin(z) + 0.5) - z

        def tcell_p(z, W, b):
            return torch.tanh(z @ W.T + b + 0.5) - z

        def jcell(z, W, b):
            return jnp.tanh(W @ z + b + 0.5) - z
    else:
        tsolve, jsolve = equilibrium, jequilibrium

        def tcell(z, lin):
            return torch.tanh(0.5 * lin(z) + 0.3)

        def tcell_p(z, W, b):
            return torch.tanh(0.5 * (z @ W.T + b) + 0.3)

        def jcell(z, W, b):
            return jnp.tanh(0.5 * (W @ z + b) + 0.3)

    lin = torch.nn.Linear(3, 3).double()
    with torch.no_grad():
        lin.weight.copy_(_t(W))
        lin.bias.copy_(_t(b))
    zc = tsolve(lambda z: tcell(z, lin), _t(z0), **opts)
    lc = (zc ** 2).sum()
    gc = torch.autograd.grad(lc, (lin.weight, lin.bias))

    Wt, bt = _t(W, True), _t(b, True)
    zp = tsolve(tcell_p, _t(z0), params=(Wt, bt), **opts)
    lp = (zp ** 2).sum()
    gp = torch.autograd.grad(lp, (Wt, bt))

    import jax

    def jloss(W, b):
        return jnp.sum(jsolve(jcell, jnp.asarray(z0), params=(W, b), **opts) ** 2)

    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(W), jnp.asarray(b))
    _close(lc, lp)
    _close(lc, lj, rtol=1e-9)
    for a, p_, j in zip(gc, gp, gj):
        _close(a, p_)
        _close(a, j, rtol=1e-9, atol=1e-12)
    assert float(sum(g.abs().sum() for g in gc)) > 1e-6


# ------------------------- debug -------------------------

def test_debug_cli(tmp_path):
    script = tmp_path / "s.py"
    script.write_text(
        "from xitorch_tpu_torch.debug import is_debug_enabled\n"
        "print('DEBUG_IS', is_debug_enabled())\n")
    out = subprocess.run(
        [sys.executable, "-m", "xitorch_tpu_torch.debug", str(script)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert "DEBUG_IS True" in out.stdout, out.stderr


def test_profile_and_annotate(tmp_path):
    with xt.debug.profile(str(tmp_path)):
        with xt.debug.annotate("region"):
            (torch.ones(8, 8) * 2.0).sum()
    trace = tmp_path / "trace.json"
    assert trace.exists() and "region" in trace.read_text()


# ------------------------- utils -------------------------

def test_bcast_match_dim():
    a, b = match_dim(torch.zeros((2, 5)), torch.zeros((7,)))
    assert a.shape == (2, 5) and b.shape == (2, 7)
    a, b = match_dim(torch.zeros((3, 1, 4)), torch.zeros((2, 6)))
    assert a.shape == (3, 2, 4) and b.shape == (3, 2, 6)


def test_dtype_maps():
    assert get_np_dtype(torch.float32) == np.float32
    assert get_np_dtype(torch.bfloat16) == np.float32
    assert get_torch_dtype("float64") == torch.float64
    assert get_torch_dtype("torch.float32") == torch.float32
    assert get_torch_dtype(np.complex64) == torch.complex64
    assert get_torch_dtype(jnp.float32) == torch.float32
    assert get_complex_dtype(torch.float32) == torch.complex64
    assert get_complex_dtype("float64") == torch.complex128
    assert get_real_dtype(torch.complex64) == torch.float32
    assert get_real_dtype(torch.float64) == torch.float64


def test_options_and_decorators():
    assert set_default_option({"a": 1, "b": 2}, {"b": 3}) == {"a": 1, "b": 3}
    d = {"a": 1, "b": 2, "c": 3}
    assert get_and_pop_keys(d, ["a", "c"]) == {"a": 1, "c": 3} and d == {"b": 2}

    @deprecated("2026-01-01")
    def f():
        return 7

    with pytest.warns(DeprecationWarning, match="since 2026-01-01"):
        assert f() == 7

    @deprecated("2026-01-01")
    class C:
        def __init__(self, v):
            self.v = v

    with pytest.warns(DeprecationWarning):
        assert C(3).v == 3


def test_tuple_axpy1():
    x = (_t([1.0, 2.0]), {"k": _t(3.0)})
    y = (_t([0.5, 0.5]), {"k": _t(1.0)})
    out = tuple_axpy1(2.0, x, y)
    _close(out[0], [2.5, 4.5])
    _close(out[1]["k"], 7.0)
    out = tuple_axpy1((_t(1.0), {"k": _t(-1.0)}), x, y)
    _close(out[0], [1.5, 2.5])
    _close(out[1]["k"], -2.0)


@pytest.mark.parametrize("is_hermitian", [True, False])
def test_random_matrices_match_jax(is_hermitian):
    from xitorch_tpu.utils import create_random_ortho_matrix as jortho
    from xitorch_tpu.utils import create_random_square_matrix as jsquare

    kw = dict(is_hermitian=is_hermitian, min_eival=-1.0, max_eival=2.0, minabs_eival=0.1,
              seed=4)
    _close(create_random_square_matrix(6, device="cpu", **kw), jsquare(6, **kw))
    if not torch.cuda.is_available():  # no device named: the card, or raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_random_square_matrix(3)
    q = create_random_ortho_matrix(5, seed=4, dtype=torch.float32, device="cpu")
    assert q.dtype == torch.float32
    _close(q, jortho(5, seed=4), rtol=1e-6, atol=1e-6)


def test_utils_export_the_references_names():
    import xitorch_tpu.utils as ju
    import xitorch_tpu_torch.utils as tu

    want = {n for n in dir(ju) if not n.startswith("_") and callable(getattr(ju, n))}
    want = {"get_torch_dtype" if n == "get_jax_dtype" else n for n in want}
    missing = {n for n in want if not hasattr(tu, n)}
    assert not missing, missing


# ------------------------- LinearOperator gaps -------------------------

def test_linop_capability_flags_and_scipy_bridge():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 3))
    A = xt.LinearOperator.m(_t(a))
    assert A.is_mv_implemented and A.is_getparamnames_implemented
    jop = xj.LinearOperator.m(jnp.asarray(a)).scipy_linalg_op()
    op = A.scipy_linalg_op()
    assert op.shape == (4, 3) and op.dtype == np.float64
    v, u = rng.standard_normal(3), rng.standard_normal(4)
    m, mu = rng.standard_normal((3, 2)), rng.standard_normal((4, 2))
    _close(op.matvec(v), jop.matvec(v))
    _close(op.rmatvec(u), jop.rmatvec(u))
    _close(op.matmat(m), jop.matmat(m))
    _close(op.rmatmat(mu), a.T @ mu)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert isinstance(op.matvec(v), np.ndarray)
