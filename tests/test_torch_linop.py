"""Parity of the port's LinearOperator core with xitorch_tpu at float64.

The same numpy inputs go through both packages; values must agree to
1e-10 (float64, the same arithmetic up to summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu as xj
import xitorch_tpu_torch as xt

torch.set_num_threads(1)

TOL = 1e-10  # float64; only the order of the sums differs


def _mats(seed=0, batch=(2,), n=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((*batch, n, n))
    b = rng.standard_normal((*batch, n, n))
    return a, b, rng


class _JaxScale(xj.LinearOperator):
    """Matrix-free, non-hermitian: y = s * roll(x, 1) (default rmv/rmm)."""

    def __init__(self, s):
        super().__init__(shape=(*s.shape[:-1], s.shape[-1], s.shape[-1]),
                         dtype=s.dtype)
        self.s = s

    def _getparamnames(self, prefix=""):
        return [prefix + "s"]

    def _mv(self, x):
        return self.s * jnp.roll(x, 1, axis=-1)


class _TorchScale(xt.LinearOperator):
    def __init__(self, s):
        super().__init__(shape=(*s.shape[:-1], s.shape[-1], s.shape[-1]),
                         dtype=s.dtype)
        self.s = s

    def _getparamnames(self, prefix=""):
        return [prefix + "s"]

    def _mv(self, x):
        return self.s * torch.roll(x, 1, dims=-1)


def _pair(kind, seed=0):
    a, b, rng = _mats(seed)
    if kind == "matrix":
        return xj.LinearOperator.m(jnp.asarray(a)), xt.LinearOperator.m(torch.as_tensor(a))
    if kind == "matrix_free":
        s = rng.standard_normal((2, 5))
        return _JaxScale(jnp.asarray(s)), _TorchScale(torch.as_tensor(s))
    if kind == "hermitian":
        h = a + np.swapaxes(a, -1, -2)
        return (xj.LinearOperator.m(jnp.asarray(h)),
                xt.LinearOperator.m(torch.as_tensor(h)))
    raise ValueError(kind)


def _close(jv, tv, tol=TOL):
    np.testing.assert_allclose(np.asarray(tv.detach()), np.asarray(jv), atol=tol, rtol=0)


@pytest.mark.parametrize("kind", ["matrix", "matrix_free", "hermitian"])
@pytest.mark.parametrize("method", ["mv", "mm", "rmv", "rmm", "fullmatrix"])
def test_products_match_jax(kind, method):
    Aj, At = _pair(kind)
    rng = np.random.default_rng(1)
    shapes = {"mv": (3, 2, 5), "mm": (2, 5, 4), "rmv": (2, 5), "rmm": (3, 2, 5, 2)}
    if method == "fullmatrix":
        _close(Aj.fullmatrix(), At.fullmatrix())
        return
    x = rng.standard_normal(shapes[method])
    _close(getattr(Aj, method)(jnp.asarray(x)), getattr(At, method)(torch.as_tensor(x)))


@pytest.mark.parametrize("expr", ["add", "sub", "mul", "rmul", "matmul", "H", "H_H",
                                  "mixed_add", "mixed_matmul"])
def test_operator_algebra_matches_jax(expr):
    Mj, Mt = _pair("matrix")
    Fj, Ft = _pair("matrix_free", seed=3)
    Nj, Nt = _pair("matrix", seed=5)
    build = {
        "add": lambda a, b, f: a + b,
        "sub": lambda a, b, f: a - b,
        "mul": lambda a, b, f: a * 2.5,
        "rmul": lambda a, b, f: 0.5 * a,
        "matmul": lambda a, b, f: a @ b,
        "H": lambda a, b, f: f.H,
        "H_H": lambda a, b, f: f.H.H,
        "mixed_add": lambda a, b, f: (a + f) - b,
        "mixed_matmul": lambda a, b, f: (f @ a).H * 3.0,
    }[expr]
    Rj, Rt = build(Mj, Nj, Fj), build(Mt, Nt, Ft)
    assert Rj.shape == Rt.shape and Rj.is_hermitian == Rt.is_hermitian
    x = np.random.default_rng(2).standard_normal((2, 5, 3))
    _close(Rj.mm(jnp.asarray(x)), Rt.mm(torch.as_tensor(x)))
    _close(Rj.rmm(jnp.asarray(x)), Rt.rmm(torch.as_tensor(x)))
    # the JAX side is given a batched identity: its default rmm of a
    # batched matrix-free operator fails on an unbatched input (see
    # ROADMAP.md queue 3); the port takes either
    eye = np.broadcast_to(np.eye(5), (2, 5, 5))
    _close(Rj.mm(jnp.asarray(eye)), Rt.fullmatrix())


def test_matrix_ops_fold_and_hermitian_detection():
    a, _, _ = _mats()
    h = a + np.swapaxes(a, -1, -2)
    for mat in (a, h):
        assert (xj.LinearOperator.m(jnp.asarray(mat)).is_hermitian
                == xt.LinearOperator.m(torch.as_tensor(mat)).is_hermitian)
    At = xt.LinearOperator.m(torch.as_tensor(a))
    assert isinstance(At + At, xt.MatrixLinearOperator)
    assert isinstance(At * 2.0, xt.MatrixLinearOperator)


@pytest.mark.parametrize("kind", ["matrix", "matrix_free", "hermitian"])
def test_checklinop_passes_on_both(kind):
    Aj, At = _pair(kind)
    if kind != "matrix_free":
        # the JAX checklinop trips over its own default rmv on a batched
        # matrix-free operator (ROADMAP.md queue 3)
        xj.checklinop(Aj)
    xt.checklinop(At)


def test_checklinop_rejects_non_batch_safe_operator():
    class Bad(xt.LinearOperator):
        def __init__(self, mat):
            super().__init__(shape=mat.shape, dtype=mat.dtype)
            self.mat = mat

        def _getparamnames(self, prefix=""):
            return [prefix + "mat"]

        def _mv(self, x):
            return self.mat[0] @ x  # ignores the batch: wrong shape

    with pytest.raises(AssertionError):
        xt.checklinop(Bad(torch.ones(3, 4, 4, dtype=torch.float64)))


def test_getlinopparams_names_the_tensors():
    a, b, _ = _mats()
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    A = xt.LinearOperator.m(ta)
    B = _TorchScale(torch.ones(2, 5, dtype=torch.float64))
    params = (A.H @ B + A).getlinopparams()
    assert len(params) == 2 and params[0] is ta and params[1] is B.s
    assert xt.MatrixLinearOperator(tb, False).getlinopparams()[0] is tb


def test_default_adjoint_is_differentiable():
    s = torch.tensor(np.random.default_rng(4).standard_normal((2, 5)), requires_grad=True)
    A = _TorchScale(s)
    v = torch.ones(2, 5, dtype=torch.float64)
    (g,) = torch.autograd.grad(A.rmv(v).sum(), s)
    # rmv(v)_j = s_{j+1} v_{j+1} with wrap, so d/ds of the sum is v
    np.testing.assert_allclose(g.numpy(), v.numpy())


@pytest.mark.parametrize("call", ["mv", "mm", "rmv", "rmm", "matmul", "add"])
def test_shape_errors_raise(call):
    _, At = _pair("matrix")
    other = xt.LinearOperator.m(torch.ones(4, 4, dtype=torch.float64))
    bad = torch.ones(4, 3, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        {"mv": lambda: At.mv(bad[0]), "mm": lambda: At.mm(bad),
         "rmv": lambda: At.rmv(bad[0]), "rmm": lambda: At.rmm(bad),
         "matmul": lambda: At @ other, "add": lambda: At + other}[call]()
