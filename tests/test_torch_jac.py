"""The port's ``grad.jac`` / ``hess`` matrix-free operators against the JAX
package's (tests/test_jac.py) and JAX's dense Jacobians and Hessians, on
the same numpy inputs, float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu.grad import hess as jhess
from xitorch_tpu.grad import jac as jjac
from xitorch_tpu_torch.grad import hess, jac

torch.set_num_threads(1)


def jfcn(a, b):
    return jnp.tanh(a @ b + b)


def tfcn(a, b):
    return torch.tanh(a @ b + b)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(t):
    # the products carry a graph whenever gradients are enabled
    return t.detach().numpy()


@pytest.fixture
def ab():
    rng = np.random.default_rng(0)
    return rng.standard_normal((3, 3)), rng.standard_normal((3,)), rng


def test_jac_mv_rmv_match_jax(ab):
    a, b, rng = ab
    jacs = jac(tfcn, (_t(a), _t(b)))
    jjacs = jjac(jfcn, (jnp.asarray(a), jnp.asarray(b)))
    assert len(jacs) == 2 and jacs[0].shape == (3, 9) and jacs[1].shape == (3, 3)
    Ja = np.asarray(jax.jacobian(jfcn, argnums=0)(a, b)).reshape(3, -1)
    Jb = np.asarray(jax.jacobian(jfcn, argnums=1)(a, b)).reshape(3, -1)
    va, vb, vout = rng.standard_normal(9), rng.standard_normal(3), rng.standard_normal(3)
    for op, jop, J, v in ((jacs[0], jjacs[0], Ja, va), (jacs[1], jjacs[1], Jb, vb)):
        np.testing.assert_allclose(_np(op.mv(_t(v))), J @ v, rtol=1e-10)
        np.testing.assert_allclose(_np(op.mv(_t(v))), np.asarray(jop.mv(jnp.asarray(v))),
                                   rtol=1e-10)
        np.testing.assert_allclose(_np(op.rmv(_t(vout))), J.T @ vout, rtol=1e-10)
        np.testing.assert_allclose(_np(op.fullmatrix()), J, rtol=1e-10)
    # batched products, and an int idxs returns the operator itself
    vbatch = rng.standard_normal((5, 3))
    np.testing.assert_allclose(_np(jacs[1].mv(_t(vbatch))), vbatch @ Jb.T, rtol=1e-10)
    np.testing.assert_allclose(_np(jacs[1].mm(_t(vbatch.T))), Jb @ vbatch.T, rtol=1e-10)
    j0 = jac(tfcn, (_t(a), _t(b)), idxs=0)
    assert isinstance(j0, xt.LinearOperator)
    np.testing.assert_allclose(_np(j0.mv(_t(va))), Ja @ va, rtol=1e-10)
    xt.checklinop(j0)


def test_hess_matches_jax(ab):
    _, _, rng = ab
    a = rng.standard_normal((4, 4))
    a = a + a.T
    x = rng.standard_normal(4)
    v = rng.standard_normal(4)

    def jf(x, a):
        return jnp.sum(jnp.sin(x) @ a @ x + x ** 3)

    def tf(x, a):
        return (torch.sin(x) @ a @ x + x ** 3).sum()

    h = hess(tf, (_t(x), _t(a)), idxs=0)
    assert h.is_hermitian and h.shape == (4, 4)
    Hd = np.asarray(jax.hessian(jf, argnums=0)(x, a))
    np.testing.assert_allclose(_np(h.mv(_t(v))), Hd @ v, rtol=1e-10)
    hj = jhess(jf, (jnp.asarray(x), jnp.asarray(a)), idxs=0)
    np.testing.assert_allclose(_np(h.fullmatrix()), np.asarray(hj.fullmatrix()),
                               rtol=1e-10)


def test_jac_products_are_differentiable(ab):
    # the gradient of |J_b(a) v|^2 to a, through the double-VJP product,
    # against jax.grad of the dense Jacobian's
    a, b, rng = ab
    v = rng.standard_normal(3)
    gref = jax.grad(lambda a: jnp.sum((jax.jacobian(jfcn, argnums=1)(a, b) @ v) ** 2))(a)
    at = _t(a).requires_grad_()
    loss = (jac(tfcn, (at, _t(b)), idxs=1).mv(_t(v)) ** 2).sum()
    (g,) = torch.autograd.grad(loss, at)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), rtol=1e-9)
    # and the adjoint product, to second order, by torch's own checks
    vt = _t(v).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, w: jac(tfcn, (a, _t(b)), idxs=1).rmv(w), (at, vt))
    assert torch.autograd.gradgradcheck(
        lambda a, w: jac(tfcn, (a, _t(b)), idxs=1).mv(w), (at, vt))


def test_jac_declares_its_tensor_params(ab):
    a, b, _ = ab
    op = jac(lambda a, n, b: tfcn(a, b) * n, (_t(a), 2, _t(b)), idxs=2)
    assert [id(p) for p in op.getlinopparams()] == [id(op.params[0]), id(op.params[2])]
