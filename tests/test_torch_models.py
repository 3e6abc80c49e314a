"""BASELINE config 5 and the implicit models on the port: the SCF loop
(``models.scf``: symeig nested in equilibrium), the DEQ model and the
neural ODE against the JAX package's (tests/test_scf.py,
tests/test_models_sharding.py) on the same numpy inputs, float64, with the
models' weights carried across by ``convert.deq_params_from_numpy`` /
``node_params_from_numpy``.

Tolerances: the SCF solves stop at f_tol 1e-11 on both sides, so the
densities agree far inside 1e-6 (the issue's bound), and the energy
gradients, two nested implicit adjoints solved to the same tolerances, at
rel 1e-5; the port's gradients also meet tests/test_scf.py's
central-difference check (rel 2e-4, eps 1e-5).  The DEQ and the neural ODE
run the same float64 arithmetic as JAX with tight solver tolerances:
values and gradients at rel 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.models.deq import deq_forward as jdeq_forward
from xitorch_tpu.models.deq import deq_loss as jdeq_loss
from xitorch_tpu.models.deq import init_deq as jinit_deq
from xitorch_tpu.models.node import init_node as jinit_node
from xitorch_tpu.models.node import node_loss as jnode_loss
from xitorch_tpu.models.scf import scf_density as jscf_density
from xitorch_tpu.models.scf import scf_energy as jscf_energy
from xitorch_tpu_torch.convert import deq_params_from_numpy, node_params_from_numpy
from xitorch_tpu_torch.models import (
    DEQParams, HamiltonianOp, deq_forward, deq_loss, init_deq, init_node, node_forward,
    node_loss, scf_density, scf_energy, train_step,
)
from xitorch_tpu_torch.models.scf import _density
from xitorch_tpu_torch.optimize import equilibrium

torch.set_num_threads(1)

F64 = torch.float64
RHO_TOL = 1e-6
SCF_GRAD_RTOL = 1e-5
FD_RTOL = 2e-4
MODEL_RTOL = 1e-8


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _scf_kw(eig_method):
    kw = dict(nocc=2, eig_method=eig_method, f_tol=1e-11, maxiter=2000)
    if eig_method == "davidson":
        kw["eig_options"] = {"min_eps": 1e-11, "max_niter": 4000}
    return kw


def _a(n, seed=100):
    return np.random.default_rng(seed + n).standard_normal((n, n))


@pytest.mark.parametrize("eig_method", ["exacteig", "davidson"])
@pytest.mark.parametrize("n", [8, 10])
def test_scf_density_matches_jax(eig_method, n):
    """rho* against JAX's, the fixed point itself, and sum(rho) = nocc."""
    kw = _scf_kw(eig_method)
    a = _a(n)
    rho_j = jscf_density(jnp.asarray(a), jnp.asarray(0.3), **kw)
    rho = scf_density(torch.tensor(a), torch.tensor(0.3, dtype=F64), **kw)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), rtol=0, atol=RHO_TOL)
    rho2 = _density(torch.tensor(a), 0.3, rho, 2, eig_method, **kw.get("eig_options", {}))
    np.testing.assert_allclose(rho2.numpy(), rho.numpy(), rtol=0, atol=RHO_TOL)
    assert abs(float(rho.sum()) - 2.0) < RHO_TOL


@pytest.mark.parametrize("eig_method", ["exacteig", "davidson"])
def test_scf_energy_gradients_through_both_adjoints(eig_method):
    """The gradient of the SCF energy to a and g goes through the
    equilibrium rule and symeig's rule inside it: against jax.grad of the
    JAX package, and against central differences (tests/test_scf.py)."""
    n, g0 = 8, 0.2
    kw = _scf_kw(eig_method)
    a_np = _a(n)
    a = torch.tensor(a_np, requires_grad=True)
    g = torch.tensor(g0, dtype=F64, requires_grad=True)
    e = scf_energy(a, g, **kw)
    ga, gg = torch.autograd.grad(e, (a, g))
    ej, (ja, jg) = jax.value_and_grad(lambda a, g: jscf_energy(a, g, **kw), argnums=(0, 1))(
        jnp.asarray(a_np), jnp.asarray(g0))
    assert abs(float(e.detach()) - float(ej)) < 1e-9
    assert _rel(ga, ja) <= SCF_GRAD_RTOL
    assert _rel(gg, jg) <= SCF_GRAD_RTOL

    def energy(a_, g_):
        with torch.no_grad():
            return float(scf_energy(torch.tensor(a_), torch.tensor(g_, dtype=F64), **kw))

    eps = 1e-5
    rng = np.random.default_rng(7)
    for _ in range(2):
        da = rng.standard_normal((n, n))
        da /= np.linalg.norm(da)
        fd = (energy(a_np + eps * da, g0) - energy(a_np - eps * da, g0)) / (2 * eps)
        np.testing.assert_allclose(float((ga * torch.tensor(da)).sum()), fd, rtol=FD_RTOL,
                                   atol=1e-6)
    fdg = (energy(a_np, g0 + eps) - energy(a_np, g0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(gg), fdg, rtol=FD_RTOL, atol=1e-6)


def test_scf_operator_tensors_captured_in_the_closure_get_gradients():
    """The equilibrium rule finds the Hamiltonian's tensors when the density
    map captures them instead of taking them as params (its graph walk goes
    through symeig's rule to ``a``): the same gradient either way."""
    n = 8
    a_np = _a(n)

    def grads(captured):
        a = torch.tensor(a_np, requires_grad=True)
        g = torch.tensor(0.3, dtype=F64, requires_grad=True)
        rho0 = torch.full((n,), 2.0 / n, dtype=F64)
        if captured:
            rho = equilibrium(lambda r: _density(a, g, r, 2, "exacteig"), rho0, f_tol=1e-11)
        else:
            rho = equilibrium(lambda r, a, g: _density(a, g, r, 2, "exacteig"), rho0,
                              params=(a, g), f_tol=1e-11)
        return torch.autograd.grad((rho * torch.arange(n, dtype=F64)).sum(), (a, g))

    for x, y in zip(grads(True), grads(False)):
        assert _rel(x, y) <= 1e-10 and float(y.abs().max()) > 0
    op = HamiltonianOp(torch.tensor(a_np), 0.3, torch.ones(n, dtype=F64))
    dense = (torch.tensor(a_np) + torch.tensor(a_np).T) / 2 + 0.3 * torch.eye(n, dtype=F64)
    torch.testing.assert_close(op.fullmatrix(), dense)


def _deq_case():
    params_j = jinit_deq(jax.random.PRNGKey(0), d_in=4, hidden=16, d_out=2, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    return params_j, rng.standard_normal((8, 4)), rng.standard_normal((8, 2))


DEQ_TIGHT = {"f_tol": 1e-12, "x_tol": 1e-14, "maxiter": 400}


def test_deq_matches_jax():
    """Forward, loss and every parameter's gradient against
    jax.value_and_grad, the weights carried across from JAX's init."""
    params_j, x, y = _deq_case()
    out_j = jdeq_forward(params_j, jnp.asarray(x), solver_kwargs=DEQ_TIGHT)
    loss_j, grads_j = jax.value_and_grad(jdeq_loss)(params_j, jnp.asarray(x), jnp.asarray(y),
                                                    solver_kwargs=DEQ_TIGHT)
    params = deq_params_from_numpy(params_j, device="cpu")
    assert isinstance(params, DEQParams) and params.W.dtype == F64
    out = deq_forward(params, torch.tensor(x), solver_kwargs=DEQ_TIGHT)
    assert _rel(out.detach(), out_j) <= MODEL_RTOL
    loss = deq_loss(params, torch.tensor(x), torch.tensor(y), solver_kwargs=DEQ_TIGHT)
    assert _rel(loss.detach(), loss_j) <= MODEL_RTOL
    grads = torch.autograd.grad(loss, params)
    for name, gt, gj in zip(DEQParams._fields, grads, grads_j):
        assert _rel(gt, gj) <= MODEL_RTOL, name


def test_deq_train_step_with_torch_optim():
    """train_step takes a torch.optim optimizer: Adam lowers the loss step
    by step on a fixed batch; shard=True gives shard=False's result (one
    device: the layout constraint is the identity)."""
    _, x, y = _deq_case()
    params = init_deq(torch.Generator().manual_seed(0), 4, 16, 2, F64, device="cpu")
    assert all(p.is_leaf and p.requires_grad for p in params)
    opt = torch.optim.Adam(params, lr=1e-2)
    losses = []
    for _ in range(4):
        params, loss = train_step(params, opt, torch.tensor(x), torch.tensor(y))
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    with torch.no_grad():
        sharded = deq_forward(params, torch.tensor(x), shard=True)
        assert torch.equal(sharded, deq_forward(params, torch.tensor(x)))


def test_model_inits_go_to_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_deq(torch.Generator(), 4, 16, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_node(torch.Generator(), 3, 8, 2)
    with pytest.raises(ValueError, match="fields"):
        deq_params_from_numpy({"W": np.zeros((2, 2))}, device="cpu")


@pytest.mark.parametrize("adjoint", ["autodiff", "backsolve"])
def test_node_matches_jax(adjoint):
    """node_forward/node_loss (rk45 from 0 to 1) and every parameter's
    gradient against jax.value_and_grad, by either adjoint."""
    params_j = jinit_node(jax.random.PRNGKey(3), d_in=3, hidden=8, d_out=2, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((5, 3)), rng.standard_normal((5, 2))
    loss_j, grads_j = jax.value_and_grad(jnode_loss)(params_j, jnp.asarray(x), jnp.asarray(y),
                                                     adjoint=adjoint)
    params = node_params_from_numpy(params_j, device="cpu")
    loss = node_loss(params, torch.tensor(x), torch.tensor(y), adjoint=adjoint)
    assert _rel(loss.detach(), loss_j) <= MODEL_RTOL
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for name, gt, gj in zip(params._fields, grads, grads_j):
        assert gt is not None and _rel(gt, gj) <= MODEL_RTOL, name
    assert node_forward(params, torch.tensor(x)).shape == (5, 2)
