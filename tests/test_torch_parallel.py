"""The port's ``parallel`` package against xitorch_tpu/parallel/sharding.py
(one-device semantics: a mesh factors the device count as the JAX package
factors it, a tensor goes on a mesh of one device, and the layout
constraint is the identity), and ``deq_forward(shard=True)`` against
``shard=False`` and against the JAX package's sharded forward.

The JAX side has the 8 virtual CPU devices of tests/conftest.py; the
port's meshes are built over lists of CPU devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.models.deq import deq_forward as jdeq_forward
from xitorch_tpu.models.deq import init_deq as jinit_deq
from xitorch_tpu.parallel import make_mesh as jmake_mesh
from xitorch_tpu.parallel.sharding import _largest_factor_leq as jlargest
import xitorch_tpu_torch as xt
from xitorch_tpu_torch.convert import deq_params_from_numpy
from xitorch_tpu_torch.models import deq_forward
from xitorch_tpu_torch.parallel import (
    P, Mesh, NamedSharding, make_mesh, shard_batch, with_batch_sharding,
)
from xitorch_tpu_torch.parallel.sharding import _largest_factor_leq

torch.set_num_threads(1)

CPU = torch.device("cpu")
DEQ_TIGHT = {"f_tol": 1e-12, "x_tol": 1e-14, "maxiter": 400}


@pytest.mark.parametrize("axes", [("dp", "tp"), ("dp",), ("a", "b", "c")])
@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_factors_as_the_reference(n, axes):
    want = jmake_mesh(n, axes, devices=jax.devices()[:n])
    got = make_mesh(n, axes, devices=[CPU] * 8)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names) == axes
    assert got.shape == dict(want.shape) and got.size == n


def test_largest_factor_matches_the_reference():
    got = [[_largest_factor_leq(n, k) for k in range(65)] for n in range(1, 65)]
    want = [[jlargest(n, k) for k in range(65)] for n in range(1, 65)]
    assert got == want


def test_make_mesh_takes_the_cards_or_raises():
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_one_device_identities():
    mesh = make_mesh(devices=[CPU])
    assert mesh.shape == {"dp": 1, "tp": 1}
    x = torch.arange(12.0).reshape(4, 3)
    y = shard_batch(mesh, x)
    assert torch.equal(y, x) and y.device == CPU
    assert with_batch_sharding(x) is x and with_batch_sharding(x, "tp") is x
    sh = NamedSharding(mesh, P("dp", None))
    assert sh.mesh is mesh and tuple(sh.spec) == ("dp", None)
    assert isinstance(Mesh(np.array([[CPU]], dtype=object), ("a", "b")).devices, np.ndarray)
    with pytest.raises(ValueError, match="no axis"):
        shard_batch(mesh, x, "sp")


@pytest.mark.parametrize("shape, axis", [((2, 1), "dp"), ((1, 2), "dp"), ((4, 2), "tp")])
def test_shard_batch_raises_on_more_than_one_device(shape, axis):
    mesh = make_mesh(shape[0] * shape[1], devices=[CPU] * 8)
    mesh = Mesh(mesh.devices.reshape(shape), ("dp", "tp"))
    with pytest.raises(RuntimeError, match="one tensor on one device"):
        shard_batch(mesh, torch.zeros(4, 3), axis)


def test_deq_forward_shard_equals_unsharded_and_the_reference():
    params_j = jinit_deq(jax.random.PRNGKey(0), d_in=4, hidden=16, d_out=2,
                         dtype=jnp.float64)
    x = np.random.default_rng(1).standard_normal((8, 4))
    with jmake_mesh(1, devices=jax.devices()[:1]):
        want = np.asarray(jdeq_forward(params_j, jnp.asarray(x), solver_kwargs=DEQ_TIGHT,
                                       shard=True))
    params = deq_params_from_numpy(params_j, device="cpu")
    with torch.no_grad():
        got = deq_forward(params, torch.tensor(x), solver_kwargs=DEQ_TIGHT, shard=True)
        assert torch.equal(got, deq_forward(params, torch.tensor(x), solver_kwargs=DEQ_TIGHT))
    assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    assert xt.parallel.with_batch_sharding is with_batch_sharding
