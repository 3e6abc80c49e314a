"""The port's ``serving`` (``torch.export`` programs) against
xitorch_tpu/serving.py (``jax.export``) and against the JAX package's own
solves, on the same numpy inputs, and the seven kernel operators under
``torch.library.opcheck`` on their plain CPU implementations.

Routes that export: exactsolve and kron_direct (float64, held to 1e-10
against the JAX package's served program and to 1e-8 against its solve),
structured_cg and the Thomas route (``V = None``), float32 only in both
packages (float64 goes to cg there): served equal to eager, and within 1e-5
of the JAX package's float32 kernel solve (both stop at rtol 1e-6).  cg
reads its stop flag on the host each step and raises the named error."""
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu as xj
import xitorch_tpu.serving as jserving
import xitorch_tpu_torch as xt
import xitorch_tpu_torch.serving as serving
from xitorch_tpu_torch.ops import spectral_dc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = torch.ops.xitorch_tpu_torch


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _kron_case(seed=0):
    """tests/test_core_misc.py::test_serving_export_kron_direct's inputs."""
    rng = np.random.default_rng(seed)
    a1 = rng.standard_normal((5, 5))
    a2 = rng.standard_normal((4, 4))
    return (a1 @ a1.T + 5 * np.eye(5), a2 @ a2.T + 4 * np.eye(4),
            rng.standard_normal((20, 2)))


def _kron_fn(pkg):
    def fn(A1, A2, b):
        return pkg.linalg.solve(pkg.KronSumOperator(A1, A2, is_hermitian=True), b,
                                method="kron_direct")
    return fn


def test_kron_direct_served_matches_the_reference():
    args = _kron_case()
    jblob = jserving.export_bytes(_kron_fn(xj), tuple(map(jnp.asarray, args)))
    want = np.asarray(jserving.import_bytes(jblob)(*map(jnp.asarray, args)))
    targs = tuple(map(torch.tensor, args))
    blob = serving.export_bytes(_kron_fn(xt), targs)
    assert isinstance(blob, bytes) and len(blob) > 100
    got = _np(serving.import_bytes(blob)(*targs))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    dense = _np(xt.KronSumOperator(*targs[:2], is_hermitian=True).fullmatrix())
    np.testing.assert_allclose(dense @ got, args[2], rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(serving.aot_compile(_kron_fn(xt), targs)(*targs)), got,
                               rtol=0, atol=1e-12)


def _dense_case(seed=1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((6, 6))
    return a @ a.T + 6 * np.eye(6), rng.standard_normal((6, 2))


def _exact_fn(pkg, **kw):
    def fn(mat, b):
        return pkg.linalg.solve(pkg.LinearOperator.m(mat, is_hermitian=True), b,
                                method="exactsolve", **kw)
    return fn


def test_exactsolve_served_matches_the_reference():
    mat, b = _dense_case()
    want = np.asarray(_exact_fn(xj)(jnp.asarray(mat), jnp.asarray(b)))
    targs = (torch.tensor(mat), torch.tensor(b))
    for served in (serving.import_bytes(serving.export_bytes(_exact_fn(xt), targs)),
                   serving.aot_compile(_exact_fn(xt), targs)):
        np.testing.assert_allclose(_np(served(*targs)), want, rtol=0, atol=1e-8)
        np.testing.assert_allclose(_np(served(*targs)), np.linalg.solve(mat, b), rtol=1e-10)


def test_return_info_is_an_output_of_the_program():
    """The eager checks are skipped while tracing (no warning, no host read);
    ``converged`` is still returned, computed by the program."""
    mat, b = _dense_case()
    targs = (torch.tensor(mat), torch.tensor(b))
    fn = _exact_fn(xt, return_info=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        served = serving.import_bytes(serving.export_bytes(fn, targs))
    x, info = served(*targs)
    x0, info0 = fn(*targs)
    assert torch.equal(x, x0) and set(info) == set(info0)
    assert float(info["converged"]) == float(info0["converged"]) == 1.0


K, N, RANK = 4, 64, 2


def _structured_case(seed=2):
    rng = np.random.default_rng(seed)
    d = 4.0 + 2.0 * rng.uniform(size=(K, N))
    c = np.asarray(1.0)
    V = rng.standard_normal((K, N, RANK)) / np.sqrt(N)
    b = rng.standard_normal((K, N, 1))
    return [a.astype(np.float32) for a in (d, c, V, b)]


def _structured_fn(pkg, tridiag_only=False, **kw):
    def fn(d, c, V, b):
        A = pkg.TridiagLowRankOperator(d, c) if tridiag_only \
            else pkg.TridiagLowRankOperator(d, c, V)
        return pkg.linalg.solve(A, b, method="structured_cg", rtol=1e-6, atol=1e-8, **kw)
    return fn


@pytest.mark.parametrize("tridiag_only", [False, True], ids=["structured_cg", "thomas"])
def test_structured_routes_served_match_eager_and_the_reference(tridiag_only):
    args = _structured_case()
    want = np.asarray(_structured_fn(xj, tridiag_only, interpret=True)(
        *map(jnp.asarray, args)), np.float64)
    targs = tuple(map(torch.tensor, args))
    eager = _np(_structured_fn(xt, tridiag_only)(*targs))
    fn = _structured_fn(xt, tridiag_only)
    for served in (serving.import_bytes(serving.export_bytes(fn, targs)),
                   serving.aot_compile(fn, targs)):
        got = _np(served(*targs))
        assert np.array_equal(got, eager)
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    ep = serving.aot_compile(fn, targs).exported
    op = "thomas" if tridiag_only else "structured_cg"
    assert any("xitorch_tpu_torch.%s" % op in str(node.target) for node in ep.graph.nodes)


def test_float64_structured_goes_to_cg_and_raises_the_named_error():
    targs = tuple(torch.tensor(a, dtype=torch.float64) for a in _structured_case())
    with pytest.raises(RuntimeError, match=r"^serving: cg \(xitorch_tpu_torch"):
        serving.export_bytes(_structured_fn(xt), targs)


def test_cg_raises_the_named_error():
    mat, b = _dense_case()

    def fn(mat, b):
        return xt.linalg.solve(xt.LinearOperator.m(mat, is_hermitian=True), b, method="cg",
                               rtol=1e-10, atol=1e-12)

    targs = (torch.tensor(mat), torch.tensor(b))
    for entry in (serving.export_bytes, serving.aot_compile):
        with pytest.raises(RuntimeError, match="cg .* reads its stop flag on the host"):
            entry(fn, targs)


def test_any_tracer_error_of_a_host_loop_names_it(monkeypatch):
    """The first construct of a loop that a tracer refuses depends on torch's
    version (a generator argument in cg's set-up before the stop flag on
    some): each is reported as the named error, with the tracer's error as
    its cause; an error outside the package's methods passes unchanged."""
    from xitorch_tpu_torch._impls.linalg import solve as impls

    def refused(*args, **kw):
        raise RuntimeError("argument of type: <class 'torch._C.Generator'>")

    monkeypatch.setattr(impls, "_probe_vector", refused)
    mat, b = _dense_case()
    targs = (torch.tensor(mat), torch.tensor(b))

    def cg_fn(mat, b):
        return xt.linalg.solve(xt.LinearOperator.m(mat, is_hermitian=True), b, method="cg")

    with pytest.raises(RuntimeError, match=r"^serving: cg \(xitorch_tpu_torch.*stop flag") as err:
        serving.export_bytes(cg_fn, targs)
    assert "Generator" in str(err.value.__cause__)

    def bad(mat, b):
        raise ValueError("not a host loop")

    with pytest.raises(ValueError, match="not a host loop"):
        serving.aot_compile(bad, targs)


def test_blob_served_in_a_fresh_process(tmp_path):
    """A process that imports only the port loads and serves the blob."""
    args = _structured_case(seed=5)
    targs = tuple(map(torch.tensor, args))
    fn = _structured_fn(xt)
    (tmp_path / "prog.pt2").write_bytes(serving.export_bytes(fn, targs))
    np.savez(tmp_path / "args.npz", *args)
    code = (
        "import sys, numpy as np, torch\n"
        "import xitorch_tpu_torch.serving as s\n"
        "d = np.load(sys.argv[2])\n"
        "f = s.import_bytes(open(sys.argv[1], 'rb').read())\n"
        "x = f(*(torch.tensor(d['arr_%d' % i]) for i in range(4)))\n"
        "np.save(sys.argv[3], x.numpy())\n"
        "print(any(m.split('.')[0] in ('jax', 'jaxlib', 'xitorch_tpu') for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "prog.pt2"),
                          str(tmp_path / "args.npz"), str(tmp_path / "x.npy")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"
    assert np.array_equal(np.load(tmp_path / "x.npy"), _np(fn(*targs)))


def _op_cases():
    g = torch.Generator().manual_seed(0)
    K, n = 3, 16
    dl, d, du, b = (torch.randn(K, n, generator=g) for _ in range(4))
    d = d.abs() + 4.0
    bl, bu = torch.randn(K, 1, n, generator=g), torch.randn(K, 1, n, generator=g)
    bl[..., :1] = 0.0
    bu[..., -1:] = 0.0
    V = torch.randn(K, 2, n, generator=g) / 4
    a = torch.randn(2, 16, 16, generator=g)
    a = a @ a.mT + 2.0 * torch.eye(16)
    om = spectral_dc.as_probe(None, 16, torch.float32, "cpu")
    seg = torch.zeros(2, 16, 1, dtype=torch.int32)
    return {
        "thomas": (dl, d, du, b, 1e-30),
        "structured_cg": (d, bl, bu, V, b, [1], 1e-6, 1e-8, 40, 1e-30),
        "jacobi_sweep": (a, 18, 1e-5),
        "jacobi_sweep_complex": (torch.cat([a, 0.1 * a], -1), 18, 1e-5),
        "dc_precondition": (a, om, 2, 2, True, True, 1),
        "dc_level": (seg, 0.5 * (a + a.mT), a, om, 2),
        "fused_cg": (a, torch.tensor([1, 0, 1]), torch.randn(3, 16, 2, generator=g),
                     1e-6, 1e-8, 40, 1e-12),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_kernel_operators_pass_opcheck_on_the_cpu(name):
    result = torch.library.opcheck(getattr(OPS, name), _op_cases()[name])
    assert set(result.values()) == {"SUCCESS"}, result


def test_dc_operator_gives_empty_outputs_not_asked_for():
    a, om = _op_cases()["dc_precondition"][:2]
    g, t, seg = OPS.dc_precondition(a, om, 2, 2, False, False, 0)
    assert g.shape == a.shape and t.numel() == 0 and seg.numel() == 0
    assert seg.dtype == torch.int32
    torch.library.opcheck(OPS.dc_precondition, (a, om, 2, 2, False, False, 0))

