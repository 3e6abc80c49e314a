"""The port's slices end to end at a small size: BASELINE config 3 (below),
BASELINE config 2 (batched dense symeig and svd, forward and gradient) and,
at the end of the file, config 2 through the warm start and with complex
input.

A batch of TridiagLowRankOperator systems (diag + tridiagonal coupling +
rank-4), float32, solved by ``linalg.solve(method="structured_cg")``; the
forward solution and the gradients to d, c, V and b are held against
xitorch_tpu's (its Pallas kernel in interpret mode) on the same numpy
inputs.  On the CPU no CUDA kernel may launch.
"""
import ast
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu as xj
import xitorch_tpu_torch as xt
from xitorch_tpu.linalg import solve as jsolve
from xitorch_tpu_torch.linalg import solve as tsolve
from xitorch_tpu_torch.ops import jacobi_eigh as jmod
from xitorch_tpu_torch.ops import jacobi_sweep_cuda, structured_cg_cuda, thomas_cuda
from xitorch_tpu_torch.ops.dc_kernel import dc_precondition_cuda

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N, RANK = 4, 64, 4
RTOL, ATOL = 1e-6, 1e-8
# f32 solves stopped at rtol/2 on both sides (per system here, per tile
# there); gradients are products of two such solves
TOL = 1e-3


def _config3(seed=0):
    """bench.py's config-3 recipe at a small size, drawn with numpy."""
    rng = np.random.default_rng(seed)
    d = 4.0 + 2.0 * rng.uniform(size=(BATCH, N))
    c = np.asarray(1.0)
    V = rng.standard_normal((BATCH, N, RANK)) / np.sqrt(N)
    b = rng.standard_normal((BATCH, N, 1))
    w = rng.standard_normal((BATCH, N, 1))
    return [a.astype(np.float32) for a in (d, c, V, b, w)]


def _rel(t, j):
    j = np.asarray(j, dtype=np.float64)
    return float(np.linalg.norm(t.detach().numpy() - j) / np.linalg.norm(j))


def test_forward_matches_jax():
    d, c, V, b, _ = _config3()
    Aj = xj.TridiagLowRankOperator(*map(jnp.asarray, (d, c, V)))
    At = xt.TridiagLowRankOperator(*map(torch.as_tensor, (d, c, V)))
    xjv, ij = jsolve(Aj, jnp.asarray(b), method="structured_cg", rtol=RTOL, atol=ATOL,
                     interpret=True, return_info=True)
    xtv, it = tsolve(At, torch.as_tensor(b), method="structured_cg", rtol=RTOL,
                     atol=ATOL, return_info=True)
    assert xtv.shape == (BATCH, N, 1) and xtv.dtype == torch.float32
    assert _rel(xtv, xjv) <= TOL
    assert float(it["converged"]) == float(ij["converged"]) == 1.0
    resid = torch.linalg.norm(At.mm(xtv) - torch.as_tensor(b), dim=-2).max()
    assert float(resid) < 5e-4  # bench.py's residual gate


def test_gradients_match_jax():
    d, c, V, b, w = _config3(seed=1)

    def fj(d, c, V, b):
        A = xj.TridiagLowRankOperator(d, c, V)
        x = jsolve(A, b, method="structured_cg", rtol=RTOL, atol=ATOL, interpret=True,
                   bck_options={"method": "structured_cg", "interpret": True})
        return jnp.sum(x * w)

    gj = jax.grad(fj, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (d, c, V, b)))
    ts = [torch.tensor(a, requires_grad=True) for a in (d, c, V, b)]
    x = tsolve(xt.TridiagLowRankOperator(*ts[:3]), ts[3], method="structured_cg",
               rtol=RTOL, atol=ATOL)
    gt = torch.autograd.grad((x * torch.as_tensor(w)).sum(), ts)
    for name, a, t in zip("dcVb", gj, gt):
        assert t.shape == a.shape, name
        assert _rel(t, a) <= TOL, name


def test_default_method_and_pure_tridiag_match_jax():
    d, c, V, b, _ = _config3(seed=2)
    for vv in (V, None):
        args = (d, c) if vv is None else (d, c, vv)
        Aj = xj.TridiagLowRankOperator(*map(jnp.asarray, args))
        At = xt.TridiagLowRankOperator(*map(torch.as_tensor, args))
        xjv = jsolve(Aj, jnp.asarray(b), method="structured_cg", interpret=True)
        xtv = tsolve(At, torch.as_tensor(b))  # default routing
        assert _rel(xtv, xjv) <= TOL


def test_cpu_run_launches_no_kernel():
    structured_cg_cuda.launches = thomas_cuda.launches = 0
    d, c, V, b, w = _config3(seed=3)
    ts = [torch.tensor(a, requires_grad=True) for a in (d, c, V, b)]
    x = tsolve(xt.TridiagLowRankOperator(*ts[:3]), ts[3], method="structured_cg")
    (x * torch.as_tensor(w)).sum().backward()
    tsolve(xt.TridiagLowRankOperator(ts[0], ts[1]), ts[3], method="structured_cg")
    assert structured_cg_cuda.launches == 0 and thomas_cuda.launches == 0


def test_port_imports_no_jax():
    code = ("import sys; import xitorch_tpu_torch, xitorch_tpu_torch.convert, "
            "xitorch_tpu_torch.ops.jacobi_eigh, xitorch_tpu_torch.linalg.symeig, "
            "xitorch_tpu_torch.ops.dc_kernel, xitorch_tpu_torch.ops.spectral_dc, "
            "xitorch_tpu_torch.ops.dc_level, xitorch_tpu_torch.optimize, "
            "xitorch_tpu_torch.grad, xitorch_tpu_torch._impls.optimize.rootsolver, "
            "xitorch_tpu_torch._impls.optimize.equilibrium, "
            "xitorch_tpu_torch._impls.optimize.minimizer, "
            "xitorch_tpu_torch.utils.assertfuncs, xitorch_tpu_torch._docstr, "
            "xitorch_tpu_torch.integrate, xitorch_tpu_torch.integrate._adjoint, "
            "xitorch_tpu_torch._impls.integrate.adaptive_rk, "
            "xitorch_tpu_torch._impls.integrate.explicit_rk, "
            "xitorch_tpu_torch._impls.integrate.implicit_rk, "
            "xitorch_tpu_torch._impls.integrate.fixed_quad, "
            "xitorch_tpu_torch._impls.integrate.mcmc, xitorch_tpu_torch.models, "
            "xitorch_tpu_torch.models.scf, xitorch_tpu_torch.models.deq, "
            "xitorch_tpu_torch.models.node, xitorch_tpu_torch.utils.pytree, "
            "xitorch_tpu_torch.interpolate, xitorch_tpu_torch.interpolate.interp1, "
            "xitorch_tpu_torch._impls.interpolate.interp_1d, "
            "xitorch_tpu_torch.integrate.squad, "
            "xitorch_tpu_torch._impls.integrate.samples_quad, "
            "xitorch_tpu_torch._core.editable_module, xitorch_tpu_torch._core.packer, "
            "xitorch_tpu_torch._core.pure, xitorch_tpu_torch.utils.types, "
            "xitorch_tpu_torch.utils.attr, xitorch_tpu_torch.utils.decorators, "
            "xitorch_tpu_torch.utils.tupleops, xitorch_tpu_torch.debug.profiling, "
            "xitorch_tpu_torch.debug.__main__; "
            "print(any(m.split('.')[0] in ('jax', 'jaxlib', 'xitorch_tpu') "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300, check=True)
    assert out.stdout.strip() == "False"


def _lint_files():
    pkg = os.path.join(ROOT, "xitorch_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(pkg):
        files += [os.path.join(base, f) for f in sorted(names) if f.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _lint_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_passes_the_lint_gate(path):
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_lint", os.path.join(ROOT, "tools", "lint.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    assert lint.check_file(Path(path)) == []


@pytest.mark.parametrize("path", _lint_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_names_no_jax_import(path):
    """No file of the port (nor chip_smoke.py) imports jax or the JAX
    package, at top level or inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "xitorch_tpu"}


# ------------------------------------------------------------------
# BASELINE config 2 at a small size: B = 3, n = 32, neig = 4, float32
# ------------------------------------------------------------------

B2, N2, NEIG = 3, 32, 4


def _config2(seed=0):
    """benchmarks/bench_symeig.py's recipes at a small size, with numpy: an
    SPD batch for symeig and a general batch for svd."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B2, N2, N2)) / np.sqrt(N2)
    mats = a @ a.transpose(0, 2, 1) + 2.0 * np.eye(N2)
    gmats = rng.standard_normal((B2, N2, N2)) / np.sqrt(N2)
    return mats.astype(np.float32), gmats.astype(np.float32)


@pytest.mark.parametrize("method, opts", [
    ("exacteig", {}),
    ("chebfsi", {"min_eps": 1e-4, "max_niter": 40, "nguess": 12, "v_init": "eye"}),
    ("davidson", {"min_eps": 1e-4, "max_niter": 800, "v_init": "eye"}),
])
def test_config2_forward_matches_jax(method, opts):
    mats, _ = _config2()
    Aj = xj.LinearOperator.m(jnp.asarray(mats), is_hermitian=True)
    At = xt.LinearOperator.m(torch.as_tensor(mats), is_hermitian=True)
    ej, vj, ij = xj.linalg.symeig(Aj, NEIG, "lowest", method=method, return_info=True,
                                  **opts)
    et, vt, it = xt.linalg.symeig(At, NEIG, "lowest", method=method, return_info=True,
                                  **opts)
    assert et.shape == (B2, NEIG) and vt.shape == (B2, N2, NEIG)
    assert et.dtype == vt.dtype == torch.float32
    assert float(it["converged"]) == float(ij["converged"]) == 1.0
    e0 = np.linalg.eigvalsh(mats.astype(np.float64))
    scale = e0.max()
    # float32 values under the gate of the reference's tests (2e-5 of the
    # spectral scale); eigenvalue error is quadratic in the 1e-4 residual
    assert np.abs(et.numpy() - np.asarray(ej)).max() <= 2e-5 * scale
    assert np.abs(et.numpy() - e0[:, :NEIG]).max() <= 2e-5 * scale
    # the same subspace (gaps of this spectrum are >= 0.03; float32 vectors)
    pj = np.asarray(vj) @ np.asarray(vj).transpose(0, 2, 1)
    pt = (vt @ vt.mT).numpy()
    assert np.abs(pt - pj).max() <= 5e-3
    resid = At.mm(vt) - vt * et[..., None, :]
    assert float(resid.abs().max()) <= 2e-4


def test_config2_svd_matches_jax():
    _, gmats = _config2(seed=1)
    for method in (None, "exacteig"):
        uj, sj, vhj = xj.linalg.svd(xj.LinearOperator.m(jnp.asarray(gmats)), NEIG,
                                    method=method)
        u, s, vh = xt.linalg.svd(xt.LinearOperator.m(torch.as_tensor(gmats)), NEIG,
                                 method=method)
        assert u.shape == (B2, N2, NEIG) and s.shape == (B2, NEIG)
        assert vh.shape == (B2, NEIG, N2)
        s0 = np.linalg.svd(gmats.astype(np.float64), compute_uv=False)[:, :NEIG][:, ::-1]
        # float32 singular values, relative to the largest (bench_symeig.py
        # gates at 5e-3; a direct decomposition does far better)
        assert np.abs(s.numpy() - np.asarray(sj)).max() <= 1e-5 * s0.max()
        assert np.abs(s.numpy() - s0).max() <= 1e-5 * s0.max()
        rec = (u * s[..., None, :]) @ vh
        recj = (np.asarray(uj) * np.asarray(sj)[..., None, :]) @ np.asarray(vhj)
        assert np.abs(rec.numpy() - recj).max() <= 1e-4


@pytest.mark.parametrize("method, opts", [
    ("exacteig", {}),
    ("chebfsi", {"min_eps": 1e-5, "max_niter": 60, "nguess": 12, "v_init": "eye"}),
])
def test_config2_gradient_matches_jax(method, opts):
    # gap-controlled spectrum, as benchmarks/bench_backward.py: the lowest
    # NEIG gaps of 0.2 keep the implicit gradient float32-resolvable
    rng = np.random.default_rng(2)
    lam = np.concatenate([np.linspace(0.2, 0.8, NEIG), np.linspace(2.0, 6.0, N2 - NEIG)])
    q = np.linalg.qr(rng.standard_normal((B2, N2, N2)))[0]
    a = ((q * lam) @ q.transpose(0, 2, 1)).astype(np.float32)
    we = rng.standard_normal((B2, NEIG)).astype(np.float32)
    wp = rng.standard_normal((B2, N2, N2)).astype(np.float32)

    def fj(x):
        A = xj.LinearOperator.m((x + jnp.swapaxes(x, -2, -1)) / 2, is_hermitian=True)
        e, X = xj.linalg.symeig(A, NEIG, "lowest", method=method, **opts)
        return jnp.sum(e * we) + jnp.sum((X @ jnp.swapaxes(X, -2, -1)) * wp)

    gj = np.asarray(jax.grad(fj)(jnp.asarray(a)))
    x = torch.tensor(a, requires_grad=True)
    A = xt.LinearOperator.m((x + x.mT) / 2, is_hermitian=True)
    e, X = xt.linalg.symeig(A, NEIG, "lowest", method=method, **opts)
    loss = (e * torch.as_tensor(we)).sum() + ((X @ X.mT) * torch.as_tensor(wp)).sum()
    (gt,) = torch.autograd.grad(loss, x)
    assert gt.shape == x.shape and bool(torch.isfinite(gt).all())
    # float32 eigenvectors at gaps of 0.2 (and, for chebfsi, a 1e-5 residual
    # and an adjoint CG stopped at rtol 1e-6) on both sides
    assert _rel(gt, gj) <= TOL


def test_config2_cpu_run_launches_no_kernel():
    jacobi_sweep_cuda.launches = 0
    mats, gmats = _config2(seed=3)
    x = torch.tensor(mats, requires_grad=True)
    A = xt.LinearOperator.m((x + x.mT) / 2, is_hermitian=True)
    e, X = xt.linalg.symeig(A, NEIG, "lowest", method="exacteig")
    (e.sum() + (X @ X.mT).sum()).backward()
    xt.linalg.svd(xt.LinearOperator.m(torch.as_tensor(gmats)), NEIG)
    assert jacobi_sweep_cuda.launches == 0


# ------------------------------------------------------------------
# config 2 through the warm start and with complex input.  On the CPU the
# dense route is torch.linalg.eigh; these tests send it through the port's
# own jacobi_eigh (plain sweep, plain DC) as the card does, by approving CPU
# tensors at the dispatch gate.
# ------------------------------------------------------------------

@pytest.fixture
def through_jacobi(monkeypatch):
    # "kw": keyword arguments the dense route's jacobi_eigh call is given on
    # top of its own (exacteig has no options, so the warm start is forced here)
    calls = {"n": 0, "kw": {}}
    real = jmod.jacobi_eigh

    def counted(A, **kw):
        calls["n"] += 1
        return real(A, **{**calls["kw"], **kw})

    monkeypatch.setattr(jmod, "use_jacobi_for", lambda A: True)
    monkeypatch.setattr(jmod, "use_jacobi_svd_for", lambda A: True)
    monkeypatch.setattr(jmod, "jacobi_eigh", counted)
    return calls


def test_slice_warm_exacteig_matches_jax(through_jacobi):
    through_jacobi["kw"] = {"precondition": True}
    jacobi_sweep_cuda.launches = dc_precondition_cuda.launches = 0
    mats, _ = _config2(seed=4)
    ej, vj = xj.linalg.symeig(xj.LinearOperator.m(jnp.asarray(mats), is_hermitian=True),
                              NEIG, "lowest", method="exacteig")
    At = xt.LinearOperator.m(torch.as_tensor(mats), is_hermitian=True)
    et, vt, info = xt.linalg.symeig(At, NEIG, "lowest", method="exacteig",
                                    return_info=True)
    assert through_jacobi["n"] == 1 and float(info["converged"]) == 1.0
    e0 = np.linalg.eigvalsh(mats.astype(np.float64))
    # float32 values under 2e-5 of the spectral scale, as for the cold route
    assert np.abs(et.numpy() - np.asarray(ej)).max() <= 2e-5 * e0.max()
    assert np.abs(et.numpy() - e0[:, :NEIG]).max() <= 2e-5 * e0.max()
    pj = np.asarray(vj) @ np.asarray(vj).transpose(0, 2, 1)
    assert np.abs((vt @ vt.mT).numpy() - pj).max() <= 5e-3
    assert float((At.mm(vt) - vt * et[..., None, :]).abs().max()) <= 2e-4
    # and the cold route gives the same answer
    through_jacobi["kw"] = {}
    ec, _ = xt.linalg.symeig(At, NEIG, "lowest", method="exacteig")
    assert float((ec - et).abs().max()) <= 2e-5 * e0.max()
    assert jacobi_sweep_cuda.launches == 0 and dc_precondition_cuda.launches == 0


def test_slice_warm_gradient_matches_jax(through_jacobi):
    through_jacobi["kw"] = {"precondition": True}
    rng = np.random.default_rng(5)
    lam = np.concatenate([np.linspace(0.2, 0.8, NEIG), np.linspace(2.0, 6.0, N2 - NEIG)])
    q = np.linalg.qr(rng.standard_normal((B2, N2, N2)))[0]
    a = ((q * lam) @ q.transpose(0, 2, 1)).astype(np.float32)
    we = rng.standard_normal((B2, NEIG)).astype(np.float32)
    wp = rng.standard_normal((B2, N2, N2)).astype(np.float32)

    def fj(x):
        A = xj.LinearOperator.m((x + jnp.swapaxes(x, -2, -1)) / 2, is_hermitian=True)
        e, X = xj.linalg.symeig(A, NEIG, "lowest", method="exacteig")
        return jnp.sum(e * we) + jnp.sum((X @ jnp.swapaxes(X, -2, -1)) * wp)

    gj = np.asarray(jax.grad(fj)(jnp.asarray(a)))
    x = torch.tensor(a, requires_grad=True)
    A = xt.LinearOperator.m((x + x.mT) / 2, is_hermitian=True)
    e, X = xt.linalg.symeig(A, NEIG, "lowest")       # default routing: exacteig
    loss = (e * torch.as_tensor(we)).sum() + ((X @ X.mT) * torch.as_tensor(wp)).sum()
    (gt,) = torch.autograd.grad(loss, x)
    assert through_jacobi["n"] == 1
    assert _rel(gt, gj) <= TOL   # float32 eigenvectors at gaps of 0.2


def test_slice_complex_exacteig_and_svd_match_jax(through_jacobi):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((B2, N2, N2)) + 1j * rng.standard_normal((B2, N2, N2))
    herm = (a @ a.conj().transpose(0, 2, 1) / N2 + 2.0 * np.eye(N2)).astype(np.complex64)
    gen = (a / np.sqrt(N2)).astype(np.complex64)
    ej, vj = xj.linalg.symeig(xj.LinearOperator.m(jnp.asarray(herm), is_hermitian=True),
                              NEIG, "lowest", method="exacteig")
    At = xt.LinearOperator.m(torch.as_tensor(herm), is_hermitian=True)
    et, vt = xt.linalg.symeig(At, NEIG, "lowest")
    assert through_jacobi["n"] == 1
    assert et.dtype == torch.float32 and vt.dtype == torch.complex64
    e0 = np.linalg.eigvalsh(herm.astype(np.complex128))
    # the reference's complex64 gate: 3e-5 of the spectral scale
    assert np.abs(et.numpy() - np.asarray(ej)).max() <= 3e-5 * e0.max()
    assert np.abs(et.numpy() - e0[:, :NEIG]).max() <= 3e-5 * e0.max()
    assert float((At.mm(vt) - vt * et[..., None, :]).abs().max()) <= 2e-4
    _, sj, _ = xj.linalg.svd(xj.LinearOperator.m(jnp.asarray(gen)), NEIG)
    u, s, vh = xt.linalg.svd(xt.LinearOperator.m(torch.as_tensor(gen)), NEIG)
    s0 = np.linalg.svd(gen.astype(np.complex128), compute_uv=False)[:, :NEIG][:, ::-1]
    assert np.abs(s.numpy() - np.asarray(sj)).max() <= 3e-5 * s0.max()
    assert np.abs(s.numpy() - s0).max() <= 3e-5 * s0.max()
    resid = torch.as_tensor(gen) @ vh.mH - u * s[..., None, :]
    assert float(resid.abs().max()) <= 2e-4


def test_slice_complex_gradient_matches_jax(through_jacobi):
    rng = np.random.default_rng(7)
    lam = np.concatenate([np.linspace(0.2, 0.8, NEIG), np.linspace(2.0, 6.0, N2 - NEIG)])
    z = rng.standard_normal((B2, N2, N2)) + 1j * rng.standard_normal((B2, N2, N2))
    q = np.linalg.qr(z)[0]
    a = (q * lam) @ q.conj().transpose(0, 2, 1)
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)
    we = rng.standard_normal((B2, NEIG)).astype(np.float32)
    wp = rng.standard_normal((B2, N2, N2)).astype(np.float32)

    def fj(ar, ai):
        x = ar + 1j * ai
        A = xj.LinearOperator.m((x + jnp.swapaxes(x, -2, -1).conj()) / 2, is_hermitian=True)
        e, X = xj.linalg.symeig(A, NEIG, "lowest", method="exacteig")
        P = X @ jnp.swapaxes(X, -2, -1).conj()     # phase-invariant
        return jnp.sum(e * we) + jnp.sum(jnp.real(P) * wp)

    gjr, gji = jax.grad(fj, argnums=(0, 1))(jnp.asarray(ar), jnp.asarray(ai))
    tr = torch.tensor(ar, requires_grad=True)
    ti = torch.tensor(ai, requires_grad=True)
    x = torch.complex(tr, ti)
    A = xt.LinearOperator.m((x + x.mH) / 2, is_hermitian=True)
    e, X = xt.linalg.symeig(A, NEIG, "lowest")
    loss = (e * torch.as_tensor(we)).sum() + ((X @ X.mH).real * torch.as_tensor(wp)).sum()
    gtr, gti = torch.autograd.grad(loss, (tr, ti))
    assert through_jacobi["n"] == 1
    assert _rel(gtr, gjr) <= TOL and _rel(gti, gji) <= TOL
