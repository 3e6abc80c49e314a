"""The port's first slice end to end: BASELINE config 3 at a small size.

A batch of TridiagLowRankOperator systems (diag + tridiagonal coupling +
rank-4), float32, solved by ``linalg.solve(method="structured_cg")``; the
forward solution and the gradients to d, c, V and b are held against
xitorch_tpu's (its Pallas kernel in interpret mode) on the same numpy
inputs.  On the CPU no CUDA kernel may launch.
"""
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
from xitorch_tpu_torch.ops import structured_cg_cuda, thomas_cuda

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
    code = ("import sys; import xitorch_tpu_torch, xitorch_tpu_torch.convert; "
            "print(any(m == 'jax' or m.startswith('jax.') for m in sys.modules))")
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
