"""The eager convergence check's fused route for TridiagLowRankOperator
solves (ops/tlr.py), on the CPU.

``solve``'s check takes the residual operator ``xitorch_tpu_torch::
tlr_residual`` (``linalg/solve.py::_fused_verdict``) only for a
TridiagLowRankOperator without M, in float32, on CUDA tensors.  Here
``_fused_verdict`` is called on CPU tensors, where the operator runs its
plain version, and its verdict ``[failed, max resid, max stop]`` is held
against the generic check's (``A.mm`` and norms, which ``_warn_eager``
computes for CPU tensors) on the same solution; every other problem must
be declined by ``_fused_verdict``.  The kernel itself is held against the
plain version on the card (tests/test_torch_kernels_cuda.py).
"""
import importlib
import warnings

import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu_torch.ops import tlr

torch.set_num_threads(1)

solve_mod = importlib.import_module("xitorch_tpu_torch.linalg.solve")
K, N = 6, 40
OPTS = {"rtol": 1e-6, "atol": 1e-8}


def _check(monkeypatch, A, B, E, M, x, fused, method="structured_cg"):
    """The verdict on these tensors, as a list (None where the fused route
    declines them), and the calls of the residual operator made: with
    ``fused``, :func:`_fused_verdict`'s; else ``_warn_eager``'s (on CPU
    tensors, the generic check)."""
    seen, calls = [], []
    plain = tlr.tlr_residual_plain
    with monkeypatch.context() as mp:
        mp.setattr(solve_mod, "_warn_verdict", lambda v, m: seen.append(v.tolist()))
        mp.setattr(tlr, "tlr_residual_plain", lambda *a: calls.append(1) or plain(*a))
        if fused:
            v = solve_mod._fused_verdict(A, B, E, M, x, method, OPTS["rtol"], OPTS["atol"])
            seen.append(None if v is None else v.tolist())
        else:
            solve_mod._warn_eager(A, B, E, M, x, method, OPTS)
    return seen[0], len(calls)


def _problem(rank, coupling, shift, ncols, bcast_d, seed=0):
    rng = np.random.default_rng(seed)
    d = 4.0 + 2.0 * rng.uniform(size=(1 if bcast_d else K, N))
    d = torch.tensor(d[0] if bcast_d else d, dtype=torch.float32)
    c = {"scalar": torch.tensor(1.0),
         "plane": torch.tensor(0.5 + rng.uniform(size=(K, N - 1)), dtype=torch.float32)}[coupling]
    V = torch.tensor(rng.standard_normal((K, N, rank)) / np.sqrt(N), dtype=torch.float32) \
        if rank else None
    E = torch.tensor(0.1 + 0.4 * rng.uniform(size=(K, ncols)), dtype=torch.float32) \
        if shift else None
    # columns stored one after another, as the kernel's rows read them
    B = torch.tensor(rng.standard_normal((K, ncols, N)), dtype=torch.float32).mT
    return xt.TridiagLowRankOperator(d, c, V), B, E


def _solution(A, B, E, converged):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if converged:
            x = xt.linalg.solve(A, B, E, method="structured_cg", **OPTS)
        else:
            x = xt.linalg.solve(A, B, E, method="cg", max_niter=1, **OPTS)
    return x.mT.contiguous().mT


def _rounding(A, B, E, x):
    """8 eps times the largest norm of the residual's terms' magnitudes:
    how far two float32 residuals summed in other orders can lie apart."""
    mag = (A.d[..., None] * x).abs() + B.abs()
    c = A.c if A.c.ndim == 0 else A.c[..., None]
    mag[..., 1:, :] += (c * x[..., :-1, :]).abs()
    mag[..., :-1, :] += (c * x[..., 1:, :]).abs()
    if A.V is not None:
        mag += A.V.abs() @ (A.V.abs().mT @ x.abs())
    if E is not None:
        mag += (x * E[..., None, :]).abs()
    return 8 * torch.finfo(torch.float32).eps * float(torch.linalg.norm(mag, dim=-2).max())


CASES = [  # rank, coupling, shift, ncols, broadcast d
    (4, "scalar", False, 1, False),    # config 3's operator
    (0, "scalar", False, 1, False),
    (1, "plane", False, 1, False),
    (8, "scalar", True, 1, False),
    (4, "plane", True, 3, False),
    (4, "scalar", False, 3, True),
    (0, "plane", True, 1, True),
]


@pytest.mark.parametrize("converged", [True, False], ids=["converged", "failing"])
@pytest.mark.parametrize("rank, coupling, shift, ncols, bcast_d", CASES)
def test_fused_check_gives_the_generic_verdict(monkeypatch, rank, coupling, shift, ncols,
                                               bcast_d, converged):
    A, B, E = _problem(rank, coupling, shift, ncols, bcast_d)
    # without V the solve is direct (Thomas): a failing x is half the answer
    x = _solution(A, B, E, converged) if rank or converged else 0.5 * _solution(A, B, E, True)
    generic, calls = _check(monkeypatch, A, B, E, None, x, fused=False)
    assert calls == 0
    fused, calls = _check(monkeypatch, A, B, E, None, x, fused=True)
    assert calls == 1
    assert fused[0] == generic[0] == (0.0 if converged else 1.0)
    if converged:
        # a converged residual is near the rounding of its own computation:
        # within the rounding bound, and no more than a quarter apart
        assert abs(fused[1] - generic[1]) <= _rounding(A, B, E, x)
        assert fused[1] == pytest.approx(generic[1], rel=0.25)
    else:
        assert fused[1] == pytest.approx(generic[1], rel=1e-5)
    assert fused[2] == pytest.approx(generic[2], rel=1e-5)


@pytest.mark.parametrize("rank, coupling, shift, ncols, bcast_d", CASES)
def test_rows_are_views_of_the_solves_tensors(rank, coupling, shift, ncols, bcast_d):
    """``ops/tlr.py::tlr_rows``, the one layout of both kernels, puts each
    of solve's tensors into its (K, ...) view without a copy: the same
    storage, a broadcast as stride 0, each row contiguous along n."""
    A, B, E = _problem(rank, coupling, shift, ncols, bcast_d)
    rows = tlr.tlr_rows(B, B, A.d, A.c, A.V, E)
    assert rows is not None
    given = (B, B, A.d, A.c, A.V, E)
    shapes = ((K, ncols, N), (K, ncols, N), (K, N), (K, N - 1), (K, N, rank), (K, ncols))
    for name, r, t, shape in zip(("x", "y", "d", "c", "V", "e"), rows, given, shapes):
        if t is None:
            assert r is None, name
            continue
        assert tuple(r.shape) == shape, name
        assert r.untyped_storage().data_ptr() == t.untyped_storage().data_ptr(), name
    assert rows[0].stride(-1) == rows[2].stride(-1) == 1
    assert rows[2].stride(0) == (0 if bcast_d else N)
    assert rows[3].stride() == ((0, 0) if coupling == "scalar" else (N - 1, 1))


def test_plain_op_matches_the_generic_check_on_config3s_operator():
    """The operator's plain version called directly, in its own layout."""
    A, B, _ = _problem(4, "scalar", False, 1, False)
    x = _solution(A, B, None, False)
    got = torch.ops.xitorch_tpu_torch.tlr_residual(x.mT, B.mT, A.d, A.c.expand(K, N - 1), A.V,
                                                   None, 1e-6, 1e-8)
    r = torch.linalg.norm(A.mm(x) - B, dim=-2)
    stop = torch.clamp(1e-6 * torch.linalg.norm(B, dim=-2), min=1e-8)
    assert got.tolist() == pytest.approx([1.0, float(r.max()), float(stop.max())], rel=1e-5)


def _dense():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((K, N, N)) / np.sqrt(N)
    return xt.LinearOperator.m(torch.tensor(a @ a.transpose(0, 2, 1) + 2 * np.eye(N),
                                            dtype=torch.float32), is_hermitian=True)


def _generic_only(case):
    """Problems the fused route must leave to the generic check: (A, B, E,
    M, method)."""
    rng = np.random.default_rng(2)
    B = torch.tensor(rng.standard_normal((K, 1, N)), dtype=torch.float32).mT
    A, _, _ = _problem(4, "scalar", False, 1, False)
    if case == "dense":
        return _dense(), B, None, None, "cg"
    if case == "banded":
        d = torch.tensor(6.0 + rng.uniform(size=(K, N)), dtype=torch.float32)
        return xt.BandedLowRankOperator(d, {1: 0.5, 2: 0.25}, A.V), B, None, None, "structured_cg"
    if case == "float64":
        return (xt.TridiagLowRankOperator(A.d.double(), A.c.double(), A.V.double()),
                B.double(), None, None, "cg")
    if case == "M":
        M = xt.TridiagLowRankOperator(torch.ones(K, N), 0.1)
        return A, B, torch.full((K, 1), 0.2), M, "cg"
    if case == "direct":
        return A, B, None, None, "custom_exactsolve"
    if case == "rank9":
        V = torch.tensor(rng.standard_normal((K, N, 9)) / np.sqrt(N), dtype=torch.float32)
        return xt.TridiagLowRankOperator(A.d, A.c, V), B, None, None, "cg"
    if case == "columns_interleaved":   # (K, n, 3) contiguous: a column is strided
        return A, torch.tensor(rng.standard_normal((K, N, 3)), dtype=torch.float32), None, \
            None, "structured_cg"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["dense", "banded", "float64", "M", "direct", "rank9",
                                  "columns_interleaved"])
def test_other_problems_keep_the_generic_check(monkeypatch, case):
    A, B, E, M, method = _generic_only(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x = xt.linalg.solve(A, B, E, M, method=method)
    fused, calls = _check(monkeypatch, A, B, E, M, x, fused=True, method=method)
    assert fused is None and calls == 0
    verdict, calls = _check(monkeypatch, A, B, E, M, x, fused=False, method=method)
    assert calls == 0
    assert verdict[0] == 0.0


def test_cpu_tensors_keep_the_generic_check(monkeypatch):
    """On CPU tensors ``solve``'s check of a config 3 operator is the
    generic one: the residual operator is not called."""
    A, B, _ = _problem(4, "scalar", False, 1, False)
    x = _solution(A, B, None, True)
    _, calls = _check(monkeypatch, A, B, None, None, x, fused=False)
    assert calls == 0


@pytest.mark.parametrize("method", ["structured_cg", "cg"])
def test_the_warning_text_is_the_generic_checks(method):
    """A failing solve warns with the same message through either route."""
    A, B, _ = _problem(4, "scalar", False, 1, False)
    x = _solution(A, B, None, False)
    texts = []
    for fused in (False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if fused:
                solve_mod._warn_verdict(solve_mod._fused_verdict(
                    A, B, None, None, x, method, OPTS["rtol"], OPTS["atol"]), method)
            else:
                solve_mod._warn_eager(A, B, None, None, x, method, OPTS)
        assert [w.category for w in caught] == [xt.ConvergenceWarning]
        texts.append(str(caught[0].message))
    assert texts[0] == texts[1]
    assert texts[0].startswith("solve (method=%s) did not converge: max residual " % method)


def test_residual_operator_passes_opcheck_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    x, b = torch.randn(3, 2, 16, generator=g), torch.randn(3, 2, 16, generator=g)
    d = 4.0 + torch.rand(16, generator=g).expand(3, 16)
    args = (x, b, d, torch.tensor(0.5).expand(3, 15), torch.randn(3, 16, 2, generator=g),
            torch.rand(3, 2, generator=g), 1e-6, 1e-8)
    result = torch.library.opcheck(torch.ops.xitorch_tpu_torch.tlr_residual, args)
    assert set(result.values()) == {"SUCCESS"}, result
