"""The fused route of solve's first-order parameter gradients for
TridiagLowRankOperator problems (ops/tlr.py), on the CPU.

``_SolveFunction.backward`` takes the gradients to d, c, V and E from the
operator ``xitorch_tpu_torch::tlr_grad`` (``linalg/solve.py::
_fused_param_grads``) only for a first-order backward of a
TridiagLowRankOperator without M, in float32, on CUDA tensors.  Here
``_fused_param_grads`` is called on CPU tensors, where the operator runs
its plain version, and its gradients are held against the generic path's
``autograd.grad`` of ``A.mm(x) - x E`` with ``-lam`` at fixed x; every
other problem must be declined.  The kernel itself is held against the
plain version on the card (tests/test_torch_kernels_cuda.py).
"""
import importlib
import itertools
import warnings

import numpy as np
import pytest
import torch

import xitorch_tpu_torch as xt
from xitorch_tpu_torch.ops import tlr as tg

torch.set_num_threads(1)

solve_mod = importlib.import_module("xitorch_tpu_torch.linalg.solve")
K, N = 5, 24
EPS = torch.finfo(torch.float32).eps


def _problem(rank, coupling, shift, ncols, seed=0):
    """(A's d, c, V, E, x, lam) in float32; x and lam (K, N, ncols) with
    each column contiguous along n, as the solve's methods return them."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)

    d = f32(4.0 + 2.0 * rng.uniform(size=(K, N)))
    c = f32(1.0) if coupling == "scalar" else f32(0.5 + rng.uniform(size=(K, N - 1)))
    V = f32(rng.standard_normal((K, N, rank)) / np.sqrt(N)) if rank else None
    E = f32(0.1 + 0.4 * rng.uniform(size=(K, ncols))) if shift else None
    x = f32(rng.standard_normal((K, ncols, N))).mT
    lam = f32(rng.standard_normal((K, ncols, N))).mT
    return d, c, V, E, x, lam


def _need(A, E, want):
    """``ctx.needs_input_grad`` of ``_SolveFunction`` (prob, B2, E, *params)
    for the names in ``want``."""
    names = ["d", "c"] + (["V"] if A.V is not None else [])
    return (False, True, E is not None and "E" in want, *(nm in want for nm in names))


def _generic(d, c, V, E, x, lam, want):
    """The generic path's gradients to the names in ``want``: autograd.grad
    of A.mm(x) - x E at fixed x, with -lam."""
    leaves = {nm: t.detach().clone().requires_grad_(nm in want)
              for nm, t in (("d", d), ("c", c), ("V", V), ("E", E)) if t is not None}
    A = xt.TridiagLowRankOperator(leaves["d"], leaves["c"], leaves.get("V"))
    with torch.enable_grad():
        r = A.mm(x)
        if E is not None:
            r = r - x * leaves["E"][..., None, :]
        wrt = [nm for nm in ("E", "d", "c", "V") if nm in want and nm in leaves]
        gs = torch.autograd.grad(r, [leaves[nm] for nm in wrt], -lam, allow_unused=True)
    return {nm: (torch.zeros_like(leaves[nm]) if g is None else g) for nm, g in zip(wrt, gs)}


def _magnitude(d, c, V, E, x, lam):
    """The same closed form on the terms' magnitudes, ``(gd, gV, gc, gE)``:
    the scale of the rounding of any order of summation."""
    coupling = 1 if c.ndim == 0 else 2
    out = tg.tlr_grad_plain(lam.mT.abs(), x.mT.abs(), None if V is None else V.abs(), True,
                            coupling, True)
    return [t.abs() for t in out]


def _fused(monkeypatch, A, M, x, lam, E, need, create=False):
    """``_fused_param_grads`` as the backward calls it (grad mode off), and
    the number of calls of the plain operator it made."""
    calls = []
    plain = tg.tlr_grad_plain
    with monkeypatch.context() as mp, torch.no_grad():
        mp.setattr(tg, "tlr_grad_plain", lambda *a: calls.append(1) or plain(*a))
        got = solve_mod._fused_param_grads(A, M, x, lam, E, need, create)
    return got, len(calls)


CASES = list(itertools.product([0, 1, 4, 8], ["scalar", "plane"], [False, True], [1, 3]))


@pytest.mark.parametrize("rank, coupling, shift, ncols", CASES)
def test_fused_grads_match_the_generic_path(monkeypatch, rank, coupling, shift, ncols):
    """Every non-empty subset of d, c, V and E asking for a gradient: the
    plain operator, called once, gives each asked gradient in its tensor's
    shape within float32 rounding of the generic path's, and None for the
    others."""
    d, c, V, E, x, lam = _problem(rank, coupling, shift, ncols)
    A = xt.TridiagLowRankOperator(d, c, V)
    mag = dict(zip(("d", "V", "c", "E"), _magnitude(d, c, V, E, x, lam)))
    names = ["d", "c"] + (["V"] if V is not None else []) + (["E"] if E is not None else [])
    for size in range(1, len(names) + 1):
        for want in itertools.combinations(names, size):
            need = _need(A, E, want)
            got, calls = _fused(monkeypatch, A, None, x, lam, E, need)
            assert calls == 1 and got is not None and len(got) == len(need) - 2
            ref = _generic(d, c, V, E, x, lam, want)
            by_name = dict(zip(["E", "d", "c", "V"], got))
            for nm in ("E", "d", "c", "V"):
                if nm not in want:
                    assert by_name.get(nm) is None
                    continue
                g, r = by_name[nm], ref[nm]
                assert g.shape == r.shape and g.dtype == torch.float32
                bound = 32 * EPS * mag[nm] + 1e-30
                assert bool(((g - r).abs() <= bound).all()), (want, nm)


def _declined(case):
    """(A, M, x, lam, E, need, create) that the fused route must decline."""
    d, c, V, E, x, lam = _problem(4, "scalar", True, 1)
    A = xt.TridiagLowRankOperator(d, c, V)
    need = _need(A, E, ("d", "c", "V", "E"))
    if case == "create_graph":
        return A, None, x, lam, E, need, True
    if case == "float64":
        A64 = xt.TridiagLowRankOperator(d.double(), c.double(), V.double())
        return A64, None, x.double(), lam.double(), E.double(), need, False
    if case == "M":
        M = xt.TridiagLowRankOperator(torch.ones(K, N), 0.1)
        return A, M, x, lam, E, (*need, False), False
    if case == "banded":
        B = xt.BandedLowRankOperator(d, {1: c}, V)
        return B, None, x, lam, E, need, False
    if case == "broadcast_d":   # one diagonal for every system, asking for its gradient
        A1 = xt.TridiagLowRankOperator(d[0], c, V)
        return A1, None, x, lam, E, need, False
    if case == "broadcast_V":
        A1 = xt.TridiagLowRankOperator(d, c, V[:1])
        return A1, None, x, lam, E, need, False
    if case == "broadcast_c":
        A1 = xt.TridiagLowRankOperator(d, torch.full((N - 1,), 0.5), V)
        return A1, None, x, lam, E, need, False
    if case == "broadcast_E":
        return A, None, x, lam, E[:1], need, False
    if case == "rank9":
        V9 = torch.randn(K, N, 9, generator=torch.Generator().manual_seed(3)) / N
        return xt.TridiagLowRankOperator(d, c, V9), None, x, lam, E, need, False
    if case == "columns_interleaved":   # (K, n, 3) contiguous: a column is strided
        x3 = torch.randn(K, N, 3, generator=torch.Generator().manual_seed(4))
        return A, None, x3, x3.clone(), E.expand(K, 3).contiguous(), need, False
    raise ValueError(case)


@pytest.mark.parametrize("case", ["create_graph", "float64", "M", "banded", "broadcast_d",
                                  "broadcast_V", "broadcast_c", "broadcast_E", "rank9",
                                  "columns_interleaved"])
def test_other_problems_keep_the_generic_path(monkeypatch, case):
    *args, create = _declined(case)
    got, calls = _fused(monkeypatch, *args, create=create)
    assert got is None and calls == 0


def test_a_broadcast_tensor_without_a_gradient_takes_the_fused_route(monkeypatch):
    """One diagonal for every system is no obstacle where only V's
    gradient is asked for: the kernel does not read d."""
    d, c, V, E, x, lam = _problem(4, "scalar", False, 1)
    A = xt.TridiagLowRankOperator(d[0], c, V)
    got, calls = _fused(monkeypatch, A, None, x, lam, None, _need(A, None, ("V",)))
    assert calls == 1 and got[1] is None and got[2] is None
    ref = _generic(d[0], c, V, None, x, lam, ("V",))["V"]
    assert torch.allclose(got[3], ref, rtol=1e-5, atol=1e-6)


def test_no_coupling_gives_a_zero_coupling_gradient(monkeypatch):
    """A TridiagLowRankOperator without a coupling (c of shape (0,)) asked
    for c's gradient: zeros of its shape, as the generic path gives."""
    d, _, V, _, x, lam = _problem(2, "scalar", False, 1)
    c0 = torch.zeros(0)
    A = xt.TridiagLowRankOperator(d, c0, V)
    got, calls = _fused(monkeypatch, A, None, x, lam, None, _need(A, None, ("d", "c")))
    assert calls == 1
    assert got[2].shape == (0,)
    ref = _generic(d, c0, V, None, x, lam, ("d",))["d"]
    assert torch.allclose(got[1], ref, rtol=1e-6, atol=1e-7)


def _on_card_route(monkeypatch):
    # solve's backward asks the fused route for CUDA tensors only; here
    # CPU tensors pass for CUDA ones in linalg/solve.py's device tests (the
    # operators still run their CPU implementations: the plain versions),
    # and with method="cg" no check queues a copy for the card
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


def _solve_grads(dtype, order, on_card_route, monkeypatch):
    d, c, V, _, _, _ = _problem(4, "plane", False, 1, seed=5)
    rng = np.random.default_rng(6)
    b = torch.tensor(rng.standard_normal((K, N, 1)), dtype=dtype)
    w = torch.tensor(rng.standard_normal((K, N, 1)), dtype=dtype)
    leaves = [t.to(dtype).requires_grad_() for t in (d, c, V, b)]
    with monkeypatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if on_card_route:
            _on_card_route(mp)
        A = xt.TridiagLowRankOperator(*leaves[:3])
        x = xt.linalg.solve(A, leaves[3], method="cg", rtol=1e-7, atol=1e-9)
        gs = torch.autograd.grad((x * w).sum(), leaves, create_graph=order == 2)
        if order == 1:
            return gs
        # a scalar of the first-order gradients, differentiated again
        return torch.autograd.grad(sum((g * g).sum() for g in gs), leaves)


@pytest.mark.parametrize("order", [1, 2])
def test_solve_gradients_through_the_fused_route_equal_the_generic_ones(monkeypatch, order):
    """Gradients of a float32 solve with the backward's fused route on (the
    plain operator, as on the card) equal the generic path's; the first
    order takes the operator once a backward, and a double backward builds
    its first-order gradients by the generic path (a graph is built), then
    takes the operator only in the second pass."""
    calls = []
    plain = tg.tlr_grad_plain
    monkeypatch.setattr(tg, "tlr_grad_plain", lambda *a: calls.append(1) or plain(*a))
    ref = _solve_grads(torch.float32, order, False, monkeypatch)
    assert calls == []
    got = _solve_grads(torch.float32, order, True, monkeypatch)
    assert len(calls) >= 1 if order == 2 else len(calls) == 1
    for g, r in zip(got, ref):
        scale = float(r.abs().max())
        assert torch.allclose(g, r, rtol=0, atol=1e-5 * scale), (order, float((g - r).abs().max()))


def test_create_graph_call_takes_no_fused_gradient(monkeypatch):
    """``autograd.grad(..., create_graph=True)`` of a float32 solve leaves
    the operator alone: those gradients must carry a graph."""
    calls = []
    plain = tg.tlr_grad_plain
    monkeypatch.setattr(tg, "tlr_grad_plain", lambda *a: calls.append(1) or plain(*a))
    d, c, V, _, _, _ = _problem(4, "scalar", False, 1, seed=7)
    leaves = [t.requires_grad_() for t in (d, V)]
    b = torch.ones(K, N, 1)
    with monkeypatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _on_card_route(mp)
        x = xt.linalg.solve(xt.TridiagLowRankOperator(leaves[0], c, leaves[1]), b,
                            method="cg")
        gs = torch.autograd.grad(x.sum(), leaves, create_graph=True)
    assert calls == [] and all(g.requires_grad for g in gs)


def test_cpu_tensors_keep_the_generic_path(monkeypatch):
    """On CPU tensors ``solve``'s backward of a config 3 operator is the
    generic one: the gradient operator is not called."""
    calls = []
    plain = tg.tlr_grad_plain
    monkeypatch.setattr(tg, "tlr_grad_plain", lambda *a: calls.append(1) or plain(*a))
    d, c, V, _, _, _ = _problem(4, "scalar", False, 1)
    leaves = [t.requires_grad_() for t in (d, V)]
    x = xt.linalg.solve(xt.TridiagLowRankOperator(leaves[0], c, leaves[1]),
                        torch.ones(K, N, 1), method="structured_cg")
    torch.autograd.grad(x.sum(), leaves)
    assert calls == []


@pytest.mark.parametrize("V, want_d, coupling, want_e", [
    (True, True, 1, False),     # config 3: d, a scalar c, V
    (True, False, 2, True),
    (False, True, 0, True),
    (False, False, 1, False),
])
def test_grad_operator_passes_opcheck_on_the_cpu(V, want_d, coupling, want_e):
    g = torch.Generator().manual_seed(0)
    lam, x = torch.randn(3, 2, 16, generator=g), torch.randn(3, 2, 16, generator=g)
    Vt = torch.randn(3, 16, 2, generator=g) if V else None
    result = torch.library.opcheck(torch.ops.xitorch_tpu_torch.tlr_grad,
                                   (lam, x, Vt, want_d, coupling, want_e))
    assert set(result.values()) == {"SUCCESS"}, result
    gd, gV, gc, gE = torch.ops.xitorch_tpu_torch.tlr_grad(lam, x, Vt, want_d, coupling, want_e)
    assert gd.shape == ((3, 16) if want_d else (0,))
    assert gV.shape == ((3, 16, 2) if V else (0,))
    assert gc.shape == {0: (0,), 1: (), 2: (3, 15)}[coupling]
    assert gE.shape == ((3, 2) if want_e else (0,))
