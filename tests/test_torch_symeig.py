"""The port's symeig / lsymeig / usymeig / svd against the JAX package with
``method=`` pinned (the reference's default routing keys on its backend),
on the same numpy inputs: values, subspaces, info, warnings, and first and
second order gradients.  The iterative methods draw their random numbers
from different streams on the two sides, so only converged results are
compared (eigenvalues, residuals, projectors), with ``v_init="eye"`` where
a deterministic start matters."""
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

import xitorch_tpu as xj
import xitorch_tpu_torch as xt
from xitorch_tpu._impls.linalg.symeig import degen_eigh as jdegen_eigh
from xitorch_tpu_torch._impls.linalg.symeig import degen_eigh, degen_svd
from xitorch_tpu_torch.convert import pencil_from_numpy
from xitorch_tpu_torch.linalg.symeig import _auto_symeig_method
from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning, MathWarning

torch.set_num_threads(1)

B, N, K = 2, 16, 3
ITER_OPTS = {
    "exacteig": {},
    "davidson": {"min_eps": 1e-9, "max_niter": 400, "v_init": "eye"},
    "chebfsi": {"min_eps": 1e-9, "v_init": "eye"},
}


def _pencil(seed=0, n=N, batch=(B,), dtype=np.float64):
    """bench_symeig.py's SPD matrix and SPD metric recipes, with numpy."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((*batch, n, n)) / np.sqrt(n)
    a = a @ np.swapaxes(a, -2, -1) + 2.0 * np.eye(n)
    c = rng.standard_normal((*batch, n, n)) / (2.0 * np.sqrt(n))
    m = c @ np.swapaxes(c, -2, -1) + np.eye(n)
    return a.astype(dtype), m.astype(dtype)


def _jops(a, m=None):
    A = xj.LinearOperator.m(jnp.asarray(a), is_hermitian=True)
    M = None if m is None else xj.LinearOperator.m(jnp.asarray(m), is_hermitian=True)
    return A, M


def _proj(v):
    v = np.asarray(v.detach() if torch.is_tensor(v) else v, dtype=np.float64)
    return v @ np.swapaxes(v, -2, -1)


@pytest.mark.parametrize("mode", ["lowest", "uppest"])
@pytest.mark.parametrize("with_m", [False, True], ids=["standard", "generalized"])
@pytest.mark.parametrize("method", ["exacteig", "davidson", "chebfsi"])
def test_symeig_matches_jax_f64(method, with_m, mode):
    a, m = _pencil()
    m = m if with_m else None
    ej, vj = xj.linalg.symeig(*(_jops(a, m)[:1]), K, mode, M=_jops(a, m)[1],
                              method=method, **ITER_OPTS[method])
    At, Mt = pencil_from_numpy(a, m, device="cpu")
    et, vt = xt.linalg.symeig(At, K, mode, M=Mt, method=method, **ITER_OPTS[method])
    assert et.shape == (B, K) and vt.shape == (B, N, K) and et.dtype == torch.float64
    # float64 values to 1e-6 (far tighter in practice); projectors because
    # eigenvector signs are free
    assert np.abs(et.numpy() - np.asarray(ej)).max() <= 1e-6
    assert np.abs(_proj(vt) - _proj(vj)).max() <= 1e-6
    # the port's own residual and M-orthonormality
    Mv = vt if Mt is None else Mt.mm(vt)
    assert float((At.mm(vt) - Mv * et[..., None, :]).abs().max()) <= 1e-7
    assert float((vt.mT @ Mv - torch.eye(K, dtype=vt.dtype)).abs().max()) <= 1e-7
    assert bool((et[..., 1:] >= et[..., :-1]).all())  # ascending in both modes


@pytest.mark.parametrize("method", ["exacteig", "davidson", "chebfsi"])
def test_symeig_matches_jax_f32(method):
    a, _ = _pencil(seed=1, dtype=np.float32)
    opts = dict(ITER_OPTS[method])
    if opts:
        opts["min_eps"] = 1e-4
    ej, _ = xj.linalg.symeig(_jops(a)[0], K, "lowest", method=method, **opts)
    et, vt = xt.linalg.symeig(pencil_from_numpy(a, device="cpu")[0], K, "lowest",
                              method=method, **opts)
    e0 = np.linalg.eigvalsh(a.astype(np.float64))[:, :K]
    # float32: eps*||A||-grade values (the gate of the reference's tests)
    scale = np.abs(e0).max()
    assert et.dtype == torch.float32
    assert np.abs(et.numpy() - np.asarray(ej)).max() <= 2e-5 * scale
    assert np.abs(et.numpy() - e0).max() <= 2e-5 * scale


def test_aliases_full_spectrum_and_batch_broadcast():
    a, m = _pencil(seed=2, n=8, batch=(2, 1))
    m = m[0]  # M (1, 8, 8) against A (2, 1, 8, 8)
    At, Mt = pencil_from_numpy(a, m, device="cpu")
    Aj, Mj = _jops(a, m)
    el, vl = xt.linalg.lsymeig(At, 2, M=Mt, method="exacteig")
    eu, vu = xt.linalg.usymeig(At, 2, M=Mt, method="exacteig")
    ef, vf = xt.linalg.symeig(At, M=Mt, method="exacteig")   # neig=None: all
    assert ef.shape == (2, 1, 8) and vf.shape == (2, 1, 8, 8)
    assert torch.equal(el, ef[..., :2]) and torch.equal(eu, ef[..., -2:])
    ej, _ = xj.linalg.symeig(Aj, None, "lowest", M=Mj, method="exacteig")
    assert np.abs(ef.numpy() - np.asarray(ej)).max() <= 1e-10
    e2, _ = xt.linalg.symeig(At, 2, "uppermost", M=Mt, method="exacteig")
    assert torch.equal(e2, eu)


@pytest.mark.parametrize("method", ["exacteig", "davidson", "chebfsi"])
def test_return_info(method):
    a, _ = _pencil(seed=3)
    ej = xj.linalg.symeig(_jops(a)[0], K, method=method, return_info=True,
                          **ITER_OPTS[method])
    et = xt.linalg.symeig(pencil_from_numpy(a, device="cpu")[0], K, method=method, return_info=True,
                          **ITER_OPTS[method])
    assert len(et) == 3 and set(et[2]) == set(ej[2]) == {
        "converged", "iterations", "resid", "resid_rel"}
    for v in et[2].values():
        assert v.dtype == torch.float32 and v.dim() == 0 and not v.requires_grad
    assert float(et[2]["converged"]) == float(ej[2]["converged"]) == 1.0
    assert float(et[2]["resid_rel"]) < 1.0


def test_nonconvergence_warns_and_returns_best_iterate():
    a, _ = _pencil(seed=4)
    A = pencil_from_numpy(a, device="cpu")[0]
    with pytest.warns(ConvergenceWarning, match="did not converge"):
        e, v, info = xt.linalg.symeig(A, K, method="davidson", max_niter=1,
                                      min_eps=1e-12, return_info=True)
    assert float(info["converged"]) == 0.0 and float(info["iterations"]) == 1.0
    assert bool(torch.isfinite(e).all()) and bool(torch.isfinite(v).all())
    # without return_info a pinned method stays silent, as in the reference
    with warnings.catch_warnings():
        warnings.simplefilter("error", ConvergenceWarning)
        xt.linalg.symeig(A, K, method="davidson", max_niter=1, min_eps=1e-12)


def test_errors_and_routing():
    a, m = _pencil(seed=5, n=8)
    A, M = pencil_from_numpy(a, m, device="cpu")
    with pytest.raises(RuntimeError, match="Hermitian"):
        xt.linalg.symeig(xt.LinearOperator.m(torch.as_tensor(a), is_hermitian=False), 2)
    with pytest.raises(RuntimeError, match="Hermitian"):
        xt.linalg.symeig(A, 2, M=xt.LinearOperator.m(torch.as_tensor(m),
                                                     is_hermitian=False))
    with pytest.raises(RuntimeError, match="mode"):
        xt.linalg.symeig(A, 2, "middle")
    with pytest.raises(RuntimeError, match="requires a KronOperator"):
        xt.linalg.symeig(A, 2, method="kron_exact")
    with pytest.raises(RuntimeError, match="Unknown symeig method"):
        xt.linalg.symeig(A, 2, method="lanczos")
    with pytest.raises(RuntimeError, match="mode"):
        xt.linalg.svd(A, 2, "middle")
    # default routing: CPU tensors keep the dense default at every shape
    big = xt.LinearOperator.m(torch.eye(256), is_hermitian=True)
    assert _auto_symeig_method(big, 8, None) == "exacteig"
    assert _auto_symeig_method(big, 8, big) == "exacteig"
    e, _ = xt.linalg.symeig(A, 2)
    assert torch.equal(e, xt.linalg.symeig(A, 2, method="exacteig")[0])


def _on_card(n, dtype):
    """What the routing reads of an operator: shape, dtype, device."""
    return SimpleNamespace(shape=(4, n, n), dtype=dtype, device=torch.device("cuda"))


@pytest.mark.parametrize("n, dtype, neig, with_m, expect", [
    # inside the sweep kernels' window the dense route comes first
    (256, torch.float32, 8, False, "exacteig"),
    (256, torch.float32, 8, True, "exacteig"),
    (256, torch.complex64, 8, False, "exacteig"),
    (64, torch.float32, 2, False, "exacteig"),
    (1024, torch.float32, 8, False, "exacteig"),
    # outside it, the extreme-k gate of the iterative methods
    (1536, torch.float32, 8, False, "chebfsi"),
    (1536, torch.float32, 8, True, "davidson"),
    (256, torch.float64, 8, False, "chebfsi"),
    (1536, torch.float32, 200, False, "exacteig"),   # not k << n
    (1536, torch.complex64, 8, False, "exacteig"),   # complex stays dense
    (48, torch.float32, 2, False, "exacteig"),       # small
])
def test_default_routing_on_the_card(n, dtype, neig, with_m, expect):
    A = _on_card(n, dtype)
    assert _auto_symeig_method(A, neig, A if with_m else None) == expect


# ------------------------------------------------------------------
# gradients
# ------------------------------------------------------------------

def _sym_leaf(n, seed, batch=(2,)):
    a = np.random.default_rng(seed).standard_normal((*batch, n, n))
    return torch.tensor(a + np.swapaxes(a, -2, -1), requires_grad=True)


def test_degen_eigh_gradcheck_first_and_second_order():
    A = _sym_leaf(5, 0)
    w = torch.arange(1.0, 6.0, dtype=torch.float64)

    def f(A):
        e, v = degen_eigh((A + A.mT) / 2)
        return e, (v * w) @ v.mT   # sign-invariant function of the vectors

    assert gradcheck(f, (A,))
    assert gradgradcheck(f, (A,))


@pytest.mark.parametrize("shape", [(5, 4), (4, 4), (3, 5)])
def test_degen_svd_gradcheck_first_and_second_order(shape):
    G = torch.tensor(np.random.default_rng(1).standard_normal((2, *shape)),
                     requires_grad=True)
    w = torch.arange(1.0, min(shape) + 1.0, dtype=torch.float64)

    def f(G):
        u, s, v = degen_svd(G)
        return s, (u * w) @ u.mT, (v * w) @ v.mT, (u * w) @ v.mT

    assert gradcheck(f, (G,))
    assert gradgradcheck(f, (G,))


@pytest.mark.parametrize("with_m", [False, True], ids=["standard", "generalized"])
@pytest.mark.parametrize("method", ["exacteig", "chebfsi"])
def test_symeig_gradcheck_first_and_second_order(method, with_m):
    A = _sym_leaf(6, 2)
    _, m = _pencil(seed=2, n=6)
    Mleaf = torch.tensor(m, requires_grad=True)
    w = torch.tensor([1.0, 2.0], dtype=torch.float64)
    opts = {} if method == "exacteig" else {"min_eps": 1e-10, "v_init": "eye"}
    bck = {} if method == "exacteig" else {"rtol": 1e-12, "atol": 1e-14}

    def f(A, M=None):
        Ao = xt.LinearOperator.m((A + A.mT) / 2, is_hermitian=True)
        Mo = None if M is None else xt.LinearOperator.m((M + M.mT) / 2, is_hermitian=True)
        e, v = xt.linalg.symeig(Ao, 2, "lowest", M=Mo, method=method, bck_options=bck,
                                **opts)
        return e, (v * w) @ v.mT

    args = (A, Mleaf) if with_m else (A,)
    # the iterative forward is converged to 1e-10 and the adjoint solve to
    # 1e-12, so the finite differences see that floor
    assert gradcheck(f, args, atol=1e-6, rtol=1e-4)
    assert gradgradcheck(f, args, atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("with_m", [False, True], ids=["standard", "generalized"])
@pytest.mark.parametrize("method", ["exacteig", "davidson", "chebfsi"])
def test_symeig_gradients_match_jax(method, with_m):
    a, m = _pencil(seed=6, n=10)
    wv = np.random.default_rng(6).standard_normal((B, 10, 10))
    opts = {} if method == "exacteig" else dict(ITER_OPTS[method], min_eps=1e-10)
    bck = {} if method == "exacteig" else {"rtol": 1e-11, "atol": 1e-13}

    def fj(am, mm):
        A = xj.LinearOperator.m((am + jnp.swapaxes(am, -2, -1)) / 2, is_hermitian=True)
        M = xj.LinearOperator.m((mm + jnp.swapaxes(mm, -2, -1)) / 2, is_hermitian=True) \
            if with_m else None
        e, v = xj.linalg.symeig(A, K, "lowest", M=M, method=method, bck_options=bck,
                                **opts)
        return jnp.sum(e ** 2) + jnp.sum((v @ jnp.swapaxes(v, -2, -1)) * wv)

    gj = jax.grad(fj, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(m))
    at = torch.tensor(a, requires_grad=True)
    mt = torch.tensor(m, requires_grad=True)
    A = xt.LinearOperator.m((at + at.mT) / 2, is_hermitian=True)
    M = xt.LinearOperator.m((mt + mt.mT) / 2, is_hermitian=True) if with_m else None
    e, v = xt.linalg.symeig(A, K, "lowest", M=M, method=method, bck_options=bck, **opts)
    loss = (e ** 2).sum() + ((v @ v.mT) * torch.as_tensor(wv)).sum()
    gt = torch.autograd.grad(loss, (at, mt) if with_m else (at,))
    for t, j in zip(gt, gj):
        j = np.asarray(j)
        # both sides converge the forward to 1e-10 and the adjoint to 1e-11
        assert np.abs(t.numpy() - j).max() <= 1e-6 * max(1.0, np.abs(j).max())


def test_degenerate_spectrum_gradients():
    rng = np.random.default_rng(8)
    q, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    lam = np.array([1.0, 1.0, 2.0, 3.0])  # 2-fold degenerate lowest eigenvalue
    a = (q * lam) @ q.T
    a = (a + a.T) / 2
    at = torch.tensor(a, requires_grad=True)
    e, v = degen_eigh((at + at.mT) / 2)
    (g,) = torch.autograd.grad((e ** 2).sum(), at, retain_graph=True)
    # eigenvalue sum of squares = trace(A^2): the gradient is 2A
    assert np.abs(g.numpy() - 2 * a).max() <= 1e-6 * np.abs(2 * a).max()
    gj = jax.grad(lambda x: jnp.sum(jdegen_eigh((x + x.T) / 2)[0] ** 2))(jnp.asarray(a))
    assert np.abs(g.numpy() - np.asarray(gj)).max() <= 1e-10
    # a plain eigh gradient would be NaN here; this one must be finite
    (g2,) = torch.autograd.grad((v ** 4).sum(), at)
    assert bool(torch.isfinite(g2).all())
    # rotation-invariant loss on the degenerate pair through the implicit
    # rule (davidson), against the JAX package
    wv = rng.standard_normal((4, 4))

    def fj(x):
        A = xj.LinearOperator.m((x + x.T) / 2, is_hermitian=True)
        ev, X = xj.linalg.symeig(A, 2, "lowest", method="davidson", min_eps=1e-11,
                                 v_init="eye")
        return jnp.sum((X @ X.T) * wv) + jnp.sum(ev ** 2)

    A = xt.LinearOperator.m((at + at.mT) / 2, is_hermitian=True)
    ev, X = xt.linalg.symeig(A, 2, "lowest", method="davidson", min_eps=1e-11,
                             v_init="eye")
    (g3,) = torch.autograd.grad(((X @ X.mT) * torch.as_tensor(wv)).sum()
                                + (ev ** 2).sum(), at)
    g3j = np.asarray(jax.grad(fj)(jnp.asarray(a)))
    assert bool(torch.isfinite(g3).all())
    assert np.abs(g3.numpy() - g3j).max() <= 1e-6 * max(1.0, np.abs(g3j).max())


def test_degen_requirement_mathwarning_in_debug_mode():
    rng = np.random.default_rng(9)
    d = np.array([1.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])  # degenerate lowest pair
    q, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    at = torch.tensor((q * d) @ q.T, requires_grad=True)

    def run(loss):
        A = xt.LinearOperator.m((at + at.mT) / 2, is_hermitian=True)
        ev, X = xt.linalg.symeig(A, 2, "lowest", method="davidson", min_eps=1e-11,
                                 max_niter=2000)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.autograd.grad(loss(ev, X), at)
        return [x for x in w if issubclass(x.category, MathWarning)]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # LinearOperator.check's own notice
        with xt.enable_debug():
            assert run(lambda ev, X: (X[:, 0] ** 4).sum())      # depends on the rotation
            assert not run(lambda ev, X: (ev ** 2).sum())       # eigenvalues only


# ------------------------------------------------------------------
# svd
# ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 12, 8), (2, 8, 12), (8, 8)])
@pytest.mark.parametrize("method, mode", [(None, "uppest"), (None, "lowest"),
                                          ("exacteig", "uppest"), ("davidson", "uppest")])
def test_svd_matches_jax(shape, method, mode):
    g = np.random.default_rng(sum(shape)).standard_normal(shape)
    opts = {"min_eps": 1e-10, "v_init": "eye"} if method == "davidson" else {}
    uj, sj, vhj = xj.linalg.svd(xj.LinearOperator.m(jnp.asarray(g)), K, mode,
                                method=method, **opts)
    u, s, vh = xt.linalg.svd(xt.LinearOperator.m(torch.as_tensor(g)), K, mode,
                             method=method, **opts)
    m, n = shape[-2:]
    assert u.shape == (*shape[:-2], m, K) and s.shape == (*shape[:-2], K)
    assert vh.shape == (*shape[:-2], K, n)
    assert np.abs(s.numpy() - np.asarray(sj)).max() <= 1e-6
    s0 = np.linalg.svd(g, compute_uv=False)[..., ::-1]
    s0 = s0[..., :K] if mode == "lowest" else s0[..., -K:]
    assert np.abs(s.numpy() - s0).max() <= 1e-6
    # sign-free comparison of the singular triplets
    rec = (u * s[..., None, :]) @ vh
    recj = (np.asarray(uj) * np.asarray(sj)[..., None, :]) @ np.asarray(vhj)
    assert np.abs(rec.numpy() - recj).max() <= 1e-6


@pytest.mark.parametrize("method", [None, "davidson"])
def test_svd_gradients_match_jax(method):
    g = np.random.default_rng(11).standard_normal((2, 9, 6))
    wv = np.random.default_rng(12).standard_normal((2, 9, 6))
    opts = {"min_eps": 1e-11, "v_init": "eye"} if method else {}
    bck = {"rtol": 1e-11, "atol": 1e-13} if method else {}

    def fj(x):
        u, s, vh = xj.linalg.svd(xj.LinearOperator.m(x), 2, method=method,
                                 bck_options=bck, **opts)
        return jnp.sum(s ** 3) + jnp.sum(((u * s[..., None, :]) @ vh) * wv)

    gj = np.asarray(jax.grad(fj)(jnp.asarray(g)))
    gt = torch.tensor(g, requires_grad=True)
    u, s, vh = xt.linalg.svd(xt.LinearOperator.m(gt), 2, method=method, bck_options=bck,
                             **opts)
    loss = (s ** 3).sum() + (((u * s[..., None, :]) @ vh) * torch.as_tensor(wv)).sum()
    (gg,) = torch.autograd.grad(loss, gt)
    assert np.abs(gg.numpy() - gj).max() <= 1e-6 * max(1.0, np.abs(gj).max())


# ------------------------------------------------------------------
# complex input (the models are tests/test_complex.py's)
# ------------------------------------------------------------------

def _herm_c(seed, n, batch=()):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((*batch, n, n)) + 1j * rng.standard_normal((*batch, n, n))
    return a @ np.swapaxes(a, -2, -1).conj() + n * np.eye(n)


@pytest.mark.parametrize("method", ["exacteig", "davidson", "chebfsi"])
def test_symeig_complex_matches_jax(method):
    n, neig = 8, 3
    a = _herm_c(0, n, (2,))
    opts = {} if method == "exacteig" else {"min_eps": 1e-10, "max_niter": 2000}
    ej, vj = xj.linalg.symeig(_jops(a)[0], neig, "lowest", method=method, **opts)
    At, _ = pencil_from_numpy(a, device="cpu")
    assert At.dtype == torch.complex128
    et, vt = xt.linalg.symeig(At, neig, "lowest", method=method, **opts)
    assert et.dtype == torch.float64 and vt.dtype == torch.complex128
    d = np.linalg.eigvalsh(a)[:, :neig]
    assert np.abs(et.numpy() - d).max() <= 1e-8
    assert np.abs(et.numpy() - np.asarray(ej)).max() <= 1e-8
    assert float((At.mm(vt) - vt * et[..., None, :]).abs().max()) <= 1e-7
    # projectors: eigenvector phases are free
    pt = vt.numpy() @ np.swapaxes(vt.numpy(), -2, -1).conj()
    pj = np.asarray(vj) @ np.swapaxes(np.asarray(vj), -2, -1).conj()
    assert np.abs(pt - pj).max() <= 1e-6


@pytest.mark.parametrize("method", ["exacteig", "davidson"])
def test_symeig_complex_gradient_matches_jax(method):
    """Gradient of a phase-invariant loss to the real and imaginary parts of
    a general complex matrix whose hermitian part is decomposed."""
    n, neig = 8, 2
    rng = np.random.default_rng(1)
    ar, ai = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    kw = {} if method == "exacteig" else {
        "min_eps": 1e-12, "max_niter": 4000,
        "bck_options": {"rtol": 1e-12, "atol": 1e-14}}

    def jloss(ar, ai):
        a = ar + 1j * ai
        H = (a + a.conj().T) / 2
        e, v = xj.linalg.symeig(xj.LinearOperator.m(H, is_hermitian=True), neig,
                                "lowest", method=method, **kw)
        return jnp.sum(e ** 2) + jnp.sum(jnp.abs(v[:3]) ** 2)

    def tloss(ar, ai):
        a = torch.complex(ar, ai)
        H = (a + a.mH) / 2
        e, v = xt.linalg.symeig(xt.LinearOperator.m(H, is_hermitian=True), neig,
                                "lowest", method=method, **kw)
        return (e ** 2).sum() + (v[:3].abs() ** 2).sum()

    gjr, gji = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ar), jnp.asarray(ai))
    tr = torch.tensor(ar, requires_grad=True)
    ti = torch.tensor(ai, requires_grad=True)
    loss = tloss(tr, ti)
    gtr, gti = torch.autograd.grad(loss, (tr, ti))
    assert abs(float(loss.detach()) - float(jloss(jnp.asarray(ar), jnp.asarray(ai)))) <= 1e-8
    # float64 on both sides; the iterative route's implicit solve is the
    # looser of the two (the reference's own test allows 1e-4 there)
    tol = 1e-8 if method == "exacteig" else 1e-5
    scale = np.abs(np.asarray(gjr)).max()
    assert np.abs(gtr.numpy() - np.asarray(gjr)).max() <= tol * scale
    assert np.abs(gti.numpy() - np.asarray(gji)).max() <= tol * scale


def test_svd_complex_native_route_matches_jax():
    m, n, k = 10, 7, 7
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, m, n)) + 1j * rng.standard_normal((2, m, n))
    uj, sj, vhj = xj.linalg.svd(xj.LinearOperator.m(jnp.asarray(a)), k)
    u, s, vh = xt.linalg.svd(xt.LinearOperator.m(torch.as_tensor(a)), k)
    assert u.shape == (2, m, k) and s.shape == (2, k) and vh.shape == (2, k, n)
    sref = np.linalg.svd(a, compute_uv=False)[..., ::-1]   # ascending
    assert np.abs(s.numpy() - sref).max() < 1e-10
    assert np.abs(s.numpy() - np.asarray(sj)).max() < 1e-10
    rec = (u * s[..., None, :]) @ vh
    assert float((rec - torch.as_tensor(a)).abs().max()) < 1e-9
    # top-3 only, and the lowest end
    u3, s3, vh3 = xt.linalg.svd(xt.LinearOperator.m(torch.as_tensor(a)), 3)
    assert torch.equal(s3, s[..., -3:]) and vh3.shape == (2, 3, n)
    _, sl, _ = xt.linalg.svd(xt.LinearOperator.m(torch.as_tensor(a)), 2, "lowest")
    assert torch.equal(sl, s[..., :2])

    K = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    K = (K + K.conj().T) / 2
    w = 1.0 + 0.1 * np.arange(k)

    def jloss(ar, ai):
        u, s, vh = xj.linalg.svd(xj.LinearOperator.m(ar + 1j * ai), k)
        return (jnp.sum(s * w)
                + jnp.real(jnp.einsum("bmi,mk,bki->", u.conj(), jnp.asarray(K), u)))

    def tloss(ar, ai):
        u, s, vh = xt.linalg.svd(xt.LinearOperator.m(torch.complex(ar, ai)), k)
        return ((s * torch.as_tensor(w)).sum()
                + torch.einsum("bmi,mk,bki->", u.conj(), torch.as_tensor(K), u).real)

    gjr, gji = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a.real), jnp.asarray(a.imag))
    tr = torch.tensor(a.real, requires_grad=True)
    ti = torch.tensor(a.imag, requires_grad=True)
    gtr, gti = torch.autograd.grad(tloss(tr, ti), (tr, ti), create_graph=True)
    # the same tangent rule transposed on both sides, in float64
    scale = np.abs(np.asarray(gjr)).max()
    assert np.abs(gtr.detach().numpy() - np.asarray(gjr)).max() <= 1e-8 * scale
    assert np.abs(gti.detach().numpy() - np.asarray(gji)).max() <= 1e-8 * scale
    # second order through the backward rule
    (h,) = torch.autograd.grad((gtr * torch.as_tensor(rng.standard_normal(a.shape))).sum(), tr)
    assert bool(torch.isfinite(h).all())


def test_degen_eigh_complex_gradient_against_torch_eigh():
    a = _herm_c(3, 6, (2,))
    w = torch.arange(1.0, 7.0, dtype=torch.float64)

    def loss(f, A):
        e, v = f((A + A.mH) / 2)
        return (e ** 2).sum() + ((v * w) @ v.mH).real.pow(2).sum()   # phase-invariant

    A1 = torch.tensor(a, requires_grad=True)
    A2 = torch.tensor(a, requires_grad=True)
    (g1,) = torch.autograd.grad(loss(degen_eigh, A1), A1)
    (g2,) = torch.autograd.grad(loss(torch.linalg.eigh, A2), A2)
    assert float((g1 - g2).abs().max()) <= 1e-9 * float(g2.abs().max())


def test_convert_carries_complex_operators():
    a = _herm_c(4, 8)
    m = _herm_c(5, 8) / 8
    A, M = pencil_from_numpy(a.astype(np.complex64), m.astype(np.complex64), device="cpu")
    assert A.dtype == torch.complex64 and M.dtype == torch.complex64
    assert A.is_hermitian and M.is_hermitian
    e, v = xt.linalg.symeig(A, 2, M=M, method="exacteig")
    import scipy.linalg
    e0 = scipy.linalg.eigh(a, m, eigvals_only=True)[:2]
    assert np.abs(e.numpy() - e0).max() <= 1e-4 * np.abs(e0).max()
    A128, _ = pencil_from_numpy(a.astype(np.complex64), device="cpu",
                                dtype=torch.complex128)
    assert A128.dtype == torch.complex128
    with pytest.raises(ValueError, match="complex"):
        pencil_from_numpy(a, device="cpu", dtype=torch.float64)
