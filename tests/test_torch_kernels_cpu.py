"""The plain versions of the port's kernels against the JAX package's
Pallas kernels, run as its own tests run them (interpret=True).

On the CPU the port's kernel wrappers take their plain PyTorch versions,
because the tensors lie on the CPU; the CUDA kernels themselves are held
against the same plain versions on the card (tests/test_torch_kernels_cuda.py
and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xitorch_tpu.ops.structured_cg import structured_cg_pallas
from xitorch_tpu.ops.tridiag import tridiag_solve as jax_tridiag_solve
from xitorch_tpu.ops.tridiag import tridiag_solve_pallas
from xitorch_tpu_torch.ops import (
    fits_structured_cg, structured_cg_cuda, structured_cg_solve, thomas_cuda, thomas_plain,
    tridiag_solve, tridiag_solve_kernel,
)

torch.set_num_threads(1)


def _cg_inputs(offsets, r, batch=3, n=40, seed=0):
    rng = np.random.default_rng(seed)
    nb = len(offsets)
    d = 6.0 + rng.uniform(size=(batch, n))
    bl = np.zeros((batch, nb, n))
    bu = np.zeros((batch, nb, n))
    for k, o in enumerate(offsets):
        c = 0.5 * rng.uniform(size=(batch, n - o))
        bl[:, k, o:] = c
        bu[:, k, :n - o] = c
    V = rng.standard_normal((batch, n, r)) / np.sqrt(n)
    b = rng.standard_normal((batch, n))
    return [a.astype(np.float32) for a in (d, bl, bu, V, b)]


@pytest.mark.parametrize("offsets, r", [((1,), 2), ((1, 2), 3), ((3,), 1)])
def test_plain_cg_matches_pallas_interpret(offsets, r):
    arrs = _cg_inputs(offsets, r)
    kw = dict(offsets=offsets, rtol=1e-6, atol=1e-8)
    xj, itj, resj = structured_cg_pallas(*map(jnp.asarray, arrs), interpret=True, **kw)
    xt, itt, rest = structured_cg_solve(*map(torch.as_tensor, arrs), **kw)
    xj = np.asarray(xj)
    # f32: the port stops each system on its own tolerance, the Pallas
    # kernel runs a tile to its slowest member; both stop below rtol/2
    assert np.max(np.abs(xt.numpy() - xj)) <= 1e-4 * np.max(np.abs(xj))
    itj, itt = np.asarray(itj), itt.numpy()
    assert np.all(itt <= itj + 2) and abs(itt.max() - itj.max()) <= 2
    bn = np.linalg.norm(arrs[4], axis=-1)
    assert np.all(rest.numpy() < 0.5 * 1e-6 * bn)


def test_plain_cg_stops_per_system_and_at_max_niter():
    d, bl, bu, V, b = _cg_inputs((1,), 2, batch=2)
    b[1] *= 1e-3  # same operator shape, a far smaller right-hand side
    args = [torch.as_tensor(a) for a in (d, bl, bu, V, b)]
    _, it, _ = structured_cg_solve(*args, offsets=(1,), rtol=1e-6, atol=1e-6)
    assert it[1] < it[0]  # atol reached sooner by the small system
    _, it2, _ = structured_cg_solve(*args, offsets=(1,), rtol=1e-6, atol=1e-8,
                                    max_niter=3)
    assert it2.tolist() == [3.0, 3.0]


def _thomas_inputs(batch=4, n=33, seed=1, zero_pivot=False):
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-0.5, 0.5, size=(batch, n))
    d = 2.0 + rng.uniform(size=(batch, n))
    du = rng.uniform(-0.5, 0.5, size=(batch, n))
    b = rng.standard_normal((batch, n))
    if zero_pivot:
        # system 0: d1 - dl1 * (du0 / d0) == 1 - 1 * 1 == 0 exactly, so the
        # pivot is replaced by tiny; du1 = 0 and b1 = dl1 * x0 keep it finite
        d[0, :2] = 1.0
        du[0, 0], dl[0, 1], du[0, 1] = 1.0, 1.0, 0.0
        b[0, 1] = b[0, 0]
    return [a.astype(np.float32) for a in (dl, d, du, b)]


@pytest.mark.parametrize("zero_pivot", [False, True])
def test_plain_thomas_matches_pallas_interpret(zero_pivot):
    arrs = _thomas_inputs(zero_pivot=zero_pivot)
    xj = np.asarray(tridiag_solve_pallas(*map(jnp.asarray, arrs), interpret=True))
    xt = tridiag_solve_kernel(*map(torch.as_tensor, arrs)).numpy()
    assert np.all(np.isfinite(xt))
    # f32, the same sweep; XLA may contract multiply-adds differently
    assert np.max(np.abs(xt - xj)) <= 1e-5 * np.max(np.abs(xj))


@pytest.mark.parametrize("dtype, zero_pivot, tol", [
    (np.float32, False, 1e-5), (np.float32, True, 1e-5), (np.float64, False, 1e-12),
])
def test_thomas_plain_on_the_kernels_layout_matches_pallas_interpret(dtype, zero_pivot, tol):
    """thomas_plain on the (K, n) layout the kernel reads and writes, called
    directly, against the Pallas kernel in interpret mode."""
    arrs = [a.astype(dtype) for a in _thomas_inputs(zero_pivot=zero_pivot)]
    xj = np.asarray(tridiag_solve_pallas(*map(jnp.asarray, arrs), interpret=True))
    assert xj.dtype == dtype
    eps = float(np.finfo(dtype).tiny)
    xt = thomas_plain(*map(torch.as_tensor, arrs), eps).numpy()
    assert xt.dtype == dtype and np.all(np.isfinite(xt))
    # the same sweep; XLA may contract multiply-adds differently
    assert np.max(np.abs(xt - xj)) <= tol * np.max(np.abs(xj))


def test_plain_thomas_broadcasts_diagonals():
    dl, d, du, b = _thomas_inputs()
    x_full = tridiag_solve_kernel(*(torch.as_tensor(np.broadcast_to(a[:1], b.shape).copy())
                                    for a in (dl, d, du)), torch.as_tensor(b))
    x_bcast = tridiag_solve_kernel(torch.as_tensor(dl[0]), torch.as_tensor(d[0]),
                                   torch.as_tensor(du[0]), torch.as_tensor(b))
    assert torch.equal(x_full, x_bcast)


def test_tridiag_solve_grads_match_jax():
    dl, d, du, b = (a.astype(np.float64) for a in _thomas_inputs(batch=2, n=9))
    w = np.random.default_rng(2).standard_normal(b.shape)

    def fj(dl, d, du, b):
        return jnp.sum(jax_tridiag_solve(dl, d, du, b, interpret=True) * w)

    gj = jax.grad(fj, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (dl, d, du, b)))
    ts = [torch.tensor(a, requires_grad=True) for a in (dl, d, du, b)]
    gt = torch.autograd.grad((tridiag_solve(*ts) * torch.as_tensor(w)).sum(), ts)
    for a, t in zip(gj, gt):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-10, rtol=1e-8)


def test_tridiag_solve_gradgradcheck():
    dl, d, du, b = (torch.tensor(a.astype(np.float64), requires_grad=True)
                    for a in _thomas_inputs(batch=2, n=6))
    assert torch.autograd.gradcheck(tridiag_solve, (dl, d, du, b))
    assert torch.autograd.gradgradcheck(tridiag_solve, (dl, d, du, b))


def test_fits_structured_cg_for_hopper_shared_memory():
    assert fits_structured_cg(1024, 4, torch.float32, nb=1)  # config 3
    assert not fits_structured_cg(1024, 4, torch.float64)
    assert not fits_structured_cg(8192, 4, torch.float32)
    assert not fits_structured_cg(64, 17, torch.float32)


def test_cg_path_chooser_and_register_window_by_hand(monkeypatch):
    """The register window is 8 elements a thread times the most threads a
    block of the compiled register design can launch with (read from the
    build once a device; a stand-in for the card's answer here), and the
    chooser takes the register design inside it, the shared-memory design
    where the planes fit, else none."""
    from xitorch_tpu_torch.ops import structured_cg as scg

    asked = []

    def attrs(r, nb, device):  # registers a thread, most threads a block
        asked.append((device.index, r, nb))
        return {1: (128, 512), 2: (168, 384)}[nb]

    monkeypatch.setattr(scg, "register_attrs", attrs)
    monkeypatch.setattr(scg, "_WINDOWS", {})
    card = torch.device("cuda", 0)
    assert scg.register_window(4, 1, card) == 8 * 512
    assert scg.register_window(4, 1, card) == 4096 and asked == [(0, 4, 1)]
    assert scg.register_window(8, 2, torch.device("cuda", 1)) == 8 * 384
    # outside the register design: rank above 8, more than 2 bands
    assert scg.register_window(9, 1, card) == scg.register_window(4, 3, card) == 0
    assert len(asked) == 2
    # config 3: n = 1024, rank 4, one band of offset 1
    assert scg.choose_path(1024, 4, (1,), 4096) == "register"
    # n = 3000 at rank 8: 375 threads of 8 elements, 384 with the last warp
    assert scg.choose_path(3000, 8, (1,), 8 * 384) == "register"
    # a build that launches fewer threads: the shared-memory design takes it
    assert scg.choose_path(3000, 8, (1,), 8 * 256) == "shared"
    assert (5 + 2 * 1 + 8) * 3000 * 4 + 4096 <= 232448
    # three bands at rank 16: outside the register design, planes fit shared memory
    assert scg.choose_path(100, 16, (1, 2, 5), 0) == "shared"
    assert (5 + 2 * 3 + 16) * 100 * 4 + 4096 <= 232448
    # a band offset past 8 elements, or planes beyond shared memory
    assert scg.choose_path(1024, 4, (9,), 4096) == "shared"
    assert (5 + 2 * 3 + 8) * 3100 * 4 + 4096 > 232448
    assert scg.choose_path(3100, 8, (1, 2, 3), 0) is None
    assert not fits_structured_cg(3100, 8, torch.float32, nb=3)


def test_merged_reduction_mirror_matches_p_dot_Ap():
    """The register design's one reduction round: p.(D p + B p) and the r
    products v_j.p, from which p.A p = p.(D p + B p) + sum_j (v_j.p)^2;
    mirrored in float64 against p.(A p) of the plain operator, to 1e-12."""
    import torch.nn.functional as F

    rng = np.random.default_rng(5)
    K, n, offsets, r = 3, 50, (1, 3), 4
    d = torch.tensor(6.0 + rng.uniform(size=(K, n)))
    bl = torch.zeros(K, len(offsets), n, dtype=torch.float64)
    bu = torch.zeros_like(bl)
    for k, o in enumerate(offsets):
        c = torch.tensor(0.5 * rng.uniform(size=(K, n - o)))
        bl[:, k, o:] = c
        bu[:, k, :n - o] = c
    V = torch.tensor(rng.standard_normal((K, r, n)) / np.sqrt(n))
    p = torch.tensor(rng.standard_normal((K, n)))
    q = d * p
    for k, o in enumerate(offsets):
        q = q + bl[:, k] * F.pad(p[:, :-o], (o, 0)) + bu[:, k] * F.pad(p[:, o:], (0, o))
    vt = (V * p[:, None, :]).sum(-1)
    merged = (p * q).sum(-1) + (vt * vt).sum(-1)
    A = torch.diag_embed(d) + V.transpose(1, 2) @ V
    for k, o in enumerate(offsets):
        A = A + torch.diag_embed(bl[:, k, o:], offset=-o) + torch.diag_embed(bu[:, k, :n - o],
                                                                              offset=o)
    pAp = (p * (A @ p[..., None])[..., 0]).sum(-1)
    assert torch.allclose(merged, pAp, rtol=1e-12, atol=0)


def test_cpu_tensors_never_reach_the_kernels():
    arrs = [torch.as_tensor(a) for a in _cg_inputs((1,), 2)]
    structured_cg_cuda.launches = thomas_cuda.launches = 0
    structured_cg_solve(*arrs)
    tridiag_solve_kernel(*(torch.as_tensor(a) for a in _thomas_inputs()))
    assert structured_cg_cuda.launches == 0 and thomas_cuda.launches == 0
    with pytest.raises(RuntimeError):
        structured_cg_cuda(arrs[0], arrs[1], arrs[2], arrs[3].transpose(1, 2).contiguous(),
                           arrs[4], (1,), rtol=1e-6, atol=1e-8, max_niter=10)
    meta = torch.empty(3, 8, device="meta")
    with pytest.raises(RuntimeError):
        tridiag_solve_kernel(meta, meta, meta, meta)
