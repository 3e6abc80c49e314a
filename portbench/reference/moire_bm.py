"""Plain reference of ``tbg_bm_n244``: the Bistritzer-MacDonald continuum
model of twisted bilayer graphene (one valley, one spin), its bands on a
k-mesh and the gradient of the flat-band energy

    L(theta, u, u') = mean_k (E_{n/2-1}(k)^2 + E_{n/2}(k)^2)

to the twist angle (degrees) and the two tunnellings (eV).

The Hamiltonian is built here by loops over the reciprocal vectors G, one
2 x 2 block at a time, independently of the port's code.  The geometry
(Tarnopolsky, Kruchkov and Vishwanath's convention): ``|K| = 4 pi / 3a``,
``k_theta = 2 |K| sin(theta / 2)``, ``q1 = k_theta (0, -1)``,
``q2 = k_theta (sqrt3/2, 1/2)``, ``q3 = k_theta (-sqrt3/2, 1/2)``,
``b1 = q2 - q1``, ``b2 = q3 - q1``.  Layer 1 holds ``k + G``, layer 2
``k + G + q1``, with ``G = m b1 + p b2``, ``|m|, |p|, |m + p| <= cutoff``,
in the order of :func:`g_list`; state ``(layer, G, sublattice)`` is row
``(layer * NG + g) * 2 + s``.  The intralayer block is ``hbar_v sigma.p``
of the layer's momentum, ``sigma.p = [[0, px - i py], [px + i py, 0]]``
(the sigma matrices are not rotated by +-theta/2); (layer 1, k + G)
couples to (layer 2, k + G + q_j) through ``T_j = [[u, u' w^-(j-1)],
[u' w^(j-1), u]]``, ``w = exp(2 pi i / 3)``, and back through ``T_j^H``.
``kpts`` are fractional coordinates on b1 and b2.

The truth is float64: ``eigh`` of H, and L and its three derivatives by
float64 autograd.  An eigenvalue is judged relative to ``|H|_2`` over all
n bands (``eval_err``) and in eV on the two flat bands (``flat_err``:
they lie within a few meV of zero, in a spectrum of |E| up to 1.6 eV);
an eigenvector by its float64 residual with the program's own eigenvalue
(``resid``) and the block by ``|X^H X - I|`` (``orth``); each of the
three derivatives by its error in the units of ``eval_err``
(``grad_err``): over ``mean_k 2 |H_k|_2 sum_b |dE_b/dp|``, the error an
error of ``|H|_2`` in each flat energy would make of it.  Inside the
traffic's 2 % spread the magic angle itself is reached: L falls from
3e-6 to 6e-8 eV^2, the flat energies to a few 1e-4 eV, and dL/dtheta and
dL/du' pass through zero together (dL/du elsewhere), so a derivative's
own relative error, or one over the magnitude of its terms
``2 E dE/dp``, grows as 1/E in any float32 program whose flat energies
are good to ``eps |H|_2``, while this one stays put.  ``dE_b/dp =
v_b^H (dH/dp) v_b`` (Hellmann-Feynman, the float64 eigenvectors of the
flat pair) with ``dH/dp`` from this module's own build: H is linear in u
and u' and, at fixed fractional k, proportional to ``sin(theta / 2)`` in
its intralayer part.
The control: H built in float32 and rounded to TF32, complex64 ``eigh``
with TF32 products, L and its gradient through both (the rounding passed
straight through).
"""
import contextlib
import math

import torch

from portbench.reference.precision import round_tf32, tf32_products

SQ3 = math.sqrt(3.0)


def g_list(cutoff):
    """The reciprocal vectors kept, as (m, p): m ascending, then p."""
    return [(m, p) for m in range(-cutoff, cutoff + 1) for p in range(-cutoff, cutoff + 1)
            if abs(m + p) <= cutoff]


def hamiltonian(kpts, theta, u, up, hbar_v, a, cutoff):
    """(K, n, n) hermitian matrices at ``kpts`` (K, 2) fractional, in the
    complex dtype of ``kpts``; ``theta`` in degrees, ``u``, ``up`` in eV,
    ``hbar_v`` in eV nm, ``a`` in nm (0-d tensors or floats)."""
    gs = g_list(cutoff)
    ng = len(gs)
    n = 4 * ng
    K = kpts.shape[0]
    cdt = torch.complex128 if kpts.dtype == torch.float64 else torch.complex64
    kth = 2.0 * (4.0 * math.pi / (3.0 * a)) * torch.sin(theta * (math.pi / 360.0))
    q1 = (0.0 * kth, -kth)
    b1 = (0.5 * SQ3 * kth, 1.5 * kth)
    b2 = (-0.5 * SQ3 * kth, 1.5 * kth)
    kx = kpts[:, 0] * b1[0] + kpts[:, 1] * b2[0]
    ky = kpts[:, 0] * b1[1] + kpts[:, 1] * b2[1]
    H = torch.zeros(K, n, n, dtype=cdt, device=kpts.device)
    index = {}
    for layer in (0, 1):
        for g, (m, p) in enumerate(gs):
            index[(layer, m, p)] = (layer * ng + g) * 2
            px = kx + m * b1[0] + p * b2[0] + (q1[0] if layer else 0.0)
            py = ky + m * b1[1] + p * b2[1] + (q1[1] if layer else 0.0)
            r = (layer * ng + g) * 2
            H[:, r, r + 1] = torch.complex(hbar_v * px, -hbar_v * py)
            H[:, r + 1, r] = torch.complex(hbar_v * px, hbar_v * py)
    # (layer 1, G) to (layer 2, G'), k + G + q_j = k + G' + q1: G' = G, G + b1, G + b2
    shifts = ((0, 0), (1, 0), (0, 1))
    for m, p in gs:
        r1 = index[(0, m, p)]
        for j, (dm, dp) in enumerate(shifts):
            r2 = index.get((1, m + dm, p + dp))
            if r2 is None:
                continue
            w = complex(math.cos(2 * math.pi * j / 3), math.sin(2 * math.pi * j / 3))
            T = ((u + 0j * u, up * w.conjugate()), (up * w, u + 0j * u))
            for s in (0, 1):
                for t in (0, 1):
                    H[:, r1 + s, r2 + t] = T[s][t]
                    H[:, r2 + t, r1 + s] = T[s][t].conj()
    return H


def derivatives(kpts, theta, hbar_v, a, cutoff):
    """(dH/dtheta, dH/du, dH/du') from :func:`hamiltonian`: H is linear in u
    and u', and its intralayer part, at fixed fractional k, is
    ``sin(theta / 2)`` times a matrix of theta alone."""
    zero = torch.zeros_like(theta)
    dtheta = (math.pi / 360.0) / torch.tan(theta * (math.pi / 360.0))
    return (dtheta * hamiltonian(kpts, theta, zero, zero, hbar_v, a, cutoff),
            hamiltonian(kpts, theta, zero + 1.0, zero, 0.0, a, cutoff),
            hamiltonian(kpts, theta, zero, zero + 1.0, 0.0, a, cutoff))


def flat_loss(evals):
    n = evals.shape[-1]
    return (evals[:, n // 2 - 1] ** 2 + evals[:, n // 2] ** 2).mean()


def _params(cfg, inputs, dtype):
    leaves = [inputs[k].detach().to(dtype).requires_grad_(True)
              for k in ("theta", "u", "u_prime")]
    return leaves, (cfg["hbar_v_over_a_eV"] * cfg["a_nm"], cfg["a_nm"], cfg["cutoff"])


@contextlib.contextmanager
def ieee_products():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def truth(cfg, inputs):
    """(H, eigenvalues, L, dL/d(theta, u, u'), and each derivative's scale
    ``mean_k 2 |H_k|_2 sum_b |dE_b/dp|`` over the flat pair b) in float64."""
    with ieee_products():
        leaves, (hv, a, cutoff) = _params(cfg, inputs, torch.float64)
        kpts = inputs["kpts"].detach().to(torch.float64)
        H = hamiltonian(kpts, *leaves, hv, a, cutoff)
        lam, X = torch.linalg.eigh(H)
        L = flat_loss(lam)
        grad = torch.stack(torch.autograd.grad(L, leaves))
        n = lam.shape[-1]
        V = X[..., n // 2 - 1:n // 2 + 1].detach()
        dH = derivatives(kpts, leaves[0].detach(), hv, a, cutoff)
        dE = torch.stack([(V.conj() * (D @ V)).sum(-2).real for D in dH])  # (3, K, 2)
        scale = (2.0 * lam.detach().abs().amax(-1) * dE.abs().sum(-1)).mean(-1)
    return H.detach(), lam.detach(), L.detach(), grad, scale


def judge(cfg, traffic, inputs, outputs):
    """``eval_err``: the widest ``|lam - lam*| / |H|_2``; ``flat_err``: the
    widest ``|lam - lam*|`` (eV) of the two flat bands; ``resid``: the
    widest ``|H x - lam x| / (|H|_2 |x|)``; ``orth``: the widest entry of
    ``|X^H X - I|``; ``grad_err``: the widest of the three derivatives'
    errors, each over its scale (:func:`truth`); over every k-point and
    band of the call."""
    H, ref, _, gref, scale = truth(cfg, inputs)
    n = ref.shape[-1]
    with ieee_products():
        norm = ref.abs().amax(-1)
        lam = outputs["evals"].detach().to(torch.float64)
        X = outputs["evecs"].detach().to(torch.complex128)
        err = (lam - ref).abs()
        flat = err[:, n // 2 - 1:n // 2 + 1].amax()
        eval_err = (err / norm[:, None]).amax()
        R = H @ X - X * lam[:, None, :]
        resid = (torch.linalg.vector_norm(R, dim=-2)
                 / (norm[:, None] * torch.linalg.vector_norm(X, dim=-2))).amax()
        del R
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        orth = (X.mH @ X - eye).abs().amax()
        g = outputs["grad"].detach().to(torch.float64)
        grad_err = ((g - gref).abs() / scale).amax()
    return {"eval_err": float(eval_err), "flat_err": float(flat), "resid": float(resid),
            "orth": float(orth), "grad_err": float(grad_err)}


def control(cfg, traffic, inputs):
    """The reference in the program's place at TF32: H built in float32
    and rounded to TF32, ``eigh`` in complex64 with TF32 products; L and
    its gradient through both, the rounding passed straight through."""
    leaves, (hv, a, cutoff) = _params(cfg, inputs, torch.float32)
    with tf32_products():
        H = hamiltonian(inputs["kpts"].detach().to(torch.float32), *leaves, hv, a, cutoff)
        re, im = round_tf32(H.real), round_tf32(H.imag)
        Hr = H + (torch.complex(re, im) - H).detach()
        lam, X = torch.linalg.eigh(Hr)
        L = flat_loss(lam)
        grad = torch.stack(torch.autograd.grad(L, leaves))
    return {"evals": lam.detach(), "evecs": X.detach(), "L": L.detach(), "grad": grad}
