"""Bistritzer-MacDonald continuum model of twisted bilayer graphene (one
valley, one spin): the Bloch Hamiltonians of a k-mesh of the moire
Brillouin zone and the gradient of the flat-band energy through
``linalg.symeig``.  Port-only: the JAX package has no counterpart.

R. Bistritzer and A. H. MacDonald, PNAS 108, 12233 (2011), in the
convention of G. Tarnopolsky, A. J. Kruchkov and A. Vishwanath, PRL 122,
106405 (2019):

* ``|K| = 4 pi / (3 a)``, ``k_theta = 2 |K| sin(theta / 2)``,
  ``q1 = k_theta (0, -1)``, ``q2 = k_theta (sqrt3/2, 1/2)``,
  ``q3 = k_theta (-sqrt3/2, 1/2)``; moire reciprocal vectors
  ``b1 = q2 - q1``, ``b2 = q3 - q1``;
* basis: layer 1 holds the momenta ``k + G``, layer 2 ``k + G + q1``,
  ``G = m b1 + p b2`` with ``|m|, |p|, |m + p| <= cutoff`` (m ascending,
  then p: ``3 cutoff (cutoff + 1) + 1`` of them), two sublattices each;
  state ``(layer, G, sublattice)`` is row ``(layer * NG + g) * 2 + s``, so
  ``n = 4 NG``;
* intralayer: ``hbar_v sigma.p`` of the layer's momentum, each measured
  from its own layer's Dirac point, with ``sigma.p = [[0, px - i py],
  [px + i py, 0]]``; the +-theta/2 rotation of the sigma matrices is left
  out (the usual small-angle simplification);
* interlayer: (layer 1, k + G) couples to (layer 2, k + G + q_j), j = 1,
  2, 3, wherever that momentum lies inside the cutoff, through
  ``T_j = [[u, u' w^-(j-1)], [u' w^(j-1), u]]``, ``w = exp(2 pi i / 3)``,
  and back through ``T_j^H``.

``flat_band_loss`` is the mean square energy of the two bands about
charge neutrality, ``L = mean_k (E_{n/2-1}(k)^2 + E_{n/2}(k)^2)``, a
symmetric function of the pair, so it stays differentiable where the two
touch; what a magic-angle search drives down.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from xitorch_tpu_torch._core.linop import LinearOperator
from xitorch_tpu_torch.linalg import symeig

__all__ = ["bm_hamiltonian", "flat_band_loss"]

_SQ3 = math.sqrt(3.0)


def _lattice(cutoff: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Index bookkeeping on the host (no device sync): (m, p) of the kept G
    (NG,) each in the basis order; the flat positions in an (n, n) matrix
    of the intralayer entries (4 NG: all [2i, 2i+1], then all [2i+1, 2i])
    and of the interlayer blocks (8 P: each T_j row-major, then the same
    positions transposed); and each block's coupling j (P,)."""
    r = torch.arange(-cutoff, cutoff + 1)
    m, p = torch.meshgrid(r, r, indexing="ij")
    keep = (m + p).abs() <= cutoff
    m, p = m[keep], p[keep]
    ng = m.numel()
    n = 4 * ng
    slot = torch.full((2 * cutoff + 3, 2 * cutoff + 3), -1, dtype=torch.long)
    slot[m + cutoff, p + cutoff] = torch.arange(ng)
    g1s, g2s, js = [], [], []
    # k + G + q_j = k + G' + q1: G' = G, G + b1, G + b2
    for j, (dm, dp) in enumerate(((0, 0), (1, 0), (0, 1))):
        g2 = slot[m + cutoff + dm, p + cutoff + dp]
        ok = g2 >= 0
        g1s.append(torch.arange(ng)[ok])
        g2s.append(g2[ok])
        js.append(torch.full((int(ok.sum()),), j))
    g1, g2, j = torch.cat(g1s), torch.cat(g2s), torch.cat(js)
    rows = 2 * torch.arange(2 * ng)
    intra_at = torch.cat([rows * n + rows + 1, (rows + 1) * n + rows])
    r1 = (2 * g1)[:, None] + torch.tensor([0, 0, 1, 1])
    r2 = (2 * (ng + g2))[:, None] + torch.tensor([0, 1, 0, 1])
    inter_at = torch.cat([(r1 * n + r2).reshape(-1), (r2 * n + r1).reshape(-1)])
    return m, p, intra_at, inter_at, j


def bm_hamiltonian(kpts: torch.Tensor, theta, u, u_prime, hbar_v: float, a: float,
                   cutoff: int) -> torch.Tensor:
    """The (K, n, n) hermitian Bloch Hamiltonians at ``kpts`` (K, 2),
    fractional coordinates on b1 and b2 (the mesh scales with theta), on
    the device and in the complex dtype of ``kpts`` (complex64 for
    float32).  ``theta`` in degrees, ``u`` (AA) and ``u_prime`` (AB) in eV,
    0-d tensors (or floats); differentiable in all three.  ``hbar_v`` in
    eV nm, ``a`` in nm.  Hermitian to the last bit."""
    dev, rdt = kpts.device, kpts.dtype
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    theta, u, u_prime = (torch.as_tensor(v, dtype=rdt, device=dev) for v in (theta, u, u_prime))
    m, p, intra_at, inter_at, j = _lattice(cutoff)
    ng = m.numel()
    n, K = 4 * ng, kpts.shape[0]
    kth = 2.0 * (4.0 * math.pi / (3.0 * a)) * torch.sin(theta * (math.pi / 360.0))
    # b1, b2 and q1 in units of k_theta; the G part of each momentum
    b1 = (0.5 * _SQ3, 1.5)
    b2 = (-0.5 * _SQ3, 1.5)
    mf, pf = m.to(torch.float64), p.to(torch.float64)
    gx = (mf * b1[0] + pf * b2[0]).to(device=dev, dtype=rdt)
    gy = (mf * b1[1] + pf * b2[1]).to(device=dev, dtype=rdt)
    fx = kpts[:, 0:1] * b1[0] + kpts[:, 1:2] * b2[0] + gx                          # (K, NG)
    fy = kpts[:, 0:1] * b1[1] + kpts[:, 1:2] * b2[1] + gy
    # layer 2: + q1 = (0, -1)
    px = hbar_v * kth * torch.cat([fx, fx], -1)                                   # (K, 2 NG)
    py = hbar_v * kth * torch.cat([fy, fy - 1.0], -1)
    intra = torch.cat([torch.complex(px, -py), torch.complex(px, py)], -1)       # (K, 4 NG)
    H = torch.zeros(K, n * n, dtype=cdt, device=dev).index_add(1, intra_at.to(dev), intra)
    # interlayer blocks, the same at every k
    ang = ((2.0 * math.pi / 3.0) * j.to(torch.float64)).to(device=dev, dtype=rdt)
    w = torch.complex(torch.cos(ang), torch.sin(ang))                            # w^(j-1)
    uc = torch.complex(u, torch.zeros_like(u)).expand(w.shape)
    vals = torch.stack([uc, u_prime * w.conj(), u_prime * w, uc], -1)            # T_j, row-major
    inter = torch.zeros(n * n, dtype=cdt, device=dev).index_add(
        0, inter_at.to(dev), torch.cat([vals.reshape(-1), vals.conj().reshape(-1)]))
    return (H + inter).reshape(K, n, n)


def flat_band_loss(kpts: torch.Tensor, theta, u, u_prime, hbar_v: float, a: float,
                   cutoff: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(L, evals (K, n), evecs (K, n, n))``: the Hamiltonians of
    :func:`bm_hamiltonian`, all n eigenpairs by the public ``symeig``
    (``exacteig``: on the card the complex Jacobi sweep kernel, with the
    degeneracy-safe gradient), and the flat-band energy
    ``L = mean_k (E_{n/2-1}^2 + E_{n/2}^2)`` (eV^2)."""
    H = bm_hamiltonian(kpts, theta, u, u_prime, hbar_v, a, cutoff)
    n = H.shape[-1]
    evals, evecs = symeig(LinearOperator.m(H, is_hermitian=True), neig=n, mode="lowest",
                          method="exacteig")
    L = (evals[:, n // 2 - 1] ** 2 + evals[:, n // 2] ** 2).mean()
    return L, evals, evecs
