"""``models.flat_band_loss`` and its gradient on a k-mesh of the moire
Brillouin zone of twisted bilayer graphene (the Bistritzer-MacDonald
continuum model): one call builds the Bloch Hamiltonians, takes all n
eigenpairs through ``linalg.symeig`` (exacteig), forms the flat-band
energy L and ``torch.autograd.grad`` of L to (theta, u, u').

Traffic keys: ``systems`` (k-points a call, a square mesh), ``input_sets``
(each its own seeded offset of the mesh inside one mesh cell, and its own
theta, u and u' drawn within ``spread`` of the configuration's values),
``spread``.
"""
import math

import torch

from xitorch_tpu_torch.models import moire
from xitorch_tpu_torch.ops import jacobi_eigh

PARAMS = (("theta", "theta_deg"), ("u", "u_eV"), ("u_prime", "u_prime_eV"))


class MoireBands:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg = cfg
        self.systems = K = int(traffic["systems"])
        side = math.isqrt(K)
        if side * side != K:
            raise SystemExit("moire_bands: systems must be a square mesh, got %d" % K)
        dtype = getattr(torch, cfg["dtype"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        spread = float(traffic["spread"])
        grid = torch.arange(side, dtype=torch.float64, device=device)
        f1, f2 = torch.meshgrid(grid, grid, indexing="ij")
        mesh = torch.stack([f1, f2], -1).reshape(K, 2)
        self.hbar_v = cfg["hbar_v_over_a_eV"] * cfg["a_nm"]
        self.sets = []
        for _ in range(int(traffic["input_sets"])):
            offset = torch.rand(2, generator=gen, dtype=torch.float64, device=device)
            draw = 1.0 + spread * (2.0 * torch.rand(3, generator=gen, dtype=torch.float64,
                                                    device=device) - 1.0)
            s = {"kpts": ((mesh + offset) / side).to(dtype)}
            for (key, name), d in zip(PARAMS, draw):
                s[key] = (cfg[name] * d).to(dtype).requires_grad_(True)
            self.sets.append(s)
        self.kernels = ["jacobi_sweep_complex"]

    def call(self, s):
        inp = self.sets[s]
        wrt = [inp[key] for key, _ in PARAMS]
        L, evals, evecs = moire.flat_band_loss(inp["kpts"], *wrt, self.hbar_v,
                                               self.cfg["a_nm"], self.cfg["cutoff"])
        grad = torch.stack(torch.autograd.grad(L, wrt))
        return {"evals": evals.detach(), "evecs": evecs.detach(), "L": L.detach(),
                "grad": grad}

    def launches(self):
        return jacobi_eigh.jacobi_sweep_cuda.launches_complex


def make(cfg, traffic, seed, device):
    return MoireBands(cfg, traffic, seed, device)
