"""``linalg.symeig(A, neig, mode, method=...)`` on a batch of dense SPD
matrices (BASELINE config 2's workload).

Traffic keys: ``systems`` (matrices a call), ``input_sets``.
"""
import math

import torch

import xitorch_tpu_torch as xt
from xitorch_tpu_torch.ops import jacobi_eigh


class DenseSymeig:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg = cfg
        self.systems = B = int(traffic["systems"])
        n = cfg["n"]
        dtype = getattr(torch, cfg["dtype"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        eye = torch.eye(n, dtype=torch.float64, device=device)
        self.sets = []
        for _ in range(int(traffic["input_sets"])):
            a = torch.randn(B, n, n, generator=gen, dtype=torch.float64,
                            device=device) / math.sqrt(n)
            m = a @ a.mT + 2.0 * eye
            m = 0.5 * (m + m.mT)  # symmetric to the last bit
            self.sets.append({"A": m.to(dtype)})
        self.kernels = ["jacobi_sweep"]

    def call(self, s):
        A = xt.LinearOperator.m(self.sets[s]["A"], is_hermitian=True)
        evals, evecs = xt.linalg.symeig(A, self.cfg["neig"], self.cfg["mode"],
                                        method=self.cfg["method"])
        return {"evals": evals, "evecs": evecs}

    def launches(self):
        return jacobi_eigh.jacobi_sweep_cuda.launches


def make(cfg, traffic, seed, device):
    return DenseSymeig(cfg, traffic, seed, device)
