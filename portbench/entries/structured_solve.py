"""``linalg.solve(A, b, method="structured_cg")`` on batches of
``TridiagLowRankOperator`` systems (BASELINE config 3's operator).

Traffic keys: ``systems`` (K, systems a call), ``lowrank`` (with V, the
structured CG kernel; without, the Thomas kernel), ``grad`` (the forward,
then ``torch.autograd.grad`` of ``(x w).sum()`` to d, V and b),
``input_sets``.
"""
import math

import torch

import xitorch_tpu_torch as xt
from xitorch_tpu_torch.ops import structured_cg, tridiag


class StructuredSolve:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg = cfg
        self.systems = K = int(traffic["systems"])
        n, r = cfg["n"], cfg["rank"]
        self.lowrank, self.grad = bool(traffic["lowrank"]), bool(traffic["grad"])
        dtype = getattr(torch, cfg["dtype"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.c = torch.tensor(cfg["coupling"], dtype=dtype, device=device)
        self.sets = []
        for _ in range(int(traffic["input_sets"])):
            s = {"d": cfg["diag_low"] + cfg["diag_width"]
                 * torch.rand(K, n, generator=gen, dtype=dtype, device=device)}
            if self.lowrank:
                s["V"] = torch.randn(K, n, r, generator=gen, dtype=dtype,
                                     device=device) / math.sqrt(n)
            s["b"] = torch.randn(K, n, 1, generator=gen, dtype=dtype, device=device)
            if self.grad:
                s["w"] = torch.randn(K, n, 1, generator=gen, dtype=dtype, device=device)
                for key in ("d", "V", "b"):
                    if key in s:
                        s[key].requires_grad_(True)
            self.sets.append(s)
        self.kernels = ["structured_cg"] if self.lowrank else ["thomas"]

    def call(self, s):
        inp = self.sets[s]
        A = xt.TridiagLowRankOperator(inp["d"], self.c, inp.get("V"))
        x = xt.linalg.solve(A, inp["b"], method=self.cfg["method"],
                            rtol=self.cfg["rtol"], atol=self.cfg["atol"])
        if not self.grad:
            return {"x": x}
        wrt = [inp["d"], inp["V"], inp["b"]] if self.lowrank else [inp["d"], inp["b"]]
        gs = torch.autograd.grad((x * inp["w"]).sum(), wrt)
        out = {"x": x.detach(), "gd": gs[0], "gb": gs[-1]}
        if self.lowrank:
            out["gV"] = gs[1]
        return out

    def launches(self):
        return structured_cg.structured_cg_cuda.launches + tridiag.thomas_cuda.launches


def make(cfg, traffic, seed, device):
    return StructuredSolve(cfg, traffic, seed, device)
