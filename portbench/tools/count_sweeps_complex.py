"""Freeze the sweep and rotation counts behind row 5's roofline.

    python3 portbench/tools/count_sweeps_complex.py --config tbg_bm_n244 \
        --traffic kmesh1024_flatband_grad

On the card: draws input set 0 of seed 0 as a run does, builds its
Hamiltonians, shifts, pads and packs them as ``jacobi_eigh`` does for
complex input, and runs the port's plain sweep
(``jacobi_sweep_plain(..., complexpair=True)``) on the panel, counting the
pairs it rotates; prints the JSON object that
``portbench/rooflines/jacobi_sweep_complex.<config>.json`` holds, with the
kernel's own counts on the same panel beside it for comparison.  Not run
by the benchmark: its runs read the frozen file.
"""
import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import harness
    from xitorch_tpu_torch.models import moire
    from xitorch_tpu_torch.ops import jacobi_eigh as je

    here = harness.HERE
    cfg = harness.load_json(os.path.join(here, "configs", args.config + ".json"))
    traffic = harness.load_json(os.path.join(here, "traffic", args.traffic + ".json"))
    entry = harness.importlib.import_module("portbench.entries." + traffic["entry"])
    inp = entry.make(cfg, traffic, 0, torch.device("cuda")).sets[0]
    with torch.no_grad():
        H = moire.bm_hamiltonian(inp["kpts"], inp["theta"], inp["u"], inp["u_prime"],
                                 cfg["hbar_v_over_a_eV"] * cfg["a_nm"], cfg["a_nm"],
                                 cfg["cutoff"])
    B, n = H.shape[0], H.shape[-1]
    npad = je._padded_n(n)
    a = je._shift_pad(H, npad)
    panel = torch.cat([a.real, -a.imag], dim=-1).contiguous()
    tol = float(torch.finfo(torch.float32).eps) * 4.0 * math.sqrt(n)
    live = {"rotations": 0}
    rot_coeffs = je._rot_coeffs

    def counting(*a, **k):
        c, s, lv = rot_coeffs(*a, **k)
        live["rotations"] += int(lv.sum())
        return c, s, lv

    je._rot_coeffs = counting
    _, sweeps = je.jacobi_sweep_plain(panel, 18, tol, complexpair=True)
    je._rot_coeffs = rot_coeffs
    _, ksweeps, _, krot = je.jacobi_sweep_cuda(panel, 18, tol, return_stats=True,
                                               complexpair=True)
    print(json.dumps({"config": args.config, "seed": 0, "input_set": 0, "batch": B, "n": n,
                      "padded_n": npad, "tol": tol, "max_sweeps": 18,
                      "sweeps_total": int(sweeps.sum()), "rotations_total": live["rotations"],
                      "kernel_sweeps_total": int(ksweeps.sum()),
                      "kernel_rotations_total": int(krot.sum())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
