"""Row 3, the real one-sided Jacobi sweep kernel (``csrc/jacobi_sweep.cu``).

The panels (B, n, n) read once and written once, and the operations of
``chip_smoke.py::sweep_bound`` (copied here): per matrix the pair dots of
every round of every sweep (2 n operations each), 8 n a rotation applied,
and one gauge (upper triangle) and norm refresh before the first sweep and
after each.  The sweep and rotation counts are a constant of the cell's
data, frozen in ``jacobi_sweep.<config>.json`` from the count the plain
sweep takes on the inputs of seed 0 (``portbench/tools/count_sweeps.py``):
they are never taken from a run, so the bound stays the same whatever
implements the kernel.
"""
import json
import os

NAME_PART = "jacobi_sweep"


def operations(B, n, sweeps_total, rotations_total):
    rounds = -(-(n - 1) // 6) * 6
    return (sweeps_total * rounds * (n // 2) * 2 * n + rotations_total * 8 * n
            + (sweeps_total + B) * (n * (n - 1) // 2 + n) * 2 * n)


def frozen_operations(cfg, batch):
    """The operations of ``batch`` matrices of the configuration, from its
    frozen counts scaled to the batch."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jacobi_sweep.%s.json" % cfg["name"])) as f:
        counts = json.load(f)
    scale = batch / counts["batch"]
    return operations(batch, cfg["n"], counts["sweeps_total"] * scale,
                      counts["rotations_total"] * scale)


def least_seconds(cfg, traffic, peaks):
    B, n = traffic["systems"], cfg["n"]
    t_bytes = 2 * B * n * n * 4 / peaks["bytes_per_s"]
    t_ops = frozen_operations(cfg, B) / peaks["float32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
