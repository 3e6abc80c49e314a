"""Row 5, the complex hermitian one-sided Jacobi sweep kernel
(``csrc/jacobi_sweep_complex.cu``), on packed planes ``[Re | Im]``.

The packed panels (B, n, 2 n) read once and written once, and the
operations of ``chip_smoke.py``'s row 5 bound (copied here), with W = 2 n
the packed width: per matrix the two reductions of every pair visit of
every round of every sweep (4 W operations), the phase and the rotation
on both planes of each rotation applied (11 W), and one hermitian gauge
(upper triangle, 4 W a pair) and norm refresh (2 W a row) before the
first sweep and after each.  n is the padded panel's (``jacobi_eigh``
pads to a multiple of 16).  The sweep and rotation counts are a constant
of the cell's data, frozen in ``jacobi_sweep_complex.<config>.json`` from
the count the plain sweep takes on the inputs of seed 0
(``portbench/tools/count_sweeps_complex.py``): they are never taken from a
run, so the bound stays the same whatever implements the kernel.

``NAME_PART`` holds both complex kernels' symbols
(``jacobi_sweep_complex_kernel``, ``jacobi_sweep_complex_cluster_kernel``)
and neither real one's; row 3's part, ``jacobi_sweep``, is a prefix of
these too.
"""
import json
import os

NAME_PART = "jacobi_sweep_complex"


def padded(n):
    return max(16, -(-n // 16) * 16)


def operations(B, n, sweeps_total, rotations_total):
    W = 2 * n
    rounds = -(-(n - 1) // 6) * 6
    return (sweeps_total * rounds * (n // 2) * 4 * W + rotations_total * 11 * W
            + (sweeps_total + B) * ((n * (n - 1) // 2) * 4 * W + n * 2 * W))


def frozen_operations(cfg, batch):
    """The operations of ``batch`` matrices of the configuration, from its
    frozen counts scaled to the batch."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "jacobi_sweep_complex.%s.json" % cfg["name"])) as f:
        counts = json.load(f)
    scale = batch / counts["batch"]
    return operations(batch, padded(cfg["n"]), counts["sweeps_total"] * scale,
                      counts["rotations_total"] * scale)


def least_seconds(cfg, traffic, peaks):
    B, n = traffic["systems"], padded(cfg["n"])
    t_bytes = 2 * B * n * (2 * n) * 4 / peaks["bytes_per_s"]
    t_ops = frozen_operations(cfg, B) / peaks["float32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
