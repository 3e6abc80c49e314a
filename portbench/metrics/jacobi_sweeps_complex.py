"""Kernels layer: row 5's sweeps, the mean over every matrix of the last
``COUNT_KEEP`` launches kept while a profiler recorded, from the
per-matrix counts the program keeps then
(``xitorch_tpu_torch.debug.profiling.counts``); None where the program
keeps none."""
from portbench import counts


def read(obs):
    return counts.mean_per_system("jacobi_sweep_complex")
