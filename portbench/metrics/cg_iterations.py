"""Kernels layer: row 1's CG iterations, the mean over every system of the
last ``COUNT_KEEP`` launches kept while a profiler recorded, from the
per-system counts the program keeps then
(``xitorch_tpu_torch.debug.profiling.counts``)."""
from portbench import counts


def read(obs):
    return counts.mean_per_system("structured_cg")
