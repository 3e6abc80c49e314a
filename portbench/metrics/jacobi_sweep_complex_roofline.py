"""Kernels layer: row 5's share of its roofline
(``rooflines/jacobi_sweep_complex.py``, operations frozen from seed 0's
data), its least time over its device time by name, every launch
counted."""


def read(obs):
    return obs.roofline_share("jacobi_sweep_complex")
