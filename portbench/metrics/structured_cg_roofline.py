"""Kernels layer: row 1's share of its roofline (``rooflines/structured_cg.py``),
its least time over its device time by name, every launch counted."""


def read(obs):
    return obs.roofline_share("structured_cg")
