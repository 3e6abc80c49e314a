"""Kernels layer: row 2's share of its roofline (``rooflines/thomas.py``),
its least time over its device time by name, every launch counted."""


def read(obs):
    return obs.roofline_share("thomas")
