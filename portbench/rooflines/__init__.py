"""Kernel counts: one module a kernel of the port, found by its file name.

Each module gives ``NAME_PART`` (a part of the kernel's symbol that no
other kernel's holds) and ``least_seconds(cfg, traffic, peaks)``: the
least time one launch on the cell's shapes could take on the card, the
larger of its bytes over the memory rate and its operations over the
IEEE float32 rate, and which of the two bounds it.
"""
