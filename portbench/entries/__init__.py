"""Drivers of the port's public entries, one module an entry, found by the
``entry`` key of a traffic file.

Each module's ``make(cfg, traffic, seed, device)`` draws the cell's inputs
from the seed on the device and returns an object with:

* ``systems``: systems (or matrices) a call;
* ``sets``: the input sets, each a dict of tensors, used in turn;
* ``call(s)``: one call of the public entry on input set ``s``, returning
  its outputs as a dict of tensors, without a synchronise;
* ``launches()``: the port's kernel launch counters, summed;
* ``kernels``: the kernel count modules (``portbench/rooflines/``) whose
  kernels a call launches.
"""
