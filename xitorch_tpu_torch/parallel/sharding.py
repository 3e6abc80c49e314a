"""Device-mesh and sharding helpers (counterpart of
xitorch_tpu/parallel/sharding.py), with one-device semantics.

The JAX package annotates arrays with a mesh layout and lets XLA lay the
collectives.  The port keeps one tensor on one device: a mesh here is the
devices laid out on named axes, factored as the JAX package factors them,
and a tensor can be placed on a mesh of one device only.  ``P``, ``Mesh``
and ``NamedSharding`` are small classes of the port's own with the JAX
names.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["make_mesh", "shard_batch", "with_batch_sharding", "P", "Mesh",
           "NamedSharding"]


class P(tuple):
    """A partition spec: for each dim, the mesh axis it is laid over (or
    None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P%s" % (tuple.__repr__(self),)


class Mesh:
    """Devices (``torch.device``) laid out on named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices) if isinstance(devices, np.ndarray)
                       else len(devices), dtype=object)
        arr[...] = devices if isinstance(devices, np.ndarray) else list(devices)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError("Mesh: %d axis names for a %d-d device array"
                             % (len(self.axis_names), arr.ndim))

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name to its number of devices."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return "Mesh(%s)" % ", ".join("%r: %d" % kv for kv in self.shape.items())


class NamedSharding:
    """A mesh and a partition spec over its axes."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dp", "tp"),
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a mesh over the available devices, factoring the device count
    into the given axes (last axis gets the smaller factor).  ``devices``
    defaults to the CUDA devices; with none and no ``devices`` it raises."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a mesh "
                               "over other devices")
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    naxes = len(axis_names)
    # factor n_devices into naxes axes, as square as possible
    shape = [1] * naxes
    rem = n_devices
    for i in range(naxes - 1):
        f = _largest_factor_leq(rem, int(round(rem ** (1.0 / (naxes - i)))))
        shape[i] = f
        rem //= f
    shape[-1] = rem
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def _largest_factor_leq(n: int, k: int) -> int:
    k = max(1, min(k, n))
    for f in range(k, 0, -1):
        if n % f == 0:
            return f
    return 1


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """Place a tensor with its leading (batch) dim over ``axis``: on a mesh of
    one device, the tensor on that device.  A mesh of more devices raises:
    the port keeps one tensor on one device."""
    if axis not in mesh.axis_names:
        raise ValueError("shard_batch: the mesh has no axis %r (axes %s)"
                         % (axis, mesh.axis_names))
    if mesh.size != 1:
        raise RuntimeError(
            "shard_batch: the port keeps one tensor on one device and cannot lay it "
            "over %r, which has %d devices on axis %r" % (mesh, mesh.shape[axis], axis))
    return x.to(mesh.devices.flat[0])


def with_batch_sharding(x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """Constraint form (leading dim over ``axis``): ``x`` itself, on one
    device."""
    return x
