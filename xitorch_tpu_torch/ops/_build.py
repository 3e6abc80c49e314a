"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each source becomes one shared library with a plain C interface, built
for ``sm_90a`` (Hopper) at first use into ``xitorch_tpu_torch/_build/``
under a name keyed by a hash of the source and the compiler flags, and
loaded with :mod:`ctypes`.  A second process that finds the library built
loads it without compiling; two processes building at once each write a
private file and rename it into place.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc`` and never calls :func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Mapping, Sequence

__all__ = ["load", "build", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "kernels of xitorch_tpu_torch are compiled at first use")


def _library_path(name: str) -> str:
    """Path of the shared library built from ``csrc/<name>.cu``, keyed by
    the source, the headers beside it (``*.cuh``) and the flags."""
    src = b""
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(_CSRC, fname), "rb") as f:
            src += f.read()
    key = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD, "%s-%s.so" % (name, key))


def _start(name: str):
    out = _library_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [_nvcc(), *_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(out: str, job) -> str:
    if job is None:
        return out
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc failed (%d): %s\n%s"
                           % (proc.returncode, " ".join(cmd), log))
    os.replace(tmp, out)
    return out


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, one ``nvcc`` per source, all started
    together; return ``{name: library path}``.  Sources already built
    are not compiled again."""
    jobs = {name: _start(name) for name in names}
    return {name: _finish(*job) for name, job in jobs.items()}


def load(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """Load (building first if needed) the library of ``csrc/<name>.cu``.

    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns an ``int`` (a ``cudaError_t``).  Pointers and the stream must
    be declared ``ctypes.c_void_p``, or ctypes passes them as 32-bit ints.
    """
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d (the kernel was not launched or "
                           "failed to launch)" % (what, rc))
