"""Row 2, the Thomas kernel (``csrc/tridiag.cu``).

Bytes the function needs, each input read once and the output written
once: d and the right-hand side in, x out: 3 planes of K x n float32.  The
coupling c is one scalar; the off-diagonal planes the dispatcher builds
from it are the dispatcher's layout, not the function's input.  At
K = 512, n = 1024 that is 6.3 MB, 0.0019 ms.
"""
NAME_PART = "thomas_kernel"


def least_seconds(cfg, traffic, peaks):
    K, n = traffic["systems"], cfg["n"]
    nbytes = 3 * K * n * 4
    return nbytes / peaks["bytes_per_s"], "bytes"
