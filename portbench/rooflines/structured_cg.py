"""Row 1, the structured CG kernel (``csrc/structured_cg.cu``).

Bytes the function needs, each input read once and the output written
once: d, V (K x n x r) and b in, x out: (3 + r) planes of K x n float32.
The coupling c is one scalar; the band planes the dispatcher builds from
it are the dispatcher's layout, not the function's input.  At config 3's
published K = 512 (r = 4) that is 14.7 MB, 0.0044 ms.
"""
NAME_PART = "structured_cg"


def least_seconds(cfg, traffic, peaks):
    K, n, r = traffic["systems"], cfg["n"], cfg["rank"]
    nbytes = (3 + r) * K * n * 4
    return nbytes / peaks["bytes_per_s"], "bytes"
