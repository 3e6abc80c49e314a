"""Fused conjugate-gradient solve for explicit batched A (counterpart of
xitorch_tpu/ops/fused_cg.py).

The matrix-free ``cg`` of ``_impls/linalg/solve.py`` is a Python loop: a
dozen small launches and one host synchronisation per step, so the card
idles most of the time.  The kernel in ``csrc/fused_cg.cu`` runs the whole
iteration (unpreconditioned CG from x0 = 0) in one launch.

The reference kernel rests on A living in on-chip memory; here a batch of A
(64 x 700^2 float32, 125 MB) exceeds the card's shared memory and L2, so A
is streamed from device memory on every step.  What carries is the point:
one read of A serves as many columns as possible, and no host round trip
inside the iteration.

**Designs** (:func:`choose_design`, recorded in
``fused_cg_cuda.last_design``).  The cluster path: a thread-block cluster
of C CTAs a system (or a super-group of W of its columns where there are
more than C CTAs of at most 32 float32 / 16 float64 columns hold), each CTA
owning about W / C columns; A streams in bands of rows by bulk copies,
multicast to the cluster, into a ring of S stages that a loading warp of
rank 0 refills once every computing warp of the cluster has released a
stage; the 8 computing warps of a CTA split its columns into groups of at
most 8 (and, where the ring needs smaller bands, k into halves), each warp
keeping 8 rows x its columns of sums in registers; P and A P live in
shared memory, r and x too where they fit (else in a device-memory
scratch).  The chooser takes, for each C, the widest super-group whose
state and ring fit a CTA's shared memory (:func:`ring_plan`), asks the
card's occupancy query how many such clusters it holds at once, and picks
the least ``waves x CTAs an SM x max(columns a CTA, 4)`` (below about 4
columns a CTA waits on A's bytes rather than on its multiply-adds: on an
H100 the grid's single systems ran fastest on 13 to 16 CTAs of 4 columns),
then the fewest super-groups, then the smallest C.  The device-memory path
(a block a system and a group of G columns, all CG state in
shared memory, A read by every block from L2 / device memory) takes only
the shapes where no cluster design fits: n > 3,124 float32, n > 1,518
float64.  An odd n runs the cluster path on a copy of A with rows padded
to ``lda`` (16-byte aligned bands).

**Window** (:func:`fits_fused_cg`), from the device-memory path's layout,
the larger of the two: one column's state is ``4 n`` elements, so a shape
fits when ``4 * n * itemsize + 4096`` (its reduction scratch, rounded up)
is at most the 232,448 bytes a Hopper block may opt in to: n <= 14,272 in
float32, n <= 7,136 in float64 (the card has float64 units, so both are
instantiated).  Complex stays outside.

**Stop rule.**  The reference stops a system when the maximum over ALL its
columns of ``sqrt(r.r) / max(rtol |b|, atol)`` drops below 1.  Where one
cluster holds all of a system's columns (``CGDesign.group >= ncols``; up to
16 CTAs of 32 float32 / 16 float64 columns, fewer where n is large) the
kernel applies that joint rule; elsewhere it is
applied per stop group (a super-group, or a group of the device-memory
path), which changes only how far already-converged columns are polished.
:func:`fused_cg_plain` has both (``group=None`` is the reference's, an int
the groups of that many consecutive columns; ``CGDesign.group`` is the
kernel's).

On a CUDA tensor :func:`fused_cg_dense` launches the kernel
(:func:`fused_cg_cuda`) or raises; on a CPU tensor it runs
:func:`fused_cg_plain` with the reference's joint rule.  The public entry is
``xitorch_tpu_torch.linalg.solve(A, B, method="fused_cg")``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.ops.tridiag import check_device
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["fused_cg_dense", "fused_cg_cuda", "fused_cg_plain", "fits_fused_cg",
           "choose_design", "ring_plan", "cluster_smem_bytes", "lda_for", "min_col_groups",
           "CGDesign"]

# Hopper (sm_90): a block may opt in to 227 KB of dynamic shared memory; the
# device-memory path also holds up to 1 KB of static reduction scratch
_SMEM_OPTIN = 232448
_SMEM_STATIC = 4096
_DM_MAX_GROUP = 8    # the largest instantiation of the device-memory path
# the cluster path (csrc/fused_cg.cu): cluster sizes, columns a CTA by
# itemsize, ring stages, the header of its shared memory (mbarriers, the
# decision values, the per-column scalars), and the columns a CTA below
# which it waits on A's bytes rather than on its FMA units
_MAX_CLUSTER = 16
_MAX_COLS = {4: 32, 8: 16}
_MAX_STAGES = 4
_HEADER_BYTES = 8 * (2 * _MAX_STAGES + 2) + 8 * 2 * _MAX_CLUSTER + 8 * 4 * 32 + 16
_INBOUND_COLS = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGS = [_P] * 5 + [_I] * 5 + [_D] * 3 + [_P]
_CLUSTER_ARGS = [_P] * 6 + [_I] * 13 + [_D] * 3 + [_P]
_SIGNATURES = {"fused_cg_f32": _ARGS, "fused_cg_f64": _ARGS,
               "fused_cg_cluster_f32": _CLUSTER_ARGS, "fused_cg_cluster_f64": _CLUSTER_ARGS,
               "fused_cg_cluster_occupancy": [_I] * 9 + [_P]}


class CGDesign(NamedTuple):
    """How a launch splits its work.  ``cluster``: CTAs a cluster (0: the
    device-memory path); ``cols``: the most columns a CTA (block) owns;
    ``group``: columns a stop group (a cluster's super-group, or a
    device-memory block's group; the last one may be smaller);
    ``cgroups``: column groups of a band's 8 warps; ``khalves``: the halves
    of k they split into (bands of 64 / (cgroups khalves) rows, 8 rows a
    warp);
    ``stages``: ring stages; ``rx``: r and x in shared memory; ``lda``:
    the row stride of A the kernel reads."""
    cluster: int
    cols: int
    group: int
    cgroups: int = 0
    khalves: int = 0
    stages: int = 0
    rx: int = 0
    lda: int = 0

    def groups(self, ncols: int) -> int:
        return -(-ncols // self.group)

    def cta_columns(self, ncols: int):
        """Columns each CTA (block) multiplies, stop group by stop group, as
        the kernel splits them: a super-group of w columns over C CTAs gives
        rank c the columns ``floor(c w / C) .. floor((c + 1) w / C) - 1``."""
        out = []
        for lo in range(0, ncols, self.group):
            w = min(self.group, ncols - lo)
            if not self.cluster:
                out.append([w])
                continue
            out.append([(c + 1) * w // self.cluster - c * w // self.cluster
                        for c in range(self.cluster)])
        return out


def _itemsize(dtype) -> int:
    return 4 if dtype == torch.float32 else 8


def _state_fits(n: int, group: int, itemsize: int) -> bool:
    return 4 * group * n * itemsize + _SMEM_STATIC <= _SMEM_OPTIN


def fits_fused_cg(n: int, ncols: int, dtype) -> bool:
    """Whether the kernel takes an (n, n) system with ``ncols`` right-hand
    sides: float32 or float64, and one column's CG state (x, r, p, A p)
    fits one block's shared memory (the device-memory path's window, which
    holds the cluster path's)."""
    if dtype not in (torch.float32, torch.float64):
        return False
    return n >= 1 and ncols >= 1 and _state_fits(n, 1, _itemsize(dtype))


def lda_for(n: int, itemsize: int) -> int:
    """Row stride of A on the cluster path: n where n is even, else n
    rounded up so that every band starts and ends on 16 bytes."""
    if n % 2 == 0:
        return n
    return -(-n // 4) * 4 if itemsize == 4 else n + 1


def min_col_groups(cols: int) -> int:
    """The fewest column groups (1, 2, 4, 8) a band's 8 warps split a CTA's
    columns into, so that a warp carries at most 8 of them
    (``min_col_groups`` in ``csrc/fused_cg.cu``)."""
    c = 1
    while c * 8 < cols:
        c *= 2
    return c


def cluster_smem_bytes(n: int, lda: int, cols: int, cgroups: int, khalves: int, stages: int,
                       rx: int, itemsize: int) -> int:
    """Shared memory of one CTA of the cluster path (``cluster_smem_bytes``
    in ``csrc/fused_cg.cu``): the header, the warps' p.q parts and the sums
    the k halves exchange (1,536 values), P and A P (cols x np, np = n
    rounded up to 16 bytes), with ``rx`` also r and x, and the ring of
    ``stages`` bands of 64 / (cgroups khalves) rows of ``lda``."""
    vk = 16 // itemsize
    np_ = -(-n // vk) * vk
    return _HEADER_BYTES + itemsize * (3 * 512 + (2 + 2 * rx) * cols * np_
                                       + stages * (64 // (cgroups * khalves)) * lda)


def ring_plan(n: int, cols: int, itemsize: int, smem_block: int = _SMEM_OPTIN
              ) -> Optional[Tuple[int, int, int, int]]:
    """``(cgroups, khalves, stages, rx)`` of the cluster path for CTAs of
    ``cols`` columns at size n, or None where nothing fits ``smem_block``.
    The fewest column groups (the widest warps, up to 8 columns), each
    warp on all of k (``khalves`` 1) or on half of it (2, its sums added to
    the other half's: half the rows a band), then more groups, until two
    stages fit (or one, where a band holds the whole matrix), r and x on
    chip where that still fits; stages as many as fit, at most 4 and at
    most the bands of a step."""
    lda = lda_for(n, itemsize)
    cg = min_col_groups(cols)
    while cg <= 8:
        for kh in (1, 2):
            if cg * kh > 8:
                continue
            nbands = -(-n // (64 // (cg * kh)))
            for rx in (1, 0):
                for st in range(min(_MAX_STAGES, nbands), 0, -1):
                    if cluster_smem_bytes(n, lda, cols, cg, kh, st, rx, itemsize) <= smem_block:
                        break
                else:
                    st = 0
                if st >= min(2, nbands):
                    return cg, kh, st, rx
        cg *= 2
    return None


def _dm_group(nb: int, n: int, ncols: int, itemsize: int, sm_count: int) -> int:
    """Columns a block owns on the device-memory path: the largest of 8, 4,
    2, 1 whose state fits, then halved while the launch would have fewer
    blocks than the card has SMs or half the group would already hold every
    column."""
    g = _DM_MAX_GROUP
    while g > 1 and (not _state_fits(n, g, itemsize) or g // 2 >= ncols
                     or nb * -(-ncols // g) < sm_count):
        g //= 2
    return g


def choose_design(nb: int, n: int, ncols: int, dtype, sm_count: int,
                  smem_block: int = _SMEM_OPTIN,
                  active_clusters: Optional[Callable[[CGDesign], int]] = None,
                  cluster: Optional[int] = None) -> CGDesign:
    """The design of a launch for ``nb`` systems of size n with ``ncols``
    right-hand sides (see the module docstring).  ``active_clusters(d)``
    is the card's occupancy query for a cluster design (without it: one CTA
    an SM).  ``cluster`` forces clusters of that many CTAs (0: the
    device-memory path), for measuring; raises where it does not fit.
    Shapes only, so a CPU test can ask it."""
    itemsize = _itemsize(dtype)
    best = None
    sizes = range(1, min(_MAX_CLUSTER, ncols) + 1) if cluster is None else (
        [cluster] if cluster else [])
    for c in sizes:
        cols = min(_MAX_COLS[itemsize], -(-ncols // c))
        while cols >= 1 and ring_plan(n, cols, itemsize, smem_block) is None:
            cols -= 1
        if cols < 1 or c > ncols:
            continue
        nsg = -(-ncols // (c * cols))
        width = -(-ncols // nsg)
        cols = -(-width // c)
        cgroups, khalves, stages, rx = ring_plan(n, cols, itemsize, smem_block)
        d = CGDesign(c, cols, width, cgroups, khalves, stages, rx, lda_for(n, itemsize))
        clusters = nb * d.groups(ncols)
        held = active_clusters(d) if active_clusters is not None else sm_count // c
        if held < 1:
            continue
        waves = -(-clusters // held)
        per_sm = max(1, -(-min(clusters, held) * c // sm_count))
        key = (waves * per_sm * max(cols, _INBOUND_COLS), d.groups(ncols), c)
        if best is None or key < best[0]:
            best = (key, d)
    if best is not None:
        return best[1]
    if cluster:
        raise RuntimeError("fused_cg_cuda: no design on clusters of %d CTAs fits n=%d, "
                           "ncols=%d, %s in %d bytes a block"
                           % (cluster, n, ncols, dtype, smem_block))
    g = _dm_group(nb, n, ncols, itemsize, sm_count)
    if not _state_fits(n, g, itemsize):
        raise RuntimeError("fused_cg_cuda: n=%d, %s does not fit the kernel" % (n, dtype))
    return CGDesign(0, g, g)


def fused_cg_plain(A: torch.Tensor, B: torch.Tensor, *, rtol: float, atol: float,
                   max_niter: int, eps: float = 1e-12,
                   group: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: A (nb, n, n), B (nb, n, nc).
    The same loop, zero-denominator rule and stop rule: each group of
    ``group`` consecutive columns of a system runs while any of its columns
    has ``sqrt(r.r) / max(rtol |b|, atol) >= 1``; a group that has stopped
    is frozen by a mask, so its iterate is the one the kernel returns.
    ``group=None`` is one group of all the columns, the reference's rule.
    Returns ``(x, steps)`` with steps (nb, ngroups) int32."""
    nb, n, nc = B.shape
    group = nc if group is None else int(group)
    ngroups = -(-nc // group)

    def colsum(a):
        return a.sum(-2, keepdim=True)  # (nb, 1, nc)

    def group_any(flag):
        # (nb, 1, nc) bool: true for every column of a group that holds one
        pad = torch.zeros((nb, ngroups * group - nc), dtype=torch.bool, device=B.device)
        per_group = torch.cat([flag[:, 0], pad], -1).reshape(nb, ngroups, group).any(-1)
        return per_group, per_group.repeat_interleave(group, -1)[:, None, :nc]

    stop = torch.clamp(rtol * torch.sqrt(colsum(B * B)), min=atol)
    x = torch.zeros_like(B)
    r = B.clone()
    p = B.clone()
    rr = colsum(r * r)
    it = torch.zeros((nb, ngroups), dtype=torch.int32, device=B.device)
    for _ in range(max_niter):
        per_group, active = group_any(torch.sqrt(rr) / stop >= 1.0)
        if not bool(per_group.any()):
            break
        Ap = dot_hi(A, p)
        pAp = colsum(p * Ap)
        alpha = rr / torch.where(pAp == 0, eps, pAp)
        r_new = r - alpha * Ap
        rr_new = colsum(r_new * r_new)
        beta = rr_new / torch.where(rr == 0, eps, rr)
        x = torch.where(active, x + alpha * p, x)
        p = torch.where(active, r_new + beta * p, p)
        r = torch.where(active, r_new, r)
        rr = torch.where(active, rr_new, rr)
        it = it + per_group.to(torch.int32)
    return x, it


def _card_limits(device) -> Tuple[int, int]:
    """(SM count, shared memory a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            int(getattr(props, "shared_memory_per_block_optin", _SMEM_OPTIN)))


_ACTIVE_CLUSTERS = {}
_DESIGNS = {}  # (device, nb, n, nc, dtype, cluster) -> (design, waves)


def _active_clusters(lib, device, n: int, itemsize: int, d: CGDesign) -> int:
    """The card's occupancy query: how many clusters of design ``d`` it
    holds at once at size n (cached)."""
    key = (device.index, n, itemsize, d)
    if key not in _ACTIVE_CLUSTERS:
        out = ctypes.c_int(0)
        _build.check(lib.fused_cg_cluster_occupancy(itemsize, n, d.lda, d.cluster, d.cols,
                                                    d.cgroups, d.khalves, d.stages, d.rx,
                                                    ctypes.addressof(out)),
                     "fused_cg_cuda: cluster occupancy query")
        _ACTIVE_CLUSTERS[key] = out.value
    return _ACTIVE_CLUSTERS[key]


def _design(nb: int, n: int, nc: int, dtype, device, cluster: Optional[int] = None
            ) -> Tuple[CGDesign, int]:
    """The kernel's design on this CUDA device for nb systems of n with nc
    columns (:func:`choose_design`, cached by shape) and the waves of
    clusters the card runs it in (0 on the device-memory path)."""
    lib = _build.load("fused_cg", _SIGNATURES)
    itemsize = dtype.itemsize
    with torch.cuda.device(device):
        dev = torch.device("cuda", torch.cuda.current_device())
        key = (dev.index, nb, n, nc, dtype, cluster)
        if key not in _DESIGNS:
            sms, smem = _card_limits(dev)
            d = choose_design(nb, n, nc, dtype, sms, smem,
                              lambda dd: _active_clusters(lib, dev, n, itemsize, dd), cluster)
            held = _active_clusters(lib, dev, n, itemsize, d) if d.cluster else 0
            if d.cluster and held < 1:
                raise RuntimeError("fused_cg_cuda: the card cannot schedule a cluster of %d "
                                   "CTAs for %s" % (d.cluster, d))
            _DESIGNS[key] = (d, -(-nb * d.groups(nc) // held) if d.cluster else 0)
        return _DESIGNS[key]


def fused_cg_cuda(A: torch.Tensor, a_idx: torch.Tensor, B: torch.Tensor, *,
                  rtol: float, atol: float, max_niter: int, eps: float = 1e-12,
                  cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: A (nA, n, n) and B (nb, n, nc) contiguous CUDA
    tensors of one dtype (float32 or float64), ``a_idx`` (nb,) int64 the
    index into A of each system's matrix.  The design comes from
    :func:`choose_design` (the card's SM count, shared memory and occupancy
    query; cached by shape) and is recorded in ``fused_cg_cuda.last_design``
    (and the waves of clusters the card runs it in, ``last_waves``, 0 on
    the device-memory path); ``cluster`` forces clusters of that many CTAs
    (0: the device-memory path), for measuring.  Returns ``(x, steps)``
    with steps (nb, groups) int32, the steps of each stop group
    (``last_design.groups(nc)`` a system).  A design the card cannot
    schedule, or a launch it refuses, raises."""
    if B.dim() != 3 or A.dim() != 3:
        raise RuntimeError("fused_cg_cuda: A must be (nA, n, n) and B (nb, n, nc)")
    nb, n, nc = B.shape
    nA = A.shape[0]
    for t, shape, dtype in ((A, (nA, n, n), B.dtype), (B, (nb, n, nc), B.dtype),
                            (a_idx, (nb,), torch.int64)):
        if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != B.device:
            raise RuntimeError(
                "fused_cg_cuda: expected contiguous CUDA tensors A (nA, n, n) and "
                "B (nb, n, nc) of one dtype and a_idx (nb,) int64, on one device")
    if nb == 0 or nA == 0 or not fits_fused_cg(n, nc, B.dtype):
        raise RuntimeError("fused_cg_cuda: nb=%d, n=%d, ncols=%d, %s does not fit the "
                           "kernel" % (nb, n, nc, B.dtype))
    itemsize = B.element_size()
    lib = _build.load("fused_cg", _SIGNATURES)
    x = torch.empty_like(B)
    with torch.cuda.device(B.device):
        d, waves = _design(nb, n, nc, B.dtype, B.device, cluster)
        fused_cg_cuda.last_design, fused_cg_cuda.last_waves = d, waves
        it = torch.empty((nb, d.groups(nc)), dtype=torch.int32, device=B.device)
        stream = torch.cuda.current_stream().cuda_stream
        common = (int(max_niter), float(rtol), float(atol), float(eps), stream)
        if d.cluster:
            Aw = F.pad(A, (0, d.lda - n)).contiguous() if d.lda != n else A
            ws = x if d.rx else torch.empty((2, nb, nc, n), dtype=B.dtype, device=B.device)
            fn = lib.fused_cg_cluster_f32 if itemsize == 4 else lib.fused_cg_cluster_f64
            rc = fn(Aw.data_ptr(), a_idx.data_ptr(), B.data_ptr(), x.data_ptr(),
                    ws.data_ptr(), it.data_ptr(), nb, n, nc, d.lda, d.cluster, d.group,
                    d.groups(nc), d.cols, d.cgroups, d.khalves, d.stages, d.rx, *common)
        else:
            fn = lib.fused_cg_f32 if itemsize == 4 else lib.fused_cg_f64
            rc = fn(A.data_ptr(), a_idx.data_ptr(), B.data_ptr(), x.data_ptr(),
                    it.data_ptr(), nb, n, nc, d.cols, *common)
    _build.check(rc, "fused_cg_cuda")
    fused_cg_cuda.launches += 1
    return x, it


fused_cg_cuda.launches = 0
fused_cg_cuda.last_design = None
fused_cg_cuda.last_waves = None


@torch.library.custom_op("xitorch_tpu_torch::fused_cg", mutates_args=(), device_types="cpu")
def _fused_cg_op(A: torch.Tensor, a_idx: torch.Tensor, B: torch.Tensor, rtol: float,
                 atol: float, max_niter: int, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense CG solve as an operator, ``(x, steps)``: :func:`fused_cg_cuda`
    on CUDA tensors, :func:`fused_cg_plain` (one stop group a system) on CPU
    tensors, so that ``torch.export`` can trace through a launch."""
    return fused_cg_plain(A[a_idx], B, rtol=rtol, atol=atol, max_niter=max_niter, eps=eps)


@_fused_cg_op.register_kernel("cuda")
def _(A, a_idx, B, rtol, atol, max_niter, eps):
    return fused_cg_cuda(A, a_idx, B, rtol=rtol, atol=atol, max_niter=max_niter, eps=eps)


@_fused_cg_op.register_fake
def _(A, a_idx, B, rtol, atol, max_niter, eps):
    # the kernel's stop groups a system follow its design, chosen on the card
    # for the shape (unknown while the shape is symbolic)
    nb, n, nc = B.shape
    if B.device.type == "cpu":
        groups = 1
    elif all(isinstance(v, int) for v in (nb, n, nc)):
        groups = _design(nb, n, nc, B.dtype, B.device)[0].groups(nc)
    else:
        groups = torch.library.get_ctx().new_dynamic_size()
    return torch.empty_like(B), B.new_empty((B.shape[0], groups), dtype=torch.int32)


def fused_cg_dense(Amat: torch.Tensor, B: torch.Tensor, rtol: float = 1e-6,
                   atol: float = 1e-8, max_niter: Optional[int] = None,
                   eps: float = 1e-12, return_steps: bool = False):
    """Solve ``A X = B`` for hermitian positive definite dense A
    ``(*BA, n, n)`` and B ``(*BB, n, nc)`` by unpreconditioned CG from
    x0 = 0 (no autograd); the counterpart of the reference's
    ``fused_cg_dense``.  ``max_niter`` defaults to ``int(1.5 * n)``.  The
    batch dims broadcast; a broadcast A is indexed, not copied.  With
    ``return_steps`` also the step counts ``(*batch, ngroups)``."""
    n, nc = B.shape[-2:]
    if Amat.shape[-2:] != (n, n) or Amat.dtype != B.dtype:
        raise RuntimeError("fused_cg_dense: A %s (%s) does not match B %s (%s)"
                           % (tuple(Amat.shape), Amat.dtype, tuple(B.shape), B.dtype))
    if not fits_fused_cg(n, nc, B.dtype):
        raise RuntimeError("fused_cg_dense: n=%d, ncols=%d, %s is outside the kernel's "
                           "window (fits_fused_cg)" % (n, nc, B.dtype))
    if max_niter is None:
        max_niter = int(1.5 * n)
    batch = torch.broadcast_shapes(Amat.shape[:-2], B.shape[:-2])
    nb = math.prod(batch)
    B3 = B.expand(*batch, n, nc).reshape(nb, n, nc).contiguous()
    nA = math.prod(Amat.shape[:-2])
    A3 = Amat.reshape(nA, n, n).contiguous()
    # which matrix each system takes: A's batch dims broadcast against B's
    a_idx = torch.arange(nA, device=B.device).reshape(Amat.shape[:-2]) \
        .expand(batch).reshape(nb).contiguous()
    check_device(B)
    x, it = _fused_cg_op(A3, a_idx, B3, float(rtol), float(atol), int(max_niter),
                         float(eps))
    x = x.reshape(*batch, n, nc)
    return (x, it.reshape(*batch, -1)) if return_steps else x
