// One level of the spectral divide-and-conquer warm start for large n.
//
// Replaces: xitorch_tpu/ops/dc_kernel.py::_dc_level_kernel (the per-level
// Pallas TPU kernel behind dc_precondition_tpu(per_level=True)).
//
// What it computes, per symmetric (n, n) matrix of the batch, from the state
// (segment ids, T, G0) that the level before left (at the start ids 0,
// T = sym(a), G0 = a):
//   * per segment, the size, the first position and the frozen flag
//     (size <= min_seg); the median sigma of diag(T) by comparison ranking
//     (ties by index); bound = the segment's largest column 1-norm of
//     C = T * [same segment] - sigma I;
//   * X = C * live / (1.01 bound), then E ~ sign(X) by 14 cubic
//     Newton-Schulz steps X <- 1.5 X - 0.5 X (X X).  The cubic map has no
//     identity term, so the zeros across segments and in frozen rows stay
//     exactly zero without a mask a step; P = (I - E)/2 on the live blocks;
//   * r = round(trace of the segment's block of P) (half to even), clipped
//     to [0, size]: the first r positions of a segment are its low slots;
//   * the probe omega masked to the segments (identity on frozen ones),
//     Y = 0.98 * (low ? P omega : omega - P omega) + 0.02 * omega (the
//     strong rank-safety blend of the reference's per-level kernel),
//     columns normalised, scaled by 1.01 sqrt(max row sum * max column sum)
//     of the segment;
//   * Q = polar factor by 10 quintic and 5 cubic Newton-Schulz steps on the
//     Gram matrix Q^T Q;
//   * T <- sym(Q^T T Q) * [same segment], G0 <- Q^T G0, and the ids split:
//     id <- 2 id + (0 if low or frozen else 1).
// That is 72 (n, n) products a level: 28 sign, 1 probe, 30 quintic and 10
// cubic polar, 2 for Q^T T Q and 1 for G0.  The reference runs 61 of them at
// default precision (12 of the 14 sign steps, the probe, the 10 quintic and
// 3 of the 5 cubic polar steps) and 11 at HIGHEST.  This card runs all 72 in
// IEEE float32.  The level-by-level check (chip_smoke.py: ids equal, G0 and
// T within 1e-4 or 4x the distance of the plain version's float32 run from
// its float64 run) decided it, over 41 random batches at 8 x 512^2 to
// 8 x 768^2: the reference's 61 on TF32 fail it on 22, the probe alone on
// 12, the first 3 cubic polar steps alone on 5, all 72 in IEEE float32 on
// none (PERF.md, section 6, row 7).
//
// Design.  The host runs the levels (ops/dc_level.py), one call of
// dc_level_f32 a level, which puts a fixed sequence of kernels on the
// stream: the segment bookkeeping (sizes, starts, medians, ranks, slot
// split, segmented maxima, and the band ranges below) as small kernels of
// one 1024-thread block a matrix over length-n vectors; a handful of
// plane-wide elementwise and column/row reduction kernels over many blocks
// a matrix; and the products, each one batched kernel of grid = 128 x 128
// output tiles x matrices (288 blocks at 8 x 768^2), with the elementwise
// step that follows a product fused into its epilogue where it reads only
// the same entry.  A launch boundary is a barrier across the whole grid, so
// every product is spread over all its output tiles.  The planes (four a
// matrix) live in a workspace in device memory; no TPU reason for the
// reference's shape (scoped VMEM, hand-made DMA, 128-lane slices) carries
// over.
//
// Zero blocks.  The ids are non-decreasing along the index, so each
// segment is a contiguous run and after level l the operands of the sign,
// probe and polar products are block-diagonal over the level's 2^l
// segments.  level_stats writes, for each 128-row band, the k-range of its
// segments (lo: the first index of the segment of the band's first row, hi:
// one past the end of that of its last row).  Output tile (bi, bj) of a
// block-diagonal product sums k over [max(lo_bi, lo_bj), min(hi_bi, hi_bj))
// only; G0 <- Q^T G0, whose B is dense, over [lo_bi, hi_bi).  Outside these
// ranges every term is an exact zero, so the result is the dense one; a tile
// whose range is empty stores epi(i, j, 0) and exits (the planes rotate and
// must not keep stale values).  T is block-diagonal over the parent ids
// only, so T Q is short outside the level's diagonal blocks, which nothing
// reads: Q^T (T Q) reads T Q inside them only, and T is masked to them.
// Every level takes the same 128-wide tile.
//
// Tiles.  Every product runs on the SIMT tile of csrc/dc_common.cuh (8 x 8
// float32 multiply-adds a thread), which the single-shot kernel
// (csrc/dc_kernel.cu) shares.
//
// What bounds it on the H100: operations.  The segments of a run need
// 142 sum(m^2) + 2 n sum(m) operations a matrix and level (m: each row's
// segment size); at 8 x 768^2 and 10 levels 0.766 TFLOP, 11.4 ms at IEEE
// float32's 67 TFLOP/s, against T and G0 read and written once (~40 MB a
// level).  The tiles run more than the segments need (a band's range covers
// whole segments: ~1.0 TFLOP there), and at deep levels only the tiles near
// the diagonal have work.  chip_smoke.py prints the operations needed and
// run, the bounds and the split between products and passes.
#include "dc_common.cuh"

namespace {

constexpr int kMaxN = 1024;       // length of the bookkeeping vectors
constexpr int kVecThreads = 1024; // one block a matrix for the bookkeeping
constexpr int kColThreads = 128;  // column reductions: a thread a column
constexpr int kPlanes = 4;        // workspace planes a matrix
constexpr int kIvec = 5;          // int vectors a matrix: size, start, low, lo, hi
constexpr int kFvec = 5;          // float vectors: sigma, col, bound, rsum, scale

constexpr float kBeta = 0.02f;    // rank-safety probe blend (per-level)
// Newton-Schulz steps
constexpr int kCubicSign = 14;
constexpr int kQuinticPolar = 10;
constexpr int kCubicPolar = 5;

// kLo, kHi: per BM-row band, the k-range of the band's segments (the first
// entry of the segment of its first row, one past the end of that of its
// last row), the first (n + BM - 1) / BM entries of their vectors
enum { kSize = 0, kStart = 1, kLow = 2, kLo = 3, kHi = 4 };
enum { kSigma = 0, kCol = 1, kBound = 2, kRsum = 3, kScale = 4 };

struct Level {
  const int* seg;  // (B, n) ids before the level
  int* ivec;       // (B, kIvec, n)
  float* fvec;     // (B, kFvec, n)
  int n, min_seg;
  __device__ const int* segb(int b) const { return seg + (size_t)b * n; }
  __device__ int* iv(int b, int k) const { return ivec + ((size_t)b * kIvec + k) * n; }
  __device__ float* fv(int b, int k) const { return fvec + ((size_t)b * kFvec + k) * n; }
};

// ---------------------------------------------------------------------------
// the batched product: C[b] = op(A[b]) B[b] for every matrix b, one output
// tile a block; aux[b] is the plane the epilogue reads (kMode 1: qa I +
// qb aux + qc acc; kMode 2: 1.5 aux - 0.5 acc; kMode 0: acc).  The k-range
// of a tile comes from the band ranges (kBlockDiag: both operands
// block-diagonal, k over the overlap of the row and column bands' ranges;
// kRowBand: op(A) block-diagonal, B dense, k over the row band's range).  A
// tile whose range is empty stores epi(i, j, 0) and returns: the planes
// rotate, so no tile may keep a stale value.
// ---------------------------------------------------------------------------
enum { kBlockDiag = 0, kRowBand = 1 };

__device__ __forceinline__ void band_k(const Level& L, int b, int bi, int bj, int kRange,
                                       int& k_lo, int& k_hi) {
  const int* lo = L.iv(b, kLo);
  const int* hi = L.iv(b, kHi);
  k_lo = lo[bi];
  k_hi = hi[bi];
  if (kRange == kBlockDiag) {
    k_lo = max(k_lo, lo[bj]);
    k_hi = min(k_hi, hi[bj]);
  }
}

template <class Epi>
__device__ __forceinline__ void store_empty_tile(float* C, int n, int bm, int bn, Epi epi) {
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int i = bm + e / BN, j = bn + e % BN;
    if (i < n && j < n) C[(size_t)i * n + j] = epi(i, j, 0.0f);
  }
}

template <bool TA, class Epi>
__device__ __forceinline__ void ieee_tile(const Level& L, int kRange, const float* A,
                                          const float* B, float* C, Epi epi, Tiles& tiles) {
  const int b = blockIdx.z, n = L.n;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  int k_lo, k_hi;
  band_k(L, b, blockIdx.y, blockIdx.x, kRange, k_lo, k_hi);
  if (k_lo >= k_hi)
    store_empty_tile(C, n, bm, bn, epi);
  else
    gemm_tile<TA>(A, B, C, n, bm, bn, epi, tiles, k_lo, k_hi);
}

template <bool TA, int kMode, int kRange>
__global__ void __launch_bounds__(kThreads)
level_gemm(Level L, const float* A, const float* B, float* C, const float* aux) {
  __shared__ Tiles tiles;
  const int n = L.n;
  const size_t off = (size_t)blockIdx.z * n * n;
  if (kMode == 1)
    ieee_tile<TA>(L, kRange, A + off, B + off, C + off, EpiQuinticW{aux + off, n}, tiles);
  else if (kMode == 2)
    ieee_tile<TA>(L, kRange, A + off, B + off, C + off, EpiCubic{aux + off, n}, tiles);
  else
    ieee_tile<TA>(L, kRange, A + off, B + off, C + off, EpiStore{}, tiles);
}

// ---------------------------------------------------------------------------
// segment bookkeeping: one block of kVecThreads a matrix
// ---------------------------------------------------------------------------

// sizes, starts, and the median sigma of diag(T) in each segment
__global__ void __launch_bounds__(kVecThreads)
level_stats(Level L, const float* T_g) {
  __shared__ int seg[kMaxN];
  __shared__ int size[kMaxN];
  __shared__ int start[kMaxN];
  __shared__ int rank[kMaxN];
  __shared__ float d[kMaxN];
  const int b = blockIdx.x, n = L.n, tid = threadIdx.x;
  const float* T = T_g + (size_t)b * n * n;
  for (int i = tid; i < n; i += kVecThreads) {
    seg[i] = L.segb(b)[i];
    d[i] = T[(size_t)i * n + i];
  }
  __syncthreads();
  for (int i = tid; i < n; i += kVecThreads) {
    int sz = 0, st = 0;
    const int si = seg[i];
    for (int j = 0; j < n; ++j) {
      sz += seg[j] == si;
      st += seg[j] < si;
    }
    size[i] = sz;
    start[i] = st;
    L.iv(b, kSize)[i] = sz;
    L.iv(b, kStart)[i] = st;
  }
  // rank of each diagonal entry inside its segment, ties by index
  for (int j = tid; j < n; j += kVecThreads) {
    int r = 0;
    const float dj = d[j];
    for (int i = 0; i < n; ++i) {
      const float di = d[i];
      r += (seg[i] == seg[j]) && (di < dj || (di == dj && i < j));
    }
    rank[j] = r;
  }
  __syncthreads();
  // the band ranges the products read (segments are contiguous runs)
  for (int t = tid; t * BM < n; t += kVecThreads) {
    const int last = min(n, (t + 1) * BM) - 1;
    L.iv(b, kLo)[t] = start[t * BM];
    L.iv(b, kHi)[t] = start[last] + size[last];
  }
  // median: mean of the two middle ranks
  for (int i = tid; i < n; i += kVecThreads) {
    const int lo_t = (size[i] - 1) / 2, hi_t = size[i] / 2;
    float lo = 0.0f, hi = 0.0f;
    for (int j = 0; j < n; ++j) {
      if (seg[j] != seg[i]) continue;
      if (rank[j] == lo_t) lo += d[j];
      if (rank[j] == hi_t) hi += d[j];
    }
    L.fv(b, kSigma)[i] = 0.5f * (lo + hi);
  }
}

// out_i = max over the positions j of i's segment of v_j (v >= 0)
__device__ __forceinline__ void seg_max(float* out, const float* v, const int* seg, int n) {
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    float m = 0.0f;
    for (int j = 0; j < n; ++j)
      if (seg[j] == seg[i]) m = fmaxf(m, v[j]);
    out[i] = m;
  }
}

// bound_i = the largest column 1-norm of C in i's segment
__global__ void __launch_bounds__(kVecThreads) level_bound(Level L) {
  __shared__ int seg[kMaxN];
  __shared__ float col[kMaxN];
  const int b = blockIdx.x, n = L.n;
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    seg[i] = L.segb(b)[i];
    col[i] = L.fv(b, kCol)[i];
  }
  __syncthreads();
  seg_max(L.fv(b, kBound), col, seg, n);
}

// the low-slot flags: r = round(trace of the segment's block of P)
__global__ void __launch_bounds__(kVecThreads) level_slots(Level L, const float* P_g) {
  __shared__ int seg[kMaxN];
  __shared__ float pd[kMaxN];
  const int b = blockIdx.x, n = L.n;
  const float* P = P_g + (size_t)b * n * n;
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    seg[i] = L.segb(b)[i];
    pd[i] = P[(size_t)i * n + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    float tr = 0.0f;
    for (int j = 0; j < n; ++j)
      if (seg[j] == seg[i]) tr += pd[j];
    const int size = L.iv(b, kSize)[i];
    int r = (int)rintf(tr);  // half to even
    r = min(max(r, 0), size);
    L.iv(b, kLow)[i] = ((i - L.iv(b, kStart)[i]) < r && size > L.min_seg) ? 1 : 0;
  }
}

// scale_j = 1.01 sqrt(max row sum * max column sum of j's segment)
__global__ void __launch_bounds__(kVecThreads) level_scale(Level L) {
  __shared__ int seg[kMaxN];
  __shared__ float rs[kMaxN];
  __shared__ float cs[kMaxN];
  __shared__ float rmax[kMaxN];
  const int b = blockIdx.x, n = L.n;
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    seg[i] = L.segb(b)[i];
    rs[i] = L.fv(b, kRsum)[i];
    cs[i] = L.fv(b, kCol)[i];
  }
  __syncthreads();
  seg_max(rmax, rs, seg, n);
  seg_max(L.fv(b, kScale), cs, seg, n);  // cmax, finished below
  __syncthreads();
  float* scale = L.fv(b, kScale);
  for (int j = threadIdx.x; j < n; j += kVecThreads)
    scale[j] = 1.01f * sqrtf(rmax[j] * scale[j]) + 1e-30f;
}

// the ids split: low or frozen positions take the even child
__global__ void __launch_bounds__(kVecThreads) level_split(Level L, int* seg_out) {
  const int b = blockIdx.x, n = L.n;
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    const bool low = L.iv(b, kLow)[i] != 0;
    const bool froz = L.iv(b, kSize)[i] <= L.min_seg;
    seg_out[(size_t)b * n + i] = L.segb(b)[i] * 2 + ((low || froz) ? 0 : 1);
  }
}

// ---------------------------------------------------------------------------
// plane-wide passes: many blocks a matrix
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool same_seg(const Level& L, int b, int i, int j) {
  return L.segb(b)[i] == L.segb(b)[j];
}

__device__ __forceinline__ bool frozen(const Level& L, int b, int i) {
  return L.iv(b, kSize)[i] <= L.min_seg;
}

// C_ij = T_ij [same segment] - sigma_i [i == j]
__device__ __forceinline__ float c_entry(const Level& L, int b, const float* T, int i,
                                         int j) {
  const float eq = same_seg(L, b, i, j) ? 1.0f : 0.0f;
  return T[(size_t)i * L.n + j] * eq - (i == j ? L.fv(b, kSigma)[i] : 0.0f);
}

// the kinds of column reduction, a thread a column (coalesced), rows in order
enum { kColAbsC = 0, kColNorm2 = 1, kColAbs = 2 };

template <int kKind>
__global__ void __launch_bounds__(kColThreads)
level_col_reduce(Level L, const float* X_g, int k_out) {
  const int b = blockIdx.y, n = L.n;
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  if (j >= n) return;
  const float* X = X_g + (size_t)b * n * n;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    if (kKind == kColAbsC) {
      acc += fabsf(c_entry(L, b, X, i, j));
    } else {
      const float x = X[(size_t)i * n + j];
      acc += kKind == kColNorm2 ? x * x : fabsf(x);
    }
  }
  L.fv(b, k_out)[j] = kKind == kColNorm2 ? sqrtf(acc) : acc;
}

// rsum_i = sum_j |Y_ij|: a warp a row
__global__ void __launch_bounds__(kThreads) level_row_abs(Level L, const float* Y_g) {
  const int b = blockIdx.y, n = L.n;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const float* Y = Y_g + (size_t)b * n * n + (size_t)i * n;
  float acc = 0.0f;
  for (int j = lane; j < n; j += 32) acc += fabsf(Y[j]);
  acc = warp_sum(acc);
  if (lane == 0) L.fv(b, kRsum)[i] = acc;
}

// the elementwise steps of a level
enum { kSignInit = 0, kProjector, kProbe, kBlend, kDivColn, kDivScale, kSymMask };

// a = primary plane (written), p = a second plane read, T = T's plane
template <int kStep>
__global__ void __launch_bounds__(kThreads)
level_elementwise(Level L, float* a_g, const float* p_g, const float* om) {
  const int b = blockIdx.y, n = L.n;
  const size_t nn = (size_t)n * n;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= nn) return;
  const int i = (int)(idx / n), j = (int)(idx % n);
  float* a = a_g + (size_t)b * nn;
  const float* p = p_g + (size_t)b * nn;
  if (kStep == kSignInit) {
    // a <- C * live / (1.01 bound + 1e-30), p = T
    const float lv = (frozen(L, b, i) || frozen(L, b, j)) ? 0.0f : 1.0f;
    a[idx] = c_entry(L, b, p, i, j) * lv / (1.01f * L.fv(b, kBound)[i] + 1e-30f);
  } else if (kStep == kProjector) {
    // a <- (I - E)/2 on the live blocks (E = a)
    const float lv = (frozen(L, b, i) || frozen(L, b, j)) ? 0.0f : 1.0f;
    a[idx] = 0.5f * ((i == j ? 1.0f : 0.0f) - a[idx]) * lv;
  } else if (kStep == kProbe) {
    // a <- omega masked to the segments, identity on the frozen ones
    const bool fro = frozen(L, b, i) || frozen(L, b, j);
    const float eq = same_seg(L, b, i, j) ? 1.0f : 0.0f;
    a[idx] = (fro ? (i == j ? 1.0f : 0.0f) : om[idx]) * eq;
  } else if (kStep == kBlend) {
    // a (omega masked) <- the blended slot columns, p = P omega
    const float omb = a[idx], pom = p[idx];
    a[idx] = (1.0f - kBeta) * (L.iv(b, kLow)[j] ? pom : omb - pom) + kBeta * omb;
  } else if (kStep == kDivColn) {
    a[idx] = a[idx] / (L.fv(b, kCol)[j] + 1e-20f);
  } else if (kStep == kDivScale) {
    a[idx] = a[idx] / L.fv(b, kScale)[j];
  } else {
    // kSymMask: a (T out) <- (p + p^T)/2 on the blocks of the level's ids
    const float eq = same_seg(L, b, i, j) ? 1.0f : 0.0f;
    a[idx] = 0.5f * (p[idx] + p[(size_t)j * n + i]) * eq;
  }
}

struct Launcher {
  int B, n;
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;

  bool ok() {
    if (err == cudaSuccess) err = cudaGetLastError();
    return err == cudaSuccess;
  }
  // one product on the IEEE float32 tile
  template <bool TA, int kMode, int kRange = kBlockDiag>
  void gemm(const Level& L, const float* A, const float* Bm, float* C,
            const float* aux = nullptr) {
    if (err != cudaSuccess) return;
    const dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM, B);
    level_gemm<TA, kMode, kRange><<<grid, kThreads, 0, stream>>>(L, A, Bm, C, aux);
    ok();
  }
  template <int kStep>
  void elementwise(const Level& L, float* a, const float* p, const float* om = nullptr) {
    if (err != cudaSuccess) return;
    const size_t nn = (size_t)n * n;
    const dim3 grid((unsigned)((nn + kThreads - 1) / kThreads), B);
    level_elementwise<kStep><<<grid, kThreads, 0, stream>>>(L, a, p, om);
    ok();
  }
  template <int kKind>
  void col_reduce(const Level& L, const float* X, int k_out) {
    if (err != cudaSuccess) return;
    const dim3 grid((n + kColThreads - 1) / kColThreads, B);
    level_col_reduce<kKind><<<grid, kColThreads, 0, stream>>>(L, X, k_out);
    ok();
  }
};

}  // namespace

// Plain C entry for ctypes: one level on a (B, n, n) float32 batch.
//   seg_in, seg_out: (B, n) int32 ids before and after the level (may be
//     the same buffer);
//   om: the (n, n) probe; t_in, t_out: T before and after (may be the same
//     buffer); g_in, g_out: G0 before and after (distinct buffers);
//   work: B * 4 * n * n floats of scratch, distinct from all of the above;
//   ivec: B * 3 * n ints, fvec: B * 5 * n floats of scratch.
// 1 <= n <= 1024, min_seg >= 0.  Returns a cudaError_t (0 on success).
extern "C" int dc_level_f32(const int* seg_in, int* seg_out, const float* om,
                            const float* t_in, float* t_out, const float* g_in,
                            float* g_out, float* work, int* ivec, float* fvec, int B,
                            int n, int min_seg, void* stream) {
  if (B <= 0 || n < 1 || n > kMaxN || min_seg < 0 || g_in == g_out)
    return (int)cudaErrorInvalidValue;
  Launcher run{B, n, (cudaStream_t)stream};
  Level L{seg_in, ivec, fvec, n, min_seg};
  const size_t plane = (size_t)B * n * n;
  float* p[kPlanes] = {work, work + plane, work + 2 * plane, work + 3 * plane};

  // ---- segments, medians, bounds, the sign's start ----
  level_stats<<<B, kVecThreads, 0, run.stream>>>(L, t_in);
  run.ok();
  run.col_reduce<kColAbsC>(L, t_in, kCol);
  if (run.err == cudaSuccess) {
    level_bound<<<B, kVecThreads, 0, run.stream>>>(L);
    run.ok();
  }
  float *X = p[0], *S = p[1], *Xn = p[2];
  run.elementwise<kSignInit>(L, X, t_in);

  // ---- E ~ sign(X): cubic steps only ----
  for (int it = 0; it < kCubicSign; ++it) {
    run.gemm<false, 0>(L, X, X, S);
    run.gemm<false, 2>(L, X, S, Xn, X);
    float* t = X;
    X = Xn;
    Xn = t;
  }
  float* P = X;  // the other two of p[0..2] are S and Xn, p[3] is free
  run.elementwise<kProjector>(L, P, P);
  if (run.err == cudaSuccess) {
    level_slots<<<B, kVecThreads, 0, run.stream>>>(L, P);
    run.ok();
  }

  // ---- probe, blended slot columns, scaling ----
  float *Y = S, *POm = Xn;
  run.elementwise<kProbe>(L, Y, Y, om);
  run.gemm<false, 0>(L, P, Y, POm);
  run.elementwise<kBlend>(L, Y, POm);
  run.col_reduce<kColNorm2>(L, Y, kCol);
  run.elementwise<kDivColn>(L, Y, Y);
  if (run.err == cudaSuccess) {
    const dim3 grid((n + kWarps - 1) / kWarps, B);
    level_row_abs<<<grid, kThreads, 0, run.stream>>>(L, Y);
    run.ok();
  }
  run.col_reduce<kColAbs>(L, Y, kCol);
  if (run.err == cudaSuccess) {
    level_scale<<<B, kVecThreads, 0, run.stream>>>(L);
    run.ok();
  }
  run.elementwise<kDivScale>(L, Y, Y);

  // ---- Q = polar factor: 10 quintic, 5 cubic ----
  float *Q = Y, *Gm = POm, *W = P, *Qn = p[3];
  for (int it = 0; it < kQuinticPolar; ++it) {
    run.gemm<true, 0>(L, Q, Q, Gm);
    run.gemm<false, 1>(L, Gm, Gm, W, Gm);
    run.gemm<false, 0>(L, Q, W, Qn);
    float* t = Q;
    Q = Qn;
    Qn = t;
  }
  for (int it = 0; it < kCubicPolar; ++it) {
    run.gemm<true, 0>(L, Q, Q, Gm);
    run.gemm<false, 2>(L, Q, Gm, Qn, Q);
    float* t = Q;
    Q = Qn;
    Qn = t;
  }

  // ---- T <- sym(Q^T T Q) on the blocks, G0 <- Q^T G0, split the ids ----
  // T is block-diagonal over the parent ids only, so the band ranges of the
  // level's ids leave T Q short outside the level's diagonal blocks; but
  // Q^T (T Q) on those blocks reads T Q only inside them, where the range
  // holds every nonzero term, and kSymMask keeps only them
  run.gemm<false, 0>(L, t_in, Q, Gm);
  run.gemm<true, 0>(L, Q, Gm, W);
  run.elementwise<kSymMask>(L, t_out, W);
  run.gemm<true, 0, kRowBand>(L, Q, g_in, g_out);
  if (run.err == cudaSuccess) {
    level_split<<<B, kVecThreads, 0, run.stream>>>(L, seg_out);
    run.ok();
  }
  return (int)run.err;
}
