// Spectral divide-and-conquer warm start for the one-sided Jacobi sweep.
//
// Replaces: xitorch_tpu/ops/dc_kernel.py::_dc_kernel (the single-shot Pallas
// TPU kernel behind dc_precondition_tpu).
//
// What it computes, per symmetric (n, n) matrix a of the batch: an
// orthogonal Q, level by level, such that Q^T a Q is nearly block-diagonal
// in eigenvalue-sorted segments, and returns G0 = Q^T a (optionally also
// T = Q^T a Q of the last level and the final segment ids).  One level:
//   * per segment, the median of diag(T) by comparison ranking (ties by
//     index), and a column-1-norm bound that scales the shifted block into
//     the unit interval;
//   * E ~ sign(X) by Newton-Schulz: 8 quintic steps
//     X <- X (qa I + qb X^2 + qc X^4), then 3 cubic steps
//     X <- 1.5 X - 0.5 X X^2, every step masked to the live segments, one
//     symmetrisation at the end; P = (I - E)/2;
//   * slot assignment: r = round(trace_segment P) (half to even), the first
//     r positions of a segment take columns of P omega, the rest of
//     (I - P) omega, blended with 0.002 of the raw probe omega (rank
//     safety); column-normalised and scaled by a segmented Schur bound;
//   * Q = polar factor by Newton-Schulz: 10 quintic and 5 cubic steps on
//     the Gram matrix Q^T Q; optional refinement passes re-project Q
//     through P and re-orthonormalise (3 cubic steps);
//   * T <- sym(Q^T T Q) (not masked), G0 <- Q^T G0, segment ids split.
// Segments of at most min_seg positions are frozen: identity columns.
// That is 74 (n, n) products a level (30 sign, 1 probe, 40 polar, 3 tail).
//
// What bounds it on the H100: operations.  The ids are non-decreasing along
// the index (each segment a contiguous run), so after level l the operands
// of the 71 sign, probe and polar products are block-diagonal over the
// level's segments: 2 m^3 operations a segment of m rows; the tail's three
// products 2 m^2 n each.  Per matrix and level 142 sum(m^2) + 6 n sum(m)
// (m: each row's segment size): at (64, 256, 256) and 8 levels 0.225 TFLOP,
// 3.36 ms at IEEE float32's 67 TFLOP/s, against a, omega, G0 read or written
// once (50 MB).  The dense products would be 1.271 TFLOP.
//
// Design.  The C entry puts the whole fixed sequence of all the levels on
// the stream, with no host sync (the wrapper counts one launch a call):
//   * the segment bookkeeping (sizes, starts, medians, ranks, slot split,
//     segmented maxima, band ranges) as small kernels of one 1024-thread
//     block a matrix over length-n vectors in device memory;
//   * the plane-wide elementwise steps and column/row reductions over many
//     blocks a matrix;
//   * each product one batched kernel of grid = 32 x 32 output tiles x
//     matrices (4,096 blocks of 64 threads at 64 x 256^2) on the IEEE tile
//     of csrc/dc_common.cuh (4 x 4 outputs a thread, k tiles staged as
//     16-byte loads when n is a multiple of 4), with the elementwise step
//     that follows a product fused into its epilogue where it reads only
//     the same entry (the live mask among them).
// A launch boundary is a barrier across the whole grid.  The planes (T and
// five scratch planes) live in a workspace in device memory.
//
// Zero blocks.  dc_stats writes, for each 32-row band, the k-range of its
// segments (lo: the first index of the segment of the band's first row, hi:
// one past the end of that of its last row).  Output tile (bi, bj) sums k
// over
//   * [max(lo_bi, lo_bj), min(hi_bi, hi_bj)) for the block-diagonal products
//     (sign, probe, polar, refinement);
//   * [lo_bj, hi_bj) for T Q: T is never masked (the return_t export stays
//     exact), so A is dense and only B = Q is block-diagonal;
//   * [lo_bi, hi_bi) for Q^T (T Q) and Q^T G0: op(A) = Q^T is
//     block-diagonal, B dense.
// Outside these ranges every term is an exact zero, so every entry is the
// dense product's, summed in the same order.  A tile whose range is empty
// stores zeros, which is what every epilogue gives there, and exits (the
// planes rotate and must not keep stale values).  The band is the output
// tile's width.  The split points drift from the halves (segments of
// 157/99 after level 1 at n = 256), so wide bands skip little: on config
// 2's recipe the tiles run 1.17x the operations the segments need with
// 32-wide bands, 1.52x with 64, 2.56x with 128.  A call at (64, 256, 256)
// took 21.2 ms with 32-wide tiles and 26.6 with 64-wide, the code
// otherwise the same (in turns on an NVIDIA H100 80GB HBM3, 700 W); the
// narrow tile is no slower even on the dense first level.
//
// Numbers: every product IEEE float32 multiply-adds (no TF32), every sum in
// a fixed order, no atomics, so two launches give the same bits, and the
// rounded ranks and slot assignments agree with the plain PyTorch version.
// Only exact zeros are skipped and the epilogues round as the rejected
// design's did, so G0, T and the ids are that design's bits (held on the
// card at config 2's batch and at n = 1 to 448).
//
// Rejected: one block of 256 threads a matrix running the whole level loop
// with the 74 dense products walked tile after tile and a block barrier
// after each (the first design of this kernel).  It filled 64 of the 132
// SMs at config 2's batch and ran every product over all of n: 116-126 ms
// a call at (64, 256, 256), 8 levels, 35-37x its bound and slower than its
// own plain version (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
#include "dc_common.cuh"

namespace {

constexpr int kMaxN = 1024;        // length of the bookkeeping vectors
constexpr int kTile = 32;          // output tile and band width of the products
constexpr int kTileThreads = TileSmem<kTile>::kThreads;
constexpr int kBookThreads = 1024; // one block a matrix for the bookkeeping
constexpr int kColThreads = 128;   // column reductions: a thread a column

constexpr float kBeta = 0.002f;  // rank-safety probe blend
constexpr int kQuinticSign = 8, kCubicSign = 3;
constexpr int kQuinticPolar = 10, kCubicPolar = 5, kCubicRefine = 3;

// int vectors a matrix: segment id, its size, its first position, the low
// slot flag, and per kTile-row band the band's k-range [lo, hi) (the first
// ceil(n / kTile) entries of the last two)
enum { kSeg = 0, kSize, kStart, kLow, kLo, kHi, kIvec };
// float vectors a matrix: median, column sums (of |C|, then the column
// 2-norms, then |Y|), the segment bound, row sums of |Y|, the column scale
enum { kSigma = 0, kCol, kBound, kRsum, kScale, kFvec };

struct Dc {
  int* ivec;    // (B, kIvec, n)
  float* fvec;  // (B, kFvec, n)
  int n, min_seg;
  __device__ int* iv(int b, int k) const { return ivec + ((size_t)b * kIvec + k) * n; }
  __device__ float* fv(int b, int k) const { return fvec + ((size_t)b * kFvec + k) * n; }
  __device__ bool frozen(int b, int i) const { return iv(b, kSize)[i] <= min_seg; }
  __device__ bool same_seg(int b, int i, int j) const {
    const int* s = iv(b, kSeg);
    return s[i] == s[j];
  }
  // 1 inside a live segment's diagonal block, else 0
  __device__ float live(int b, int i, int j) const {
    return (same_seg(b, i, j) && !frozen(b, i)) ? 1.0f : 0.0f;
  }
};

// ---------------------------------------------------------------------------
// the batched product: C[b] = op(A[b]) B[b] for every matrix b, one 32 x 32
// output tile a block, k over the tile's range (see Zero blocks above)
// ---------------------------------------------------------------------------
enum { kBlockDiag = 0, kRowBand, kColBand };
// the epilogues: acc; qa I + qb aux + qc acc; 1.5 aux - 0.5 acc; acc masked
// to the live segments; (1.5 aux - 0.5 acc) masked to the live segments
// (they round as the rejected design's did: see csrc/dc_common.cuh)
enum { kStore = 0, kQuinticW, kCubic, kMask, kCubicLive };

struct EpiMask {
  Dc d;
  int b;
  __device__ float operator()(int i, int j, float acc) const { return acc * d.live(b, i, j); }
};
struct EpiCubicLive {
  const float* X;
  Dc d;
  int b;
  __device__ float operator()(int i, int j, float acc) const {
    return cubic(X[(size_t)i * d.n + j], acc) * d.live(b, i, j);
  }
};

template <bool TA, bool kVec, class Epi>
__device__ __forceinline__ void dc_tile(const float* A, const float* B, float* C, int n,
                                        int k_lo, int k_hi, Epi epi,
                                        TileSmem<kTile>& tiles) {
  const int bm = blockIdx.y * kTile, bn = blockIdx.x * kTile;
  if (k_lo < k_hi) {
    gemm_tile<TA, kVec>(A, B, C, n, bm, bn, epi, tiles, k_lo, k_hi);
    return;
  }
  // An empty range only happens off the diagonal blocks of a
  // block-diagonal product, where every epilogue gives zero (its aux plane
  // is block-diagonal too): store zeros without reading anything
  for (int e = threadIdx.x; e < kTile * kTile; e += kTileThreads) {
    const int i = bm + e / kTile, j = bn + e % kTile;
    if (i < n && j < n) C[(size_t)i * n + j] = 0.0f;
  }
}

// kVec: n is a multiple of 4, the k tiles are staged as 16-byte loads
template <bool TA, int kEpi, int kRange, bool kVec>
__global__ void __launch_bounds__(kTileThreads)
dc_gemm(Dc d, const float* A, const float* B, float* C, const float* aux) {
  __shared__ TileSmem<kTile> tiles;
  const int b = blockIdx.z, n = d.n;
  const size_t off = (size_t)b * n * n;
  const int* lo = d.iv(b, kLo);
  const int* hi = d.iv(b, kHi);
  const int band = kRange == kColBand ? blockIdx.x : blockIdx.y;
  int k_lo = lo[band], k_hi = hi[band];
  if (kRange == kBlockDiag) {
    k_lo = max(k_lo, lo[blockIdx.x]);
    k_hi = min(k_hi, hi[blockIdx.x]);
  }
  A += off;
  B += off;
  C += off;
  if (kEpi == kQuinticW)
    dc_tile<TA, kVec>(A, B, C, n, k_lo, k_hi, EpiQuinticW{aux + off, n}, tiles);
  else if (kEpi == kCubic)
    dc_tile<TA, kVec>(A, B, C, n, k_lo, k_hi, EpiCubic{aux + off, n}, tiles);
  else if (kEpi == kMask)
    dc_tile<TA, kVec>(A, B, C, n, k_lo, k_hi, EpiMask{d, b}, tiles);
  else if (kEpi == kCubicLive)
    dc_tile<TA, kVec>(A, B, C, n, k_lo, k_hi, EpiCubicLive{aux + off, d, b}, tiles);
  else
    dc_tile<TA, kVec>(A, B, C, n, k_lo, k_hi, EpiStore{}, tiles);
}

// ---------------------------------------------------------------------------
// segment bookkeeping: one block of kBookThreads a matrix
// ---------------------------------------------------------------------------

// sizes, starts, the band ranges, and the median sigma of diag(T) in each
// segment
__global__ void __launch_bounds__(kBookThreads) dc_stats(Dc d, const float* T_g) {
  __shared__ int seg[kMaxN];
  __shared__ int size[kMaxN];
  __shared__ int start[kMaxN];
  __shared__ int rank[kMaxN];
  __shared__ float dg[kMaxN];
  const int b = blockIdx.x, n = d.n, tid = threadIdx.x;
  const float* T = T_g + (size_t)b * n * n;
  for (int i = tid; i < n; i += kBookThreads) {
    seg[i] = d.iv(b, kSeg)[i];
    dg[i] = T[(size_t)i * n + i];
  }
  __syncthreads();
  for (int i = tid; i < n; i += kBookThreads) {
    int sz = 0, st = 0;
    const int si = seg[i];
    for (int j = 0; j < n; ++j) {
      sz += seg[j] == si;
      st += seg[j] < si;
    }
    size[i] = sz;
    start[i] = st;
    d.iv(b, kSize)[i] = sz;
    d.iv(b, kStart)[i] = st;
  }
  // rank of each diagonal entry inside its segment, ties by index
  for (int j = tid; j < n; j += kBookThreads) {
    int r = 0;
    const float dj = dg[j];
    for (int i = 0; i < n; ++i) {
      const float di = dg[i];
      r += (seg[i] == seg[j]) && (di < dj || (di == dj && i < j));
    }
    rank[j] = r;
  }
  __syncthreads();
  // the band ranges the products read (segments are contiguous runs)
  for (int t = tid; t * kTile < n; t += kBookThreads) {
    const int last = min(n, (t + 1) * kTile) - 1;
    d.iv(b, kLo)[t] = start[t * kTile];
    d.iv(b, kHi)[t] = start[last] + size[last];
  }
  // median: mean of the two middle ranks
  for (int i = tid; i < n; i += kBookThreads) {
    const int lo_t = (size[i] - 1) / 2, hi_t = size[i] / 2;
    float lo = 0.0f, hi = 0.0f;
    for (int j = 0; j < n; ++j) {
      if (seg[j] != seg[i]) continue;
      if (rank[j] == lo_t) lo += dg[j];
      if (rank[j] == hi_t) hi += dg[j];
    }
    d.fv(b, kSigma)[i] = 0.5f * (lo + hi);
  }
}

// out_i = max over the positions j of i's segment of v_j (v >= 0)
__device__ __forceinline__ void seg_max(float* out, const float* v, const int* seg, int n) {
  for (int i = threadIdx.x; i < n; i += kBookThreads) {
    float m = 0.0f;
    for (int j = 0; j < n; ++j)
      if (seg[j] == seg[i]) m = fmaxf(m, v[j]);
    out[i] = m;
  }
}

// bound_i = the largest column 1-norm of C in i's segment
__global__ void __launch_bounds__(kBookThreads) dc_bound(Dc d) {
  __shared__ int seg[kMaxN];
  __shared__ float col[kMaxN];
  const int b = blockIdx.x, n = d.n;
  for (int i = threadIdx.x; i < n; i += kBookThreads) {
    seg[i] = d.iv(b, kSeg)[i];
    col[i] = d.fv(b, kCol)[i];
  }
  __syncthreads();
  seg_max(d.fv(b, kBound), col, seg, n);
}

// the low-slot flags: r = round(trace of the segment's block of P)
__global__ void __launch_bounds__(kBookThreads) dc_slots(Dc d, const float* P_g) {
  __shared__ int seg[kMaxN];
  __shared__ float pd[kMaxN];
  const int b = blockIdx.x, n = d.n;
  const float* P = P_g + (size_t)b * n * n;
  for (int i = threadIdx.x; i < n; i += kBookThreads) {
    seg[i] = d.iv(b, kSeg)[i];
    pd[i] = P[(size_t)i * n + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kBookThreads) {
    float tr = 0.0f;
    for (int j = 0; j < n; ++j)
      if (seg[j] == seg[i]) tr += pd[j];
    const int size = d.iv(b, kSize)[i];
    int r = (int)rintf(tr);  // half to even
    r = min(max(r, 0), size);
    d.iv(b, kLow)[i] = ((i - d.iv(b, kStart)[i]) < r && size > d.min_seg) ? 1 : 0;
  }
}

// scale_j = 1.01 sqrt(max row sum * max column sum of j's segment)
__global__ void __launch_bounds__(kBookThreads) dc_scale(Dc d) {
  __shared__ int seg[kMaxN];
  __shared__ float rs[kMaxN];
  __shared__ float cs[kMaxN];
  __shared__ float rmax[kMaxN];
  const int b = blockIdx.x, n = d.n;
  for (int i = threadIdx.x; i < n; i += kBookThreads) {
    seg[i] = d.iv(b, kSeg)[i];
    rs[i] = d.fv(b, kRsum)[i];
    cs[i] = d.fv(b, kCol)[i];
  }
  __syncthreads();
  seg_max(rmax, rs, seg, n);
  seg_max(d.fv(b, kScale), cs, seg, n);  // cmax, finished below
  __syncthreads();
  float* scale = d.fv(b, kScale);
  for (int j = threadIdx.x; j < n; j += kBookThreads)
    scale[j] = 1.01f * sqrtf(rmax[j] * scale[j]) + 1e-30f;
}

// the ids split: low or frozen positions take the even child
__global__ void __launch_bounds__(kBookThreads) dc_split(Dc d) {
  const int b = blockIdx.x;
  int* seg = d.iv(b, kSeg);
  for (int i = threadIdx.x; i < d.n; i += kBookThreads) {
    const bool low = d.iv(b, kLow)[i] != 0;
    seg[i] = seg[i] * 2 + ((low || d.frozen(b, i)) ? 0 : 1);
  }
}

// ---------------------------------------------------------------------------
// plane-wide passes: many blocks a matrix
// ---------------------------------------------------------------------------

// C_ij = T_ij [same segment] - sigma_i [i == j]
__device__ __forceinline__ float c_entry(const Dc& d, int b, const float* T, int i, int j) {
  const float eq = d.same_seg(b, i, j) ? 1.0f : 0.0f;
  return T[(size_t)i * d.n + j] * eq - (i == j ? d.fv(b, kSigma)[i] : 0.0f);
}

// the kinds of column reduction, a thread a column (coalesced), rows in order
enum { kColAbsC = 0, kColNorm2, kColAbs };

template <int kKind>
__global__ void __launch_bounds__(kColThreads) dc_col_reduce(Dc d, const float* X_g) {
  const int b = blockIdx.y, n = d.n;
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  if (j >= n) return;
  const float* X = X_g + (size_t)b * n * n;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    if (kKind == kColAbsC) {
      acc += fabsf(c_entry(d, b, X, i, j));
    } else {
      const float x = X[(size_t)i * n + j];
      acc += kKind == kColNorm2 ? x * x : fabsf(x);
    }
  }
  d.fv(b, kCol)[j] = kKind == kColNorm2 ? sqrtf(acc) : acc;
}

// rsum_i = sum_j |Y_ij|: a warp a row
__global__ void __launch_bounds__(kThreads) dc_row_abs(Dc d, const float* Y_g) {
  const int b = blockIdx.y, n = d.n;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const float* Y = Y_g + (size_t)b * n * n + (size_t)i * n;
  float acc = 0.0f;
  for (int j = lane; j < n; j += 32) acc += fabsf(Y[j]);
  acc = warp_sum(acc);
  if (lane == 0) d.fv(b, kRsum)[i] = acc;
}

// the elementwise steps: the start, and those of a level
enum {
  kInit = 0, kSignInit, kProjector, kProbe, kBlend, kDivColn, kDivScale, kRefine, kSymT
};

// x, y: (B, n, n) planes a step writes or reads (per step below); r: the
// input batch a (kInit) or the (n, n) probe (kProbe)
template <int kStep>
__global__ void __launch_bounds__(kThreads)
dc_elementwise(Dc d, float* x_g, float* y_g, const float* r) {
  const int b = blockIdx.y, n = d.n;
  const size_t nn = (size_t)n * n;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= nn) return;
  const int i = (int)(idx / n), j = (int)(idx % n);
  float* x = x_g + (size_t)b * nn;
  float* y = y_g + (size_t)b * nn;
  if (kStep == kInit) {
    // x (T) <- sym(a), y (G0) <- a; the ids start at 0
    const float* a = r + (size_t)b * nn;
    x[idx] = 0.5f * (a[idx] + a[(size_t)j * n + i]);
    y[idx] = a[idx];
    if (idx < (size_t)n) d.iv(b, kSeg)[idx] = 0;
  } else if (kStep == kSignInit) {
    // x (X) <- C / (1.01 bound_i + 1e-30), y = T
    x[idx] = c_entry(d, b, y, i, j) / (1.01f * d.fv(b, kBound)[i] + 1e-30f);
  } else if (kStep == kProjector) {
    // x (E) <- (I - sym(E)) / 2 on the live segments, in place: the thread
    // of (i, j), i <= j, writes both (i, j) and (j, i)
    if (i > j) return;
    const float e = 0.5f * (x[idx] + x[(size_t)j * n + i]);
    const float lv = (d.frozen(b, i) || d.frozen(b, j)) ? 0.0f : 1.0f;
    const float p = 0.5f * ((i == j ? 1.0f : 0.0f) - e) * lv;
    x[idx] = p;
    x[(size_t)j * n + i] = p;
  } else if (kStep == kProbe) {
    // x <- omega masked to the segments, identity on the frozen ones
    const bool fro = d.frozen(b, i) || d.frozen(b, j);
    const float eq = d.same_seg(b, i, j) ? 1.0f : 0.0f;
    x[idx] = (fro ? (i == j ? 1.0f : 0.0f) : r[idx]) * eq;
  } else if (kStep == kBlend) {
    // x (omega masked) <- the blended slot columns, y = P omega
    const float omb = x[idx], pom = y[idx];
    x[idx] = (1.0f - kBeta) * (d.iv(b, kLow)[j] ? pom : omb - pom) + kBeta * omb;
  } else if (kStep == kDivColn) {
    x[idx] = x[idx] / (d.fv(b, kCol)[j] + 1e-20f);
  } else if (kStep == kDivScale) {
    x[idx] = x[idx] / d.fv(b, kScale)[j];
  } else if (kStep == kRefine) {
    // x (Q) <- the low slots through P, the high ones through I - P
    // (y = P Q); frozen segments keep their identity columns
    const float pq = y[idx];
    float q = d.iv(b, kLow)[j] ? pq : x[idx] - pq;
    if (d.frozen(b, i) || d.frozen(b, j)) q = (i == j) ? 1.0f : 0.0f;
    x[idx] = q;
  } else {
    // kSymT: x (T) <- sym(y), y = Q^T T Q (not masked)
    x[idx] = 0.5f * (y[idx] + y[(size_t)j * n + i]);
  }
}

// dst <- src, total floats
__global__ void __launch_bounds__(kThreads) dc_copy(float* dst, const float* src, size_t total) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx < total) dst[idx] = src[idx];
}

// the final ids, (B, n) int32
__global__ void __launch_bounds__(kBookThreads) dc_export_seg(Dc d, int* seg_out) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < d.n; i += kBookThreads)
    seg_out[(size_t)b * d.n + i] = d.iv(b, kSeg)[i];
}

struct Launcher {
  Dc d;
  int B;
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;

  void ok() {
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  template <bool TA, int kEpi, int kRange = kBlockDiag>
  void gemm(const float* A, const float* Bm, float* C, const float* aux = nullptr) {
    if (err != cudaSuccess) return;
    const dim3 grid((d.n + kTile - 1) / kTile, (d.n + kTile - 1) / kTile, B);
    if (d.n % 4 == 0)
      dc_gemm<TA, kEpi, kRange, true><<<grid, kTileThreads, 0, stream>>>(d, A, Bm, C, aux);
    else
      dc_gemm<TA, kEpi, kRange, false><<<grid, kTileThreads, 0, stream>>>(d, A, Bm, C, aux);
    ok();
  }
  template <int kStep>
  void elementwise(float* x, float* y, const float* r = nullptr) {
    if (err != cudaSuccess) return;
    const size_t nn = (size_t)d.n * d.n;
    const dim3 grid((unsigned)((nn + kThreads - 1) / kThreads), B);
    dc_elementwise<kStep><<<grid, kThreads, 0, stream>>>(d, x, y, r);
    ok();
  }
  template <int kKind>
  void col_reduce(const float* X) {
    if (err != cudaSuccess) return;
    dc_col_reduce<kKind><<<dim3((d.n + kColThreads - 1) / kColThreads, B), kColThreads, 0,
                           stream>>>(d, X);
    ok();
  }
  void row_abs(const float* Y) {
    if (err != cudaSuccess) return;
    dc_row_abs<<<dim3((d.n + kWarps - 1) / kWarps, B), kThreads, 0, stream>>>(d, Y);
    ok();
  }
  template <class K, class... Args>
  void per_matrix(K kernel, Args... args) {
    if (err != cudaSuccess) return;
    kernel<<<B, kBookThreads, 0, stream>>>(d, args...);
    ok();
  }
  void copy(float* dst, const float* src) {
    if (err != cudaSuccess) return;
    const size_t total = (size_t)B * d.n * d.n;
    dc_copy<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(dst, src,
                                                                                  total);
    ok();
  }
  // cubic polar steps Q <- 1.5 Q - 0.5 Q (Q^T Q); Q ends in one of (Q, Qn),
  // the other is scratch
  void polar_cubic(float*& Q, float*& Qn, float* Gm, int steps) {
    for (int it = 0; it < steps; ++it) {
      gemm<true, kStore>(Q, Q, Gm);
      gemm<false, kCubic>(Q, Gm, Qn, Q);
      float* t = Q;
      Q = Qn;
      Qn = t;
    }
  }
};

}  // namespace

// Plain C entry for ctypes.  a, g (and t when given): (B, n, n) contiguous
// f32 on the device; om: (n, n) f32; seg (when given): (B, n) int32; work:
// 6 * B * n * n f32 of scratch; ivec: B * 6 * n int32, fvec: B * 5 * n f32
// of scratch.  a, g, t and work are distinct buffers.  1 <= B <= 65535,
// 1 <= n <= 1024, 0 <= levels <= 24.  t and seg may be null.  Puts the
// whole sequence on the stream; returns a cudaError_t (0 on success).
extern "C" int dc_precondition_f32(const float* a, const float* om, float* g, float* t,
                                   int* seg, float* work, int* ivec, float* fvec, int B,
                                   int n, int levels, int min_seg, int refine,
                                   void* stream) {
  if (B <= 0 || B > 65535 || n < 1 || n > kMaxN || levels < 0 || levels > 24 ||
      min_seg < 0 || refine < 0)
    return (int)cudaErrorInvalidValue;
  Launcher run{Dc{ivec, fvec, n, min_seg}, B, (cudaStream_t)stream};
  const size_t plane = (size_t)B * n * n;
  float* T = work;
  float* S0 = work + plane;
  float* S1 = work + 2 * plane;
  float* S2 = work + 3 * plane;
  float* S3 = work + 4 * plane;
  float* S4 = work + 5 * plane;

  run.elementwise<kInit>(T, g, a);
  for (int level = 0; level < levels; ++level) {
    // ---- segments, band ranges, medians, bounds, the sign's start ----
    run.per_matrix(dc_stats, (const float*)T);
    run.col_reduce<kColAbsC>(T);
    run.per_matrix(dc_bound);
    float* X = S0;
    float* Xn = S3;
    run.elementwise<kSignInit>(X, T);

    // ---- E ~ sign(X) ----
    for (int it = 0; it < kQuinticSign; ++it) {
      run.gemm<false, kStore>(X, X, S1);
      run.gemm<false, kQuinticW>(S1, S1, S2, S1);
      run.gemm<false, kMask>(X, S2, Xn);
      float* tmp = X;
      X = Xn;
      Xn = tmp;
    }
    for (int it = 0; it < kCubicSign; ++it) {
      run.gemm<false, kStore>(X, X, S1);
      run.gemm<false, kCubicLive>(X, S1, Xn, X);
      float* tmp = X;
      X = Xn;
      Xn = tmp;
    }
    // ---- P = (I - sym(E)) / 2 on the live segments, in X's plane ----
    float* P = X;
    run.elementwise<kProjector>(P, P);
    run.per_matrix(dc_slots, (const float*)P);

    // ---- probe, blended slot columns, scaling ----
    float* Q = Xn;  // omega masked to the segments, then Y, then Q
    run.elementwise<kProbe>(Q, Q, om);
    run.gemm<false, kStore>(P, Q, S1);
    run.elementwise<kBlend>(Q, S1);
    run.col_reduce<kColNorm2>(Q);
    run.elementwise<kDivColn>(Q, Q);
    run.row_abs(Q);
    run.col_reduce<kColAbs>(Q);
    run.per_matrix(dc_scale);
    run.elementwise<kDivScale>(Q, Q);

    // ---- Q = polar factor ----
    float* Qn = S4;
    for (int it = 0; it < kQuinticPolar; ++it) {
      run.gemm<true, kStore>(Q, Q, S1);
      run.gemm<false, kQuinticW>(S1, S1, S2, S1);
      run.gemm<false, kStore>(Q, S2, Qn);
      float* tmp = Q;
      Q = Qn;
      Qn = tmp;
    }
    run.polar_cubic(Q, Qn, S1, kCubicPolar);

    // ---- refinement: re-project through P, re-orthonormalise ----
    for (int pass = 0; pass < refine; ++pass) {
      run.gemm<false, kStore>(P, Q, S1);
      run.elementwise<kRefine>(Q, S1);
      run.col_reduce<kColNorm2>(Q);
      run.elementwise<kDivColn>(Q, Q);
      run.polar_cubic(Q, Qn, S1, kCubicRefine);
    }

    // ---- T <- sym(Q^T T Q), G0 <- Q^T G0, split the segments ----
    run.gemm<false, kStore, kColBand>(T, Q, S1);
    run.gemm<true, kStore, kRowBand>(Q, S1, S2);
    run.elementwise<kSymT>(T, S2);
    run.gemm<true, kStore, kRowBand>(Q, g, S1);
    run.copy(g, S1);
    run.per_matrix(dc_split);
  }
  if (t != nullptr) run.copy(t, T);
  if (seg != nullptr) run.per_matrix(dc_export_seg, seg);
  return (int)run.err;
}
