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
// What bounds it on the H100: operations.  74 * levels * 2 n^3 float32
// operations a matrix against a, omega, G0 read or written once: at
// (64, 256, 256) and 8 levels 1.27 TFLOP against 50 MB.
//
// Design.  What the TPU kernel was shaped by (no transposes, every vector in
// row and in column orientation, masks as (n, n) planes, ~10 planes resident
// in fast memory) does not carry over.  Here a matrix's planes (T, five
// scratch planes, the output) do not fit the 227 KB of shared memory, so
// they live in a workspace in device memory that the wrapper allocates, and
// shared memory holds the tiles of the product and the segment bookkeeping:
// a handful of length-n vectors (segment id, size, start, low flag, and
// float scratch for diagonal, median, bounds, norms), computed with O(n^2)
// comparison loops.  Masks are predicates in the epilogue of a product,
// never planes.  One persistent launch, one block of 256 threads a matrix,
// which runs the whole level loop; the products are a device function
// (csrc/dc_common.cuh, shared with the per-level kernel csrc/dc_level.cu:
// 128 x 128 output tile, 8-deep k tiles staged through registers, 8 x 8
// outputs a thread, C = op(A) B with op = identity or transpose, fused
// epilogues), with __syncthreads() between steps.  All accumulation is
// IEEE float32 multiply-adds (no TF32), so that the rounded ranks and slot
// assignments agree with the plain PyTorch version.
//
// Rejected: a batched product kernel launched ~600 times over B x tiles.
// It would fill all 132 SMs where this fills B of them, but it pays ~600
// launches and as many host-side elementwise passes for the bookkeeping
// between products, and splits the algorithm between host and device.
#include "dc_common.cuh"

namespace {

constexpr int kMaxN = 1024;  // length of the bookkeeping vectors
constexpr int kPlanes = 6;   // workspace planes a matrix: T and five scratch

constexpr float kBeta = 0.002f;  // rank-safety probe blend
constexpr int kQuinticSign = 8, kCubicSign = 3;
constexpr int kQuinticPolar = 10, kCubicPolar = 5, kCubicRefine = 3;

// Segment bookkeeping of one matrix and the product's tiles.
struct Shared {
  int seg[kMaxN];    // segment id of a position
  int size[kMaxN];   // size of its segment
  int start[kMaxN];  // first position of its segment
  int low[kMaxN];    // rank inside the segment, later the low-slot flag
  float v0[kMaxN], v1[kMaxN], v2[kMaxN], v3[kMaxN];
  Tiles t;
  int min_seg;
};

// 1 inside a live segment's diagonal block, else 0
__device__ __forceinline__ float live_mask(const Shared& s, int i, int j) {
  return (s.seg[i] == s.seg[j] && s.size[i] > s.min_seg) ? 1.0f : 0.0f;
}

__device__ __forceinline__ bool frozen(const Shared& s, int i) {
  return s.size[i] <= s.min_seg;
}

// (X W) masked to the live segments
struct EpiMask {
  const Shared* s;
  __device__ float operator()(int i, int j, float acc) const {
    return acc * live_mask(*s, i, j);
  }
};
// 1.5 X - 0.5 (X X2) masked to the live segments
struct EpiCubicLive {
  const float* X;
  int n;
  const Shared* s;
  __device__ float operator()(int i, int j, float acc) const {
    return (1.5f * X[(size_t)i * n + j] - 0.5f * acc) * live_mask(*s, i, j);
  }
};

// C = op(A) B on row-major (n, n) planes in device memory, op = transpose
// when TA, one output tile after the other (csrc/dc_common.cuh).  C is
// neither A nor B.  Every thread of the block calls it; it ends on a
// barrier, so C is visible to the block on return.
template <bool TA, class Epi>
__device__ void gemm(const float* A, const float* B, float* C, int n, Epi epi,
                     Shared& s) {
  for (int bm = 0; bm < n; bm += BM)
    for (int bn = 0; bn < n; bn += BN) gemm_tile<TA>(A, B, C, n, bm, bn, epi, s.t);
  __syncthreads();
}

// out_j = sum_i f(i, j) for every column j (a thread a column: coalesced)
template <class F>
__device__ __forceinline__ void col_reduce(float* out, int n, F f) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc += f(i, j);
    out[j] = acc;
  }
}

// out_i = sum_j f(i, j) for every row i (a warp a row: coalesced)
template <class F>
__device__ __forceinline__ void row_reduce(float* out, int n, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kWarps) {
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) acc += f(i, j);
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// out_i = max over the positions j of i's segment of v_j (v >= 0)
__device__ __forceinline__ void seg_max(float* out, const float* v, const Shared& s,
                                        int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float m = 0.0f;
    for (int j = 0; j < n; ++j)
      if (s.seg[j] == s.seg[i]) m = fmaxf(m, v[j]);
    out[i] = m;
  }
}

// Y_ij <- Y_ij / (coln_j + 1e-20), coln_j the column 2-norms (uses s.v0)
__device__ __forceinline__ void normalize_columns(float* Y, int n, Shared& s) {
  const int tid = threadIdx.x;
  col_reduce(s.v0, n, [&](int i, int j) {
    const float y = Y[(size_t)i * n + j];
    return y * y;
  });
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += kThreads)
    Y[idx] = Y[idx] / (sqrtf(s.v0[idx % n]) + 1e-20f);
  __syncthreads();
}

// cubic polar steps Q <- 1.5 Q - 0.5 Q (Q^T Q); returns the plane that
// holds Q, the other of (Q, Qn) is scratch
__device__ __forceinline__ void polar_cubic(float*& Q, float*& Qn, float* Gm, int n,
                                            int steps, Shared& s) {
  for (int it = 0; it < steps; ++it) {
    gemm<true>(Q, Q, Gm, n, EpiStore{}, s);
    gemm<false>(Q, Gm, Qn, n, EpiCubic{Q, n}, s);
    float* t = Q;
    Q = Qn;
    Qn = t;
  }
}

__global__ void __launch_bounds__(kThreads)
dc_kernel(const float* __restrict__ a_g, const float* __restrict__ om, float* g_g,
          float* t_g, int* seg_g, float* work_g, int n, int levels, int min_seg,
          int refine) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int nn = n * n;
  const float* a = a_g + (size_t)blockIdx.x * nn;
  float* G = g_g + (size_t)blockIdx.x * nn;
  float* W = work_g + (size_t)blockIdx.x * kPlanes * nn;
  float* T = W;
  float* S0 = W + nn;
  float* S1 = W + 2 * nn;
  float* S2 = W + 3 * nn;
  float* S3 = W + 4 * nn;
  float* S4 = W + 5 * nn;

  if (tid == 0) s.min_seg = min_seg;
  for (int i = tid; i < n; i += kThreads) s.seg[i] = 0;
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, j = idx % n;
    G[idx] = a[idx];
    T[idx] = 0.5f * (a[idx] + a[(size_t)j * n + i]);
  }
  __syncthreads();

  for (int level = 0; level < levels; ++level) {
    // ---- segment sizes and starts ----
    for (int i = tid; i < n; i += kThreads) {
      int size = 0, start = 0;
      const int si = s.seg[i];
      for (int j = 0; j < n; ++j) {
        size += s.seg[j] == si;
        start += s.seg[j] < si;
      }
      s.size[i] = size;
      s.start[i] = start;
      s.v0[i] = T[(size_t)i * n + i];  // diagonal
    }
    __syncthreads();
    // ---- rank of each diagonal entry inside its segment, ties by index ----
    for (int j = tid; j < n; j += kThreads) {
      int rank = 0;
      const float dj = s.v0[j];
      for (int i = 0; i < n; ++i) {
        const float di = s.v0[i];
        rank += (s.seg[i] == s.seg[j]) && (di < dj || (di == dj && i < j));
      }
      s.low[j] = rank;
    }
    __syncthreads();
    // ---- median of the segment: mean of the two middle ranks ----
    for (int i = tid; i < n; i += kThreads) {
      const int lo_t = (s.size[i] - 1) / 2, hi_t = s.size[i] / 2;
      float lo = 0.0f, hi = 0.0f;
      for (int j = 0; j < n; ++j) {
        if (s.seg[j] != s.seg[i]) continue;
        if (s.low[j] == lo_t) lo += s.v0[j];
        if (s.low[j] == hi_t) hi += s.v0[j];
      }
      s.v1[i] = 0.5f * (lo + hi);  // sigma
    }
    __syncthreads();
    // ---- C = T * [same segment] - sigma I; column 1-norms; segment bound ----
    auto c_entry = [&](int i, int j) {
      const float eq = s.seg[i] == s.seg[j] ? 1.0f : 0.0f;
      return T[(size_t)i * n + j] * eq - (i == j ? s.v1[i] : 0.0f);
    };
    col_reduce(s.v2, n, [&](int i, int j) { return fabsf(c_entry(i, j)); });
    __syncthreads();
    seg_max(s.v3, s.v2, s, n);
    __syncthreads();
    float* X = S0;
    float* Xn = S3;
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int i = idx / n, j = idx % n;
      X[idx] = c_entry(i, j) / (1.01f * s.v3[i] + 1e-30f);
    }
    __syncthreads();

    // ---- E ~ sign(X) ----
    for (int it = 0; it < kQuinticSign; ++it) {
      gemm<false>(X, X, S1, n, EpiStore{}, s);
      gemm<false>(S1, S1, S2, n, EpiQuinticW{S1, n}, s);
      gemm<false>(X, S2, Xn, n, EpiMask{&s}, s);
      float* t = X;
      X = Xn;
      Xn = t;
    }
    for (int it = 0; it < kCubicSign; ++it) {
      gemm<false>(X, X, S1, n, EpiStore{}, s);
      gemm<false>(X, S1, Xn, n, EpiCubicLive{X, n, &s}, s);
      float* t = X;
      X = Xn;
      Xn = t;
    }
    // ---- P = (I - sym(E)) / 2 on the live segments, in X's plane ----
    float* P = X;
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int i = idx / n, j = idx % n;
      if (i > j) continue;
      const float e = 0.5f * (X[idx] + X[(size_t)j * n + i]);
      const float lv = (frozen(s, i) || frozen(s, j)) ? 0.0f : 1.0f;
      const float p = 0.5f * ((i == j ? 1.0f : 0.0f) - e) * lv;
      P[idx] = p;
      P[(size_t)j * n + i] = p;
    }
    __syncthreads();
    // ---- slot assignment: r = round(trace of the segment's block of P) ----
    for (int i = tid; i < n; i += kThreads) s.v0[i] = P[(size_t)i * n + i];
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      float tr = 0.0f;
      for (int j = 0; j < n; ++j)
        if (s.seg[j] == s.seg[i]) tr += s.v0[j];
      int r = (int)rintf(tr);  // half to even
      r = min(max(r, 0), s.size[i]);
      s.low[i] = ((i - s.start[i]) < r && !frozen(s, i)) ? 1 : 0;
    }
    __syncthreads();
    // ---- probe, blended slot columns, scaling ----
    float* Q = Xn;       // omega masked to the segments, then Y, then Q
    float* POm = S1;
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int i = idx / n, j = idx % n;
      const float fro = (frozen(s, i) || frozen(s, j)) ? 1.0f : 0.0f;
      const float eq = s.seg[i] == s.seg[j] ? 1.0f : 0.0f;
      Q[idx] = (fro * (i == j ? 1.0f : 0.0f) + (1.0f - fro) * om[idx]) * eq;
    }
    __syncthreads();
    gemm<false>(P, Q, POm, n, EpiStore{}, s);
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int j = idx % n;
      const float omb = Q[idx], pom = POm[idx];
      Q[idx] = (1.0f - kBeta) * (s.low[j] ? pom : omb - pom) + kBeta * omb;
    }
    __syncthreads();
    normalize_columns(Q, n, s);
    row_reduce(s.v1, n, [&](int i, int j) { return fabsf(Q[(size_t)i * n + j]); });
    col_reduce(s.v2, n, [&](int i, int j) { return fabsf(Q[(size_t)i * n + j]); });
    __syncthreads();
    seg_max(s.v0, s.v1, s, n);  // largest row sum of the segment
    seg_max(s.v3, s.v2, s, n);  // largest column sum of the segment
    __syncthreads();
    for (int j = tid; j < n; j += kThreads)
      s.v1[j] = 1.01f * sqrtf(s.v0[j] * s.v3[j]) + 1e-30f;
    __syncthreads();
    for (int idx = tid; idx < nn; idx += kThreads) Q[idx] = Q[idx] / s.v1[idx % n];
    __syncthreads();

    // ---- Q = polar factor ----
    float* Qn = S4;
    for (int it = 0; it < kQuinticPolar; ++it) {
      gemm<true>(Q, Q, S1, n, EpiStore{}, s);
      gemm<false>(S1, S1, S2, n, EpiQuinticW{S1, n}, s);
      gemm<false>(Q, S2, Qn, n, EpiStore{}, s);
      float* t = Q;
      Q = Qn;
      Qn = t;
    }
    polar_cubic(Q, Qn, S1, n, kCubicPolar, s);

    // ---- refinement: re-project through P, re-orthonormalise ----
    for (int pass = 0; pass < refine; ++pass) {
      gemm<false>(P, Q, S1, n, EpiStore{}, s);
      for (int idx = tid; idx < nn; idx += kThreads) {
        const int i = idx / n, j = idx % n;
        const float pq = S1[idx];
        float q = s.low[j] ? pq : Q[idx] - pq;
        // frozen segments keep their identity columns
        if (frozen(s, i) || frozen(s, j))
          q = (i == j) ? 1.0f : 0.0f;
        Q[idx] = q;
      }
      __syncthreads();
      normalize_columns(Q, n, s);
      polar_cubic(Q, Qn, S1, n, kCubicRefine, s);
    }

    // ---- T <- sym(Q^T T Q), G0 <- Q^T G0, split the segments ----
    gemm<false>(T, Q, S1, n, EpiStore{}, s);
    gemm<true>(Q, S1, S2, n, EpiStore{}, s);
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int i = idx / n, j = idx % n;
      T[idx] = 0.5f * (S2[idx] + S2[(size_t)j * n + i]);
    }
    gemm<true>(Q, G, S1, n, EpiStore{}, s);
    for (int idx = tid; idx < nn; idx += kThreads) G[idx] = S1[idx];
    for (int i = tid; i < n; i += kThreads)
      s.seg[i] = s.seg[i] * 2 + ((s.low[i] || frozen(s, i)) ? 0 : 1);
    __syncthreads();
  }

  if (t_g != nullptr)
    for (int idx = tid; idx < nn; idx += kThreads)
      t_g[(size_t)blockIdx.x * nn + idx] = T[idx];
  if (seg_g != nullptr)
    for (int i = tid; i < n; i += kThreads) seg_g[(size_t)blockIdx.x * n + i] = s.seg[i];
}

}  // namespace

// Plain C entry for ctypes.  a, g (and t when given): (B, n, n) contiguous
// f32 on the device; om: (n, n) f32; seg (when given): (B, n) int32; work:
// B * 6 * n * n f32 of scratch.  a, g, t and work are distinct buffers.
// 1 <= n <= 1024, 0 <= levels <= 24.  t and seg may be null.  Returns a
// cudaError_t (0 on success).
extern "C" int dc_precondition_f32(const float* a, const float* om, float* g,
                                   float* t, int* seg, float* work, int B, int n,
                                   int levels, int min_seg, int refine,
                                   void* stream) {
  if (B <= 0 || n < 1 || n > kMaxN || levels < 0 || levels > 24 || min_seg < 0 ||
      refine < 0)
    return (int)cudaErrorInvalidValue;
  dc_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(a, om, g, t, seg, work, n,
                                                       levels, min_seg, refine);
  return (int)cudaGetLastError();
}
