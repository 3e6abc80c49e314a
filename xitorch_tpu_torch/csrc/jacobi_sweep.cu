// Batched one-sided (Hestenes) Jacobi sweeps on a row panel G^T.
//
// Replaces: xitorch_tpu/ops/jacobi_eigh.py::_jacobi_kernel (the Pallas TPU
// kernel behind _pallas_g_panel, complexpair=False).
//
// What it computes, per matrix of the batch: G := the (n, width) input
// panel; then sweeps of Brent-Luk round-robin row-pair rotations that
// orthogonalise the rows of G, with the squared row norms carried through
// every rotation analytically and refreshed by a full reduction once per
// sweep; before the first sweep and after each one the gauge
//     max_{i<j} <g_i, g_j>^2 / max(|g_i|^2 |g_j|^2, 16 tiny)
// is measured in IEEE float32, and the loop runs while
// sweep < max_sweeps and gauge > tol^2.  A panel that is already
// orthogonal leaves with zero sweeps.  Every matrix has its own exit and
// its own sweep count.
//
// What bounds it on the H100: a sweep rotates each of the n/2 pairs in
// each of its ~n rounds, touching the whole panel once per round, so a
// sweep moves ~2 n^2 width floats through the memory that holds the panel
// and does ~3 n^2 width multiply-adds; the rounds are serial (one block-
// wide barrier each).  It is bound by the bandwidth and latency of the
// memory that holds the panel, not by device memory: the input is read
// once and the output written once.
//
// Design: one thread block of 16 warps per matrix.  The panel stays in
// dynamic shared memory when it fits the 227 KB a block may opt in to,
// and otherwise in the output buffer in device memory (a batch of 64
// panels of 256 KB is 16 MB and stays in the 50 MB L2).  Rows never move:
// the tournament is a ring of players, and which row sits in which seat
// in round r is computed from r, so the output keeps the input's row
// order.  A warp owns a pair for a round: it loads both rows (held in
// registers for widths up to 1024), reduces gamma = <g_p, g_q> with warp
// shuffles, forms (c, s) from the carried norms as the reference does
// (c = 1/sqrt(1 + t^2) in IEEE rounding, s = c t), skips the pair
// when it is already orthogonal, else writes both rotated rows (in the
// form that never rounds 1 - c away, see rot4) and the two updated norms.
// One __syncthreads per round.  The gauge takes the upper triangle only: a
// warp keeps row i in registers and dots it with every row j > i.
#include "jacobi_common.cuh"

namespace {

// A row of the panel as one lane sees it: NV float4 values in registers
// (NV = 0: nothing cached, the row is read again where it is needed).
template <int NV>
struct Row {
  float4 v[NV > 0 ? NV : 1];
};

template <int NV>
__device__ __forceinline__ void load_row(const float4* p, int w4, int lane,
                                         Row<NV>& r) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      r.v[k] = idx < w4 ? p[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// <row, q> over the whole warp; `row` is p's cached copy (NV > 0) or p is
// read again (NV = 0).  Every lane returns the same sum.
template <int NV>
__device__ __forceinline__ float dot_row(const Row<NV>& row, const float4* p,
                                         const float4* q, int w4, int lane) {
  float acc = 0.f;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < w4) acc += dot4(row.v[k], q[idx]);
    }
  } else {
    for (int idx = lane; idx < w4; idx += 32) acc += dot4(p[idx], q[idx]);
  }
  return warp_sum(acc);
}

// gamma = <p, q>, keeping both rows in registers when NV > 0
template <int NV>
__device__ __forceinline__ float pair_dot(const float4* p, const float4* q,
                                          int w4, int lane, Row<NV>& rp,
                                          Row<NV>& rq) {
  float acc = 0.f;
  if constexpr (NV > 0) {
    load_row<NV>(p, w4, lane, rp);
    load_row<NV>(q, w4, lane, rq);
#pragma unroll
    for (int k = 0; k < NV; ++k) acc += dot4(rp.v[k], rq.v[k]);
  } else {
    for (int idx = lane; idx < w4; idx += 32) acc += dot4(p[idx], q[idx]);
  }
  return warp_sum(acc);
}

// rotate the pair (p, q) in place
template <int NV>
__device__ __forceinline__ void rotate(float4* p, float4* q, int w4, int lane,
                                       const Row<NV>& rp, const Row<NV>& rq,
                                       float s, float tau) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < w4) {
        float4 np, nq;
        rot4(rp.v[k], rq.v[k], s, tau, np, nq);
        p[idx] = np;
        q[idx] = nq;
      }
    }
  } else {
    for (int idx = lane; idx < w4; idx += 32) {
      float4 np, nq;
      rot4(p[idx], q[idx], s, tau, np, nq);
      p[idx] = np;
      q[idx] = nq;
    }
  }
}

template <int NV>
__device__ __forceinline__ void refresh_norms(const float4* G, float* nrm,
                                              int n, int w4, int warp,
                                              int lane) {
  for (int i = warp; i < n; i += kWarps) {
    const float4* row = G + (size_t)i * w4;
    Row<NV> r;
    load_row<NV>(row, w4, lane, r);
    const float s = dot_row<NV>(r, row, row, w4, lane);
    if (lane == 0) nrm[i] = s;
  }
}

// max over i < j of <g_i, g_j>^2 / max(n_i n_j, floor); every thread of
// the block returns the same value
template <int NV>
__device__ __forceinline__ float gauge(const float4* G, const float* nrm,
                                       float* red, int n, int w4, int warp,
                                       int lane) {
  float worst = 0.f;
  for (int i = warp; i < n - 1; i += kWarps) {
    const float ni = nrm[i];
    if (ni == 0.f) continue;  // a zero row: every dot with it is exactly 0
    const float4* row = G + (size_t)i * w4;
    Row<NV> r;
    load_row<NV>(row, w4, lane, r);
    for (int j = i + 1; j < n; ++j) {
      const float nj = nrm[j];
      if (nj == 0.f) continue;
      const float g = dot_row<NV>(r, row, G + (size_t)j * w4, w4, lane);
      worst = fmaxf(worst, g * g / fmaxf(ni * nj, kEpsFloor));
    }
  }
  if (lane == 0) red[warp] = worst;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is written again by the next gauge
  return m;
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
jacobi_sweep_kernel(const float* __restrict__ a_g, float* g_g, int* sweeps_g,
                    float* gauge_g, int* rot_g, int n, int width, int max_sweeps,
                    float tol2, float live_thresh, int use_smem) {
  extern __shared__ float4 panel_smem[];
  __shared__ float nrm[kMaxN];
  __shared__ float red[kWarps];
  __shared__ int rotations;  // pairs rotated so far (skipped pairs not counted)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = n / 2;
  const int m = n - 1;  // length of the ring
  const int w4 = width / 4;
  const size_t count = (size_t)n * w4;
  const float4* src = reinterpret_cast<const float4*>(a_g) + blockIdx.x * count;
  float4* out = reinterpret_cast<float4*>(g_g) + blockIdx.x * count;
  float4* G = use_smem ? panel_smem : out;

  for (size_t i = tid; i < count; i += kThreads) G[i] = src[i];
  if (tid == 0) rotations = 0;
  __syncthreads();

  refresh_norms<NV>(G, nrm, n, w4, warp, lane);
  __syncthreads();
  float worst = gauge<NV>(G, nrm, red, n, w4, warp, lane);

  const int rounds = (m + kUnroll - 1) / kUnroll * kUnroll;
  int shift = 0;  // rounds played so far, modulo the ring length
  int sweep = 0;
  while (sweep < max_sweeps && worst > tol2) {
    for (int r = 0; r < rounds; ++r) {
      for (int i = warp; i < h; i += kWarps) {
        const int pi = i == 0 ? 0 : ring_player(ring_at(i - 1, shift, m), h, n);
        const int qi = ring_player(ring_at(n - 2 - i, shift, m), h, n);
        float4* p = G + (size_t)pi * w4;
        float4* q = G + (size_t)qi * w4;
        Row<NV> rp, rq;
        const float gam = pair_dot<NV>(p, q, w4, lane, rp, rq);
        const float a = nrm[pi];
        const float b = nrm[qi];
        __syncwarp();  // every lane has read the norms before lane 0 rewrites them
        const float ratio = gam * gam / fmaxf(a * b, kEpsFloor);
        if (!(ratio > live_thresh)) continue;  // already orthogonal, or zero
        const float zeta = (b - a) / (2.0f * gam);
        const float t = (zeta >= 0.f ? 1.0f : -1.0f) /
                        (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
        // 1/sqrt in IEEE rounding, not the approximate rsqrtf: a bias in
        // c^2 + s^2 adds up over the ~n rotations a row sees per sweep
        // (measured: it doubled the drift of G^T G)
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = c * t;
        rotate<NV>(p, q, w4, lane, rp, rq, s, s / (1.0f + c));
        if (lane == 0) {
          const float cs2 = 2.0f * c * s * gam;
          nrm[pi] = c * c * a + s * s * b - cs2;
          nrm[qi] = s * s * a + c * c * b + cs2;
          atomicAdd(&rotations, 1);
        }
      }
      __syncthreads();  // the next round pairs rows other warps just wrote
      shift = shift + 1 == m ? 0 : shift + 1;
    }
    ++sweep;
    refresh_norms<NV>(G, nrm, n, w4, warp, lane);
    __syncthreads();
    worst = gauge<NV>(G, nrm, red, n, w4, warp, lane);
  }

  if (use_smem)
    for (size_t i = tid; i < count; i += kThreads) out[i] = G[i];
  if (tid == 0) {
    sweeps_g[blockIdx.x] = sweep;
    gauge_g[blockIdx.x] = worst;
    rot_g[blockIdx.x] = rotations;
  }
}

template <int NV>
cudaError_t launch(const float* a, float* g, int* sweeps, float* gauge_out,
                   int* rot, int B, int n, int width, int max_sweeps, float tol2,
                   float live_thresh, size_t smem_limit, cudaStream_t stream) {
  const size_t bytes = (size_t)n * width * sizeof(float);
  const int use_smem = bytes <= smem_limit ? 1 : 0;
  const size_t smem = use_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        jacobi_sweep_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  jacobi_sweep_kernel<NV><<<B, kThreads, smem, stream>>>(
      a, g, sweeps, gauge_out, rot, n, width, max_sweeps, tol2, live_thresh,
      use_smem);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  a, g: (B, n, width) contiguous f32 on the
// device, distinct buffers, n even and <= 1024, width a multiple of 4;
// sweeps (B,) int32, gauge (B,) f32 and rot (B,) int32 receive each matrix's
// executed sweep count, last measured gauge and number of pairs rotated.  smem_limit: the largest panel (bytes)
// to keep in shared memory (0 forces the device-memory path).  Returns a
// cudaError_t (0 on success).
extern "C" int jacobi_sweep_f32(const float* a, float* g, int* sweeps,
                                float* gauge_out, int* rot, int B, int n,
                                int width, int max_sweeps, float tol2, float live_thresh,
                                int smem_limit, void* stream) {
  if (B <= 0 || n < 2 || (n & 1) || n > kMaxN || width < 4 || (width & 3) ||
      max_sweeps < 0 || smem_limit < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nv = (width / 4 + 31) / 32;
  const size_t lim = (size_t)smem_limit;
  cudaError_t e;
  if (nv <= 1)
    e = launch<1>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                  live_thresh, lim, s);
  else if (nv <= 2)
    e = launch<2>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                  live_thresh, lim, s);
  else if (nv <= 4)
    e = launch<4>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                  live_thresh, lim, s);
  else if (nv <= 8)
    e = launch<8>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                  live_thresh, lim, s);
  else
    e = launch<0>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                  live_thresh, lim, s);
  return (int)e;
}
