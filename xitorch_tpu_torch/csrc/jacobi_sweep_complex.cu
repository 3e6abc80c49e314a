// Batched one-sided (Hestenes) Jacobi sweeps on a complex row panel, held
// as packed real planes [Re G^T | Im G^T].
//
// Replaces: xitorch_tpu/ops/jacobi_eigh.py::_jacobi_kernel_complex (the
// Pallas TPU kernel behind _pallas_g_panel, complexpair=True).
//
// What it computes, per matrix of the batch: G := the (n, width) input
// panel, whose row i is the complex vector g_i packed as its real half then
// its imaginary half (width = 2 * half-width); then sweeps of Brent-Luk
// round-robin row-pair rotations that orthogonalise the rows of G under
// the hermitian inner product.  One pair (p, q): gamma = <g_p, g_q> by two
// reductions (re = rp.rq + ip.iq, im = rp.iq - ip.rq); the bottom row is
// phase-aligned, g_q <- exp(-i arg gamma) g_q, so that the pair's inner
// product becomes the real |gamma| and the rotation itself is real and
// applies to both planes; (c, s) from |gamma| and the carried squared
// norms, the norms updated analytically with 2 c s |gamma|.  A pair that
// is already orthogonal (or zero) is left untouched, phase included.  The
// norms are refreshed by a full reduction once per sweep; before the first
// sweep and after each one the hermitian gauge
//     max_{i<j} (re^2 + im^2) / max(|g_i|^2 |g_j|^2, 16 tiny)
// is measured in IEEE float32, and the loop runs while
// sweep < max_sweeps and gauge > tol^2.  Every matrix has its own exit and
// its own sweep count.
//
// What bounds it on the H100: as the real kernel (csrc/jacobi_sweep.cu), the
// bandwidth and latency of the memory that holds the panel.  A sweep moves
// ~2 n^2 width floats through it and does ~5 n^2 width multiply-adds (two
// reductions, the phase and the rotation, on twice the real width); the
// rounds are serial, one block-wide barrier each.
//
// Design: that of the real kernel.  One thread block of 16 warps per matrix;
// the panel in dynamic shared memory when it fits the 227 KB a block may opt
// in to, else in the output buffer in device memory (64 hermitian 256 x 256
// matrices are 64 panels of 512 KB: 32 MB, inside the 50 MB L2); rows never
// move, the tournament is a ring of players; a warp owns a pair for a round
// and keeps both rows in registers for half-widths up to 512; the rotation
// in the tau = s / (1 + c) form and c = 1 / sqrtf(1 + t^2) in IEEE rounding,
// for the drift of G^H G that the real kernel's notes record; the gauge on
// the upper triangle only, a warp keeping row i in registers and taking the
// two reductions against every row j > i.
#include "jacobi_common.cuh"

namespace {

// A packed row as one lane sees it: NV float4 values of each half in
// registers (NV = 0: nothing cached, the row is read again where needed).
template <int NV>
struct CRow {
  float4 re[NV > 0 ? NV : 1];
  float4 im[NV > 0 ? NV : 1];
};

template <int NV>
__device__ __forceinline__ void load_row(const float4* p, int hw4, int lane,
                                         CRow<NV>& r) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      const bool in = idx < hw4;
      r.re[k] = in ? p[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
      r.im[k] = in ? p[hw4 + idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// one lane's share of <x, y> = sum conj-paired products: re += xr.yr + xi.yi,
// im += xr.yi - xi.yr
__device__ __forceinline__ void herm4(const float4& xr, const float4& xi,
                                      const float4& yr, const float4& yi,
                                      float& re, float& im) {
  re += dot4(xr, yr) + dot4(xi, yi);
  im += dot4(xr, yi) - dot4(xi, yr);
}

// <row, q> over the whole warp; `row` is p's cached copy (NV > 0) or p is
// read again (NV = 0).  Every lane returns the same sums.
template <int NV>
__device__ __forceinline__ void herm_row(const CRow<NV>& row, const float4* p,
                                         const float4* q, int hw4, int lane,
                                         float& re, float& im) {
  float ar = 0.f, ai = 0.f;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < hw4) herm4(row.re[k], row.im[k], q[idx], q[hw4 + idx], ar, ai);
    }
  } else {
    for (int idx = lane; idx < hw4; idx += 32)
      herm4(p[idx], p[hw4 + idx], q[idx], q[hw4 + idx], ar, ai);
  }
  re = warp_sum(ar);
  im = warp_sum(ai);
}

// gamma = <p, q>, keeping both rows in registers when NV > 0
template <int NV>
__device__ __forceinline__ void pair_dot(const float4* p, const float4* q, int hw4,
                                         int lane, CRow<NV>& rp, CRow<NV>& rq,
                                         float& re, float& im) {
  float ar = 0.f, ai = 0.f;
  if constexpr (NV > 0) {
    load_row<NV>(p, hw4, lane, rp);
    load_row<NV>(q, hw4, lane, rq);
#pragma unroll
    for (int k = 0; k < NV; ++k) herm4(rp.re[k], rp.im[k], rq.re[k], rq.im[k], ar, ai);
  } else {
    for (int idx = lane; idx < hw4; idx += 32)
      herm4(p[idx], p[hw4 + idx], q[idx], q[hw4 + idx], ar, ai);
  }
  re = warp_sum(ar);
  im = warp_sum(ai);
}

// a x + b y, componentwise
__device__ __forceinline__ float4 axpby(float a, const float4& x, float b,
                                        const float4& y) {
  return make_float4(a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z,
                     a * x.w + b * y.w);
}

// phase-align q by (ph_c, ph_s) = exp(-i arg gamma) and rotate the pair:
// one float4 of each half of each row (the real rotation is rot4 of
// jacobi_common.cuh, in the tau form that never rounds 1 - c away)
__device__ __forceinline__ void rot_pair4(float4* p, float4* q, int hw4, int idx,
                                          const float4& xr, const float4& xi,
                                          const float4& yr, const float4& yi,
                                          float ph_c, float ph_s, float s,
                                          float tau) {
  const float4 qr = axpby(ph_c, yr, ph_s, yi);
  const float4 qi = axpby(ph_c, yi, -ph_s, yr);
  float4 np, nq;
  rot4(xr, qr, s, tau, np, nq);
  p[idx] = np;
  q[idx] = nq;
  rot4(xi, qi, s, tau, np, nq);
  p[hw4 + idx] = np;
  q[hw4 + idx] = nq;
}

template <int NV>
__device__ __forceinline__ void rotate(float4* p, float4* q, int hw4, int lane,
                                       const CRow<NV>& rp, const CRow<NV>& rq,
                                       float ph_c, float ph_s, float s, float tau) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < hw4)
        rot_pair4(p, q, hw4, idx, rp.re[k], rp.im[k], rq.re[k], rq.im[k], ph_c,
                  ph_s, s, tau);
    }
  } else {
    for (int idx = lane; idx < hw4; idx += 32)
      rot_pair4(p, q, hw4, idx, p[idx], p[hw4 + idx], q[idx], q[hw4 + idx], ph_c,
                ph_s, s, tau);
  }
}

// |g_i|^2 = sum of squares over the whole packed row
__device__ __forceinline__ void refresh_norms(const float4* G, float* nrm, int n,
                                              int w4, int warp, int lane) {
  for (int i = warp; i < n; i += kWarps) {
    const float4* row = G + (size_t)i * w4;
    float acc = 0.f;
    for (int idx = lane; idx < w4; idx += 32) acc += dot4(row[idx], row[idx]);
    acc = warp_sum(acc);
    if (lane == 0) nrm[i] = acc;
  }
}

// max over i < j of |<g_i, g_j>|^2 / max(n_i n_j, floor); every thread of
// the block returns the same value
template <int NV>
__device__ __forceinline__ float gauge(const float4* G, const float* nrm,
                                       float* red, int n, int hw4, int warp,
                                       int lane) {
  const int w4 = 2 * hw4;
  float worst = 0.f;
  for (int i = warp; i < n - 1; i += kWarps) {
    const float ni = nrm[i];
    if (ni == 0.f) continue;  // a zero row: every product with it is exactly 0
    const float4* row = G + (size_t)i * w4;
    CRow<NV> r;
    load_row<NV>(row, hw4, lane, r);
    for (int j = i + 1; j < n; ++j) {
      const float nj = nrm[j];
      if (nj == 0.f) continue;
      float re, im;
      herm_row<NV>(r, row, G + (size_t)j * w4, hw4, lane, re, im);
      worst = fmaxf(worst, (re * re + im * im) / fmaxf(ni * nj, kEpsFloor));
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
jacobi_sweep_complex_kernel(const float* __restrict__ a_g, float* g_g,
                            int* sweeps_g, float* gauge_g, int* rot_g, int n,
                            int width, int max_sweeps, float tol2,
                            float live_thresh, int use_smem) {
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
  const int hw4 = w4 / 2;
  const size_t count = (size_t)n * w4;
  const float4* src = reinterpret_cast<const float4*>(a_g) + blockIdx.x * count;
  float4* out = reinterpret_cast<float4*>(g_g) + blockIdx.x * count;
  float4* G = use_smem ? panel_smem : out;

  for (size_t i = tid; i < count; i += kThreads) G[i] = src[i];
  if (tid == 0) rotations = 0;
  __syncthreads();

  refresh_norms(G, nrm, n, w4, warp, lane);
  __syncthreads();
  float worst = gauge<NV>(G, nrm, red, n, hw4, warp, lane);

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
        CRow<NV> rp, rq;
        float g_re, g_im;
        pair_dot<NV>(p, q, hw4, lane, rp, rq, g_re, g_im);
        const float a = nrm[pi];
        const float b = nrm[qi];
        __syncwarp();  // every lane has read the norms before lane 0 rewrites them
        const float gam2 = g_re * g_re + g_im * g_im;
        const float ratio = gam2 / fmaxf(a * b, kEpsFloor);
        if (!(ratio > live_thresh)) continue;  // already orthogonal, or zero
        const float gam = sqrtf(gam2);
        // the phase exp(-i arg gamma); identity when |gamma| is at the floor
        // (dividing by a floored |gamma| would zero the bottom row)
        const bool safe = gam > kEpsFloor;
        const float inv = 1.0f / fmaxf(gam, kEpsFloor);
        const float ph_c = safe ? g_re * inv : 1.0f;
        const float ph_s = safe ? g_im * inv : 0.0f;
        const float zeta = (b - a) / (2.0f * gam);
        const float t = (zeta >= 0.f ? 1.0f : -1.0f) /
                        (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
        // 1/sqrt in IEEE rounding, not the approximate rsqrtf
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = c * t;
        rotate<NV>(p, q, hw4, lane, rp, rq, ph_c, ph_s, s, s / (1.0f + c));
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
    refresh_norms(G, nrm, n, w4, warp, lane);
    __syncthreads();
    worst = gauge<NV>(G, nrm, red, n, hw4, warp, lane);
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
        jacobi_sweep_complex_kernel<NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  jacobi_sweep_complex_kernel<NV><<<B, kThreads, smem, stream>>>(
      a, g, sweeps, gauge_out, rot, n, width, max_sweeps, tol2, live_thresh,
      use_smem);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  a, g: (B, n, width) contiguous f32 on the
// device, distinct buffers; a row is [Re | Im], each half width / 2 floats
// and a multiple of 4, so width is a multiple of 8; n even and <= 1024.
// sweeps (B,) int32, gauge (B,) f32 and rot (B,) int32 receive each matrix's
// executed sweep count, last measured gauge and number of pairs rotated.
// smem_limit: the largest panel (bytes) to keep in shared memory (0 forces
// the device-memory path).  Returns a cudaError_t (0 on success).
extern "C" int jacobi_sweep_c32(const float* a, float* g, int* sweeps,
                                float* gauge_out, int* rot, int B, int n,
                                int width, int max_sweeps, float tol2,
                                float live_thresh, int smem_limit, void* stream) {
  if (B <= 0 || n < 2 || (n & 1) || n > kMaxN || width < 8 || (width & 7) ||
      max_sweeps < 0 || smem_limit < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nv = (width / 8 + 31) / 32;  // float4 values of a half a lane
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
  else
    e = launch<0>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                  live_thresh, lim, s);
  return (int)e;
}
