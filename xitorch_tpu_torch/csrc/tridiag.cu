// Batched tridiagonal solve by the non-pivoting Thomas algorithm.
//
// Replaces: xitorch_tpu/ops/tridiag.py::_thomas_kernel (the Pallas TPU
// kernel behind tridiag_solve_pallas).
//
// What bounds it on the H100: each system is a serial recurrence of n
// steps forward (an FMA, then two IEEE divisions by the pivot) and n - 1
// back (one FMA).  The bytes are few (dl, d, du, b read and x written once:
// 10 MB at K = 512, n = 1024 in f32, 3 us at full bandwidth), so the time
// is the chain of dependent steps, as long as no step waits on memory.
//
// Design: a block owns 32 systems; one warp runs the recurrence, one lane a
// system, and three loader warps keep it fed (the chain warp does nothing
// else: every instruction it issues lengthens the chain).
//   * Forward: the rows of dl, d, du, b stream in chunks of 32 positions
//     from the callers' (K, n) layout into a ring of 4 stages in shared
//     memory, by 16-byte cp.async copies (one element a copy where n is
//     not a multiple of 16 bytes' worth), as far ahead as the ring allows.
//     A stage holds each array as [system][position] rows of 32 positions
//     plus 16 bytes, so the chain lane reads its own row 16 bytes at a time
//     (8 lanes a wavefront) a group of 8 steps ahead into registers.
//     Each stage has a "full" mbarrier, on which each loader thread's
//     copies arrive as they land, and an "empty" one, on which the chain
//     releases it: the chain never meets the loaders at a block barrier.
//     One-element copies limited the loaders, whose time then set the
//     kernel's (on an NVIDIA H100 80GB HBM3 it fell with every loader warp
//     added); with 16-byte copies three loader warps keep up.
//   * cp and the forward x (y) go where the chain never waits on them:
//     into a device-memory scratch laid out [block][position][32 systems],
//     one 128-byte store a step.  (Keeping them in shared memory beside the
//     ring where they fit, n <= 600 in float32, gained 3-4 % at n = 160 to
//     512 and nothing at n = 64 on an NVIDIA H100 80GB HBM3, in turns;
//     PERF.md: too little for a second design.)
//   * Back: x_i = y_i - cp_i x_{i+1}, one FMA a step.  The loaders bring
//     the scratch back in chunks, last first, by 16-byte copies into the
//     ring; the chain writes each x chunk into a staging tile of the stage,
//     which the loaders store to the callers' (K, n) layout, one line a
//     system, before they refill the stage.
// The recurrence is the reference's, operation for operation: m = d - dl
// cp, a zero pivot replaced by eps (the dtype's smallest normal number by
// default), cp = du / m and y = (b - dl y) / m by IEEE division, and the
// back substitution; dl[:, 0] and du[:, n-1] are never used.
#include <cuda_runtime.h>

namespace {

constexpr int kSys = 32;                  // systems a block: the chain warp's lanes
constexpr int kPad = kSys + 1;            // row stride of the x staging tile
constexpr int kChunk = 32;                // positions a ring stage
constexpr int kStages = 4;
constexpr int kLoaders = 3;               // loader warps
constexpr int kThreads = 32 * (1 + kLoaders);
constexpr int kGroup = 8;                 // steps whose rows are read ahead
constexpr int kOut = 2 * kChunk * kSys;   // back pass: cp, y tiles, then x's
constexpr int kMaxDevices = 64;

// elements in 16 bytes, and the row stride of a forward [system][position]
// tile: 16-byte rows, and lane s's row 16 s bytes of banks past lane 0's,
// so 8 lanes' 16-byte reads are one wavefront
template <typename T>
constexpr int kPer = 16 / (int)sizeof(T);
template <typename T>
constexpr int kRow = kChunk + kPer<T>;
template <typename T>
constexpr int kStageElems = 4 * kSys * kRow<T>;  // dl, d, du, b tiles

template <typename T>
constexpr size_t ring_bytes() { return (size_t)kStages * kStageElems<T> * sizeof(T); }

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ void put(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ void put(const double2& v, double* o) {
    o[0] = v.x; o[1] = v.y;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// one element, 4 or 8 bytes
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" :: "r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

// 16 bytes, past L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted against the barrier's expected arrivals)
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" :: "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait far longer
// than any chunk takes traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

// Loaders: positions [i0, i0 + 32) of dl, d, du, b of the block's systems
// into the stage's [system][position] tiles.  With n a multiple of 16
// bytes' worth every copy is 16 bytes (thread `lt` of the loaders takes
// pieces lt, lt + 32 kLoaders, ...: four systems' lines a warp); else one
// element a copy, lane = position.  Systems past the last are skipped
// (their tile rows hold d = 1 and zeros).
template <typename T>
__device__ __forceinline__ void issue_rows(T* stage, const T* dl, const T* d, const T* du,
                                           const T* b, bool vec, int lt, int k0, int nsys,
                                           int n, int i0) {
  if (vec) {
    constexpr int kPieces = kChunk / kPer<T>;    // 16-byte pieces a row
    for (int q = lt; q < 4 * kSys * kPieces; q += 32 * kLoaders) {
      const int a = q / (kSys * kPieces);
      const int s = q / kPieces % kSys;
      const int e = q % kPieces * kPer<T>;
      if (s < nsys && i0 + e < n) {
        const T* src = a == 0 ? dl : a == 1 ? d : a == 2 ? du : b;
        cp_async16(stage + (a * kSys + s) * kRow<T> + e, src + (size_t)(k0 + s) * n + i0 + e);
      }
    }
  } else {
    const int lane = lt & 31;
    const int i = i0 + lane;
    if (i >= n) return;
    for (int q = lt >> 5; q < 4 * kSys; q += kLoaders) {
      const int a = q / kSys;
      const int s = q % kSys;
      if (s < nsys) {
        const T* src = a == 0 ? dl : a == 1 ? d : a == 2 ? du : b;
        cp_async_elem(stage + (a * kSys + s) * kRow<T> + lane, src + (size_t)(k0 + s) * n + i);
      }
    }
  }
}

// Back pass, loader thread `lt`: the scratch rows [i0, i0 + cnt) of cp and
// y into the stage's [position][32] tiles, 16 bytes a copy.
template <typename T>
__device__ __forceinline__ void issue_scratch(T* stage, const T* cpw, const T* yw, int lt,
                                              int i0, int cnt) {
  constexpr int kPieces = kChunk * kSys / kPer<T>;  // pieces a tile
  for (int q = lt; q < 2 * kPieces; q += 32 * kLoaders) {
    const int a = q / kPieces;
    const int e = (q % kPieces) * kPer<T>;       // element within the tile
    if (e / kSys < cnt)
      cp_async16(stage + a * (kChunk * kSys) + e, (a == 0 ? cpw : yw) + (size_t)i0 * kSys + e);
  }
}

// Back pass, loader warp `lw`: the x chunk the chain left in the stage's
// staging tile ([position][system], stride 33) to (K, n), a line a system.
template <typename T>
__device__ __forceinline__ void store_x(const T* out, T* x, int lw, int lane, int k0,
                                        int nsys, int n, int i0, int cnt) {
  if (lane >= cnt) return;
  for (int s = lw; s < nsys; s += kLoaders)
    x[(size_t)(k0 + s) * n + i0 + lane] = out[lane * kPad + s];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
thomas_kernel(const T* __restrict__ dl, const T* __restrict__ d, const T* __restrict__ du,
              const T* __restrict__ b, T* __restrict__ x, T* __restrict__ ws, int n, int K,
              T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // full[s]: the loaders' copies into stage s have landed; empty[s]: the
  // chain is done with stage s.  Fill f (forward chunks 0 .. nchunks - 1,
  // then the back pass's) goes into stage f % kStages, its phase f / kStages.
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lw = warp - 1;                // loader index (warp 0 is the chain)
  const int k0 = blockIdx.x * kSys;
  const int nsys = min(kSys, K - k0);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int lt = threadIdx.x - 32;        // thread index among the loaders
  const bool vec = n % kPer<T> == 0;
  // scratch of this block: cp then y, each [n][32]
  T* cpw = ws + (size_t)blockIdx.x * 2 * n * kSys;
  T* yw = cpw + (size_t)n * kSys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32 * kLoaders);
      mbar_init(&empty[s], 32);
    }
  }
  // the lanes past the last system run the chain on d = 1 and zeros
  if (warp == 0 && lane >= nsys) {
    for (int st = 0; st < kStages; ++st)
      for (int a = 0; a < 4; ++a)
        for (int t = 0; t < kChunk; ++t)
          ring[st * kStageElems<T> + (a * kSys + lane) * kRow<T> + t] = T(a == 1 ? 1 : 0);
  }
  __syncthreads();

  auto free_for = [&](int f) {  // loaders: stage f % kStages may be refilled
    if (f >= kStages) mbar_wait(&empty[f % kStages], ((f / kStages) - 1) & 1);
  };

  // ---- forward sweep ----
  T cprev = T(0), yprev = T(0);
  if (warp > 0) {
    for (int c = 0; c < nchunks; ++c) {
      free_for(c);
      issue_rows(ring + (c % kStages) * kStageElems<T>, dl, d, du, b, vec, lt, k0, nsys, n,
                 c * kChunk);
      mbar_arrive_copies(&full[c % kStages]);
    }
  } else {
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(&full[c % kStages], (c / kStages) & 1);
      const T* st = ring + (c % kStages) * kStageElems<T>;
      const int i0 = c * kChunk;
      const int cnt = min(kChunk, n - i0);
      // this lane's row of array a
      auto rowp = [&](int a) { return st + (a * kSys + lane) * kRow<T>; };
      auto step = [&](int t, T l, T dv, T u, T bv) {
        T m = dv - l * cprev;
        if (m == T(0)) m = eps;
        cprev = u / m;
        yprev = (bv - l * yprev) / m;
        cpw[(size_t)(i0 + t) * kSys + lane] = cprev;
        yw[(size_t)(i0 + t) * kSys + lane] = yprev;
      };
      if (cnt == kChunk) {
        // rows a group of steps ahead in registers, 16 bytes a read
        using V = typename Vec16<T>::type;
        auto read_group = [&](T (&dst)[4][kGroup], int g) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const V* src = reinterpret_cast<const V*>(rowp(a) + g * kGroup);
#pragma unroll
            for (int v = 0; v < kGroup / kPer<T>; ++v) Vec16<T>::put(src[v], &dst[a][v * kPer<T>]);
          }
        };
        T cur[4][kGroup], nxt[4][kGroup];
        read_group(cur, 0);
        if (c == 0) cur[0][0] = T(0);  // dl[:, 0] is ignored
#pragma unroll
        for (int g = 0; g < kChunk / kGroup; ++g) {
          if (g + 1 < kChunk / kGroup) read_group(nxt, g + 1);
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            step(g * kGroup + j, cur[0][j], cur[1][j], cur[2][j], cur[3][j]);
          if (g + 1 < kChunk / kGroup) {
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int j = 0; j < kGroup; ++j) cur[a][j] = nxt[a][j];
          }
        }
      } else {
        for (int t = 0; t < cnt; ++t)
          step(t, i0 + t == 0 ? T(0) : rowp(0)[t], rowp(1)[t], rowp(2)[t], rowp(3)[t]);
      }
      mbar_arrive(&empty[c % kStages]);
    }
    __threadfence_block();
  }
  // the scratch is complete
  __syncthreads();

  // ---- back substitution ----
  if (warp > 0) {
    // fill nchunks + j holds back chunk j: positions of chunk nchunks - 1 - j
    auto chunk_of = [&](int j) { return nchunks - 1 - j; };
    for (int j = 0; j < nchunks; ++j) {
      const int f = nchunks + j;
      free_for(f);
      T* st = ring + (f % kStages) * kStageElems<T>;
      if (j >= kStages) {  // the stage's last fill was back chunk j - kStages
        const int c = chunk_of(j - kStages);
        store_x(st + kOut, x, lw, lane, k0, nsys, n, c * kChunk, min(kChunk, n - c * kChunk));
      }
      const int c = chunk_of(j);
      issue_scratch(st, cpw, yw, lt, c * kChunk, min(kChunk, n - c * kChunk));
      mbar_arrive_copies(&full[f % kStages]);
    }
    for (int j = nchunks > kStages ? nchunks - kStages : 0; j < nchunks; ++j) {
      const int f = nchunks + j;
      mbar_wait(&empty[f % kStages], (f / kStages) & 1);
      const int c = chunk_of(j);
      store_x(ring + (f % kStages) * kStageElems<T> + kOut, x, lw, lane, k0, nsys, n,
              c * kChunk, min(kChunk, n - c * kChunk));
    }
  } else {
    T xn = yprev;  // x_{n-1} = y_{n-1}
    for (int j = 0; j < nchunks; ++j) {
      const int f = nchunks + j;
      mbar_wait(&full[f % kStages], (f / kStages) & 1);
      const T* st = ring + (f % kStages) * kStageElems<T>;
      T* out = const_cast<T*>(st) + kOut;
      const int i0 = (nchunks - 1 - j) * kChunk;
      const int cnt = min(kChunk, n - i0);
      int top = cnt - 1;
      if (j == 0) {  // position n - 1
        out[top * kPad + lane] = xn;
        --top;
      }
      auto step = [&](int t) {
        xn = st[kChunk * kSys + t * kSys + lane] - st[t * kSys + lane] * xn;
        out[t * kPad + lane] = xn;
      };
      if (top == kChunk - 1) {
#pragma unroll
        for (int t = kChunk - 1; t >= 0; --t) step(t);
      } else {
        for (int t = top; t >= 0; --t) step(t);
      }
      mbar_arrive(&empty[f % kStages]);
    }
  }
}

// Once per instantiation and device: let the kernel take the ring's
// dynamic shared memory (above the 48 KB a block gets by default).
template <typename T>
cudaError_t allow_ring() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(thomas_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ring_bytes<T>());
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
int launch(const T* dl, const T* d, const T* du, const T* b, T* x, T* ws, int n, int K,
           T eps, void* stream) {
  if (n <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_ring<T>();
  if (e != cudaSuccess) return (int)e;
  thomas_kernel<T><<<(K + kSys - 1) / kSys, kThreads, ring_bytes<T>(), (cudaStream_t)stream>>>(
      dl, d, du, b, x, ws, n, K, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes.  dl, d, du, b and x are contiguous (K, n)
// device arrays (dl[:, 0] and du[:, n-1] are ignored); ws is a scratch of
// 2 * ceil(K / 32) * 32 * n elements.  Returns a cudaError_t (0 on
// success).
extern "C" int thomas_f32(const float* dl, const float* d, const float* du, const float* b,
                          float* x, float* ws, int n, int K, float eps, void* stream) {
  return launch<float>(dl, d, du, b, x, ws, n, K, eps, stream);
}

extern "C" int thomas_f64(const double* dl, const double* d, const double* du,
                          const double* b, double* x, double* ws, int n, int K, double eps,
                          void* stream) {
  return launch<double>(dl, d, du, b, x, ws, n, K, eps, stream);
}
