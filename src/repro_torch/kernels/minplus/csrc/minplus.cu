// K1: the masked min-plus / min-max layered DP sweep of Algorithm 1, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/minplus/kernel.py
// (_sweep_kernel; entry sweep_minplus).  Plain version:
// src/repro_torch/kernels/minplus/ref.py (sweep_plain).
//
// For each threshold t (one thread block each) it folds away every edge
// with beta > t, then runs K-1 two-stage layers, both min-reductions:
//   A[i][m]    = min_n  dist[n][i] (+) Vc[n][i][m]      (communication hop)
//   dist'[m][j] = min_i A[i][m]    (+) Vs[i][m][j]      (segment extension)
// where (+) is + in "sum" mode and max in "max" mode, and writes the best
// terminal value min(dist[1:, I]) over all layers (plus the client-only
// path dist[0][I]).
//
// What bounds it on the H100: neither HBM bandwidth nor arithmetic peak.
// The four graph tensors (Ccom, Bcom, Sseg, Bseg; about 2.4 MB in f64 at
// N = 49 nodes, I + 1 = 31 cuts) are read once from HBM and then stay in
// the 50 MB L2, shared by every block; each block re-reads them once per
// layer, so the kernel runs at L2 bandwidth and load latency, with the
// compulsory HBM traffic far below the time it takes.  The design does
// about that: dist and A live in shared memory (N * (I + 1) values each),
// so the only global traffic in the inner loops is the graph tensors,
// read with neighbouring threads on neighbouring addresses (m innermost in
// stage 1, j innermost in stage 2); blocks are independent, so the
// thresholds spread over all 132 SMs.  The sequential Pallas grid carried
// nothing across steps, so nothing carries across blocks here either.
//
// Exactness: every operation is +, max, min or a compare — no sum over
// many terms and no multiply, so no FMA contraction can apply — and the
// float64 instantiation is bit-equal to the plain version in any
// reduction order.  The planner calls it in float64.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (src/repro_torch/kernels/_build.py); each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <typename T> __device__ __forceinline__ T inf_value();
template <> __device__ __forceinline__ double inf_value<double>() {
  return CUDART_INF;
}
template <> __device__ __forceinline__ float inf_value<float>() {
  return CUDART_INF_F;
}

template <typename T, bool SUM>
__device__ __forceinline__ T combine(T a, T b) {
  if (SUM) return a + b;
  return a > b ? a : b;
}

template <typename T, bool SUM>
__global__ void sweep_kernel(const T* __restrict__ ts,
                             const T* __restrict__ Cc,   // [n][i][m]
                             const T* __restrict__ Bc,
                             const T* __restrict__ Ss,   // [i][m][j]
                             const T* __restrict__ Bs,
                             const T* __restrict__ sc,   // [i]
                             const T* __restrict__ sb,
                             T* __restrict__ out, int N, int I1, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dist = reinterpret_cast<T*>(smem_raw);   // [N][I1]
  T* A = dist + N * I1;                       // [I1][N]

  const T INF = inf_value<T>();
  const T t = ts[blockIdx.x];
  const int I = I1 - 1;
  const int NI = N * I1;
  const T* Vc = SUM ? Cc : Bc;
  const T* Vs = SUM ? Ss : Bs;
  const T* src = SUM ? sc : sb;

  for (int x = threadIdx.x; x < NI; x += blockDim.x) {
    const int n = x / I1, i = x - n * I1;
    dist[x] = (n == 0 && sb[i] <= t) ? src[i] : INF;
  }
  __syncthreads();
  T best = dist[I];                            // client-only path (k = 1)

  for (int k = 2; k <= K; ++k) {
    // stage 1: communication hop (n, i) -> server m across cut i
    for (int x = threadIdx.x; x < NI; x += blockDim.x) {
      const int i = x / N, m = x - i * N;
      T acc = INF;
      const T* dcol = dist + i;
      size_t e = static_cast<size_t>(i) * N + m;
      const size_t step = static_cast<size_t>(I1) * N;
      for (int n = 0; n < N; ++n, e += step) {
        const T v = (Bc[e] <= t) ? Vc[e] : INF;
        const T c = combine<T, SUM>(dcol[n * I1], v);
        acc = c < acc ? c : acc;
      }
      A[x] = acc;
    }
    __syncthreads();
    // stage 2: extend with segment (i, j] on node m; dist is free to
    // overwrite, every thread has passed stage 1
    int any_finite = 0;
    for (int x = threadIdx.x; x < NI; x += blockDim.x) {
      const int m = x / I1, j = x - m * I1;
      T acc = INF;
      size_t e = static_cast<size_t>(m) * I1 + j;
      const size_t step = static_cast<size_t>(N) * I1;
      for (int i = 0; i < I1; ++i, e += step) {
        const T v = (Bs[e] <= t) ? Vs[e] : INF;
        const T c = combine<T, SUM>(A[i * N + m], v);
        acc = c < acc ? c : acc;
      }
      dist[x] = acc;
      any_finite |= (acc < INF);
    }
    const int live = __syncthreads_or(any_finite);
    if (threadIdx.x == 0) {
      for (int m = 1; m < N; ++m) {
        const T v = dist[m * I1 + I];
        best = v < best ? v : best;
      }
    }
    // once no state is reachable every later layer is all-inf: stop early
    // (the numpy reference's break; it does not change the result)
    if (!live) break;
    // the next stage 1 only reads dist and writes A, which stage 2 is done
    // reading, so no barrier is needed here
  }
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* ts, const void* Cc, const void* Bc, const void* Ss,
           const void* Bs, const void* sc, const void* sb, void* out, int S,
           int N, int I1, int K, int mode_sum, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(N) * I1 * sizeof(T);
  auto kernel = mode_sum ? sweep_kernel<T, true> : sweep_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ts), static_cast<const T*>(Cc),
      static_cast<const T*>(Bc), static_cast<const T*>(Ss),
      static_cast<const T*>(Bs), static_cast<const T*>(sc),
      static_cast<const T*>(sb), static_cast<T*>(out), N, I1, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int minplus_sweep_f64(const void* ts, const void* Cc, const void* Bc,
                      const void* Ss, const void* Bs, const void* sc,
                      const void* sb, void* out, int S, int N, int I1, int K,
                      int mode_sum, void* stream) {
  return launch<double>(ts, Cc, Bc, Ss, Bs, sc, sb, out, S, N, I1, K,
                        mode_sum, stream);
}

int minplus_sweep_f32(const void* ts, const void* Cc, const void* Bc,
                      const void* Ss, const void* Bs, const void* sc,
                      const void* sb, void* out, int S, int N, int I1, int K,
                      int mode_sum, void* stream) {
  return launch<float>(ts, Cc, Bc, Ss, Bs, sc, sb, out, S, N, I1, K,
                       mode_sum, stream);
}

}  // extern "C"
