// K3: the RWKV6 chunked WKV scan (data-dependent-decay linear attention),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv6_kernel; entry wkv6_fwd, model-layout wrapper ops.py::wkv6).
// Plain versions: src/repro_torch/kernels/rwkv6/ref.py (wkv6_chunked_plain,
// the same chunked math; wkv6_plain, the per-token recurrence).
//
// Per (batch b, head h), walking the sequence in order, with an hd x hd
// float32 state S and, within a tile of n tokens, L = cumsum(log w):
//   q  = r * exp(L_{t-1}),  k' = k * exp(-L),  k~ = k * exp(L_end - L)
//   y  = q S + tril(q k'^T, -1) v + (r . u . k) v
//   S <- exp(L_end) S + k~^T v
// y and the final S are written in float32; r/k/v arrive as float32 or
// bfloat16, log w, u and S0 as float32, and all arithmetic is float32.
//
// Design.
// - Grid (B * H, ceil(hd / TV)): one block per head and tile of TV = 16
//   value columns.  The Pallas grid's sequential chunk axis becomes a loop
//   inside the block; the state's column tile S[:, j0:j0+TV] stays in
//   shared memory across the whole sequence.  Splitting the value columns
//   puts 128 blocks in flight for one 32-head row (the server prefills one
//   request at a time, so B = 1), where one block per head would fill only
//   32 of the 132 SMs.  Each column tile recomputes the tile's q, k' and
//   q k'^T, which do not depend on the value column.
// - Tiles.  The TPU kernel holds a C x C attention tile plus four C x hd
//   tiles in VMEM; at the model's chunk of 256 that is over 256 KB, more
//   than a block's 227 KB.  So each chunk is taken in sub-tiles of at most
//   TILE = 64 tokens, each treated as its own chunk (the same function up
//   to rounding; it also keeps exp(-L) far smaller than a 256-token chunk
//   would).  Tile boundaries never cross a chunk boundary, so any chunk the
//   model's selection loop produces (down to 1 for an odd prompt) is
//   taken as given.  Shared memory: about 91 KB a block (dynamic).
// - Per tile: load r, k, log w (all hd key columns) and v (the block's
//   columns); a segmented scan gives L (256 threads: hd columns times
//   256 / hd segments); q k'^T is computed in 4 x 4 register tiles below
//   the diagonal only; then y and the state update, each thread owning
//   fixed outputs, so no atomics.  Rows are padded to 65 floats to keep
//   the column walks free of bank conflicts.
//
// What bounds it on the H100: at the served shape (1 x 512 tokens x 32
// heads x 64) the work is about 0.5 GFLOP over 16 MB, both far under a
// millisecond at the card's peaks, so neither bound is near; this simple
// version runs on CUDA cores (no wgmma, no TMA), with six block barriers a
// tile and a 64-step dependent scan split four ways, so its time is
// latency and shared-memory traffic.  chip_smoke.py measures it beside its
// bound.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (src/repro_torch/kernels/_build.py); each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD_MAX = 64;         // largest head size taken
constexpr int TILE = 64;           // most tokens in a sub-tile
constexpr int TV = 16;             // value columns per block
constexpr int NT = 256;            // threads per block
constexpr int LDK = HD_MAX + 1;    // padded row of a (token, key) tile
constexpr int LDA = TILE + 1;      // padded row of the attention tile

constexpr int SMEM_FLOATS = 4 * TILE * LDK    // Q, K, KD, Lb
                            + TILE * LDA      // A
                            + TILE * TV       // V
                            + HD_MAX * TV     // St
                            + TILE            // diag
                            + 2 * HD_MAX      // Lend, U
                            + NT;             // scan partials
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int S, int H,
            int hd, int chunk) {
  extern __shared__ float sm[];
  float* Q = sm;                     // r, then q = r exp(L_{t-1})
  float* K = Q + TILE * LDK;         // k, then k~ = k exp(L_end - L)
  float* KD = K + TILE * LDK;        // k' = k exp(-L)
  float* Lb = KD + TILE * LDK;       // log w, then L
  float* A = Lb + TILE * LDK;        // q k'^T, strictly below the diagonal
  float* V = A + TILE * LDA;         // v[:, j0:j0+TV]
  float* St = V + TILE * TV;         // S[:, j0:j0+TV]
  float* diag = St + HD_MAX * TV;    // r . u . k per token
  float* Lend = diag + TILE;
  float* U = Lend + HD_MAX;
  float* part = U + HD_MAX;          // per-segment sums of log w

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * TV;
  const int tv = min(TV, hd - j0);
  const size_t row = (size_t)H * hd;                   // token stride
  const size_t base = (size_t)b * S * row + (size_t)h * hd;
  const float* s0_bh = s0 + (size_t)bh * hd * hd;

  for (int e = tid; e < hd * TV; e += NT) {
    const int i = e / TV, jj = e % TV;
    St[e] = jj < tv ? s0_bh[(size_t)i * hd + j0 + jj] : 0.f;
  }
  for (int i = tid; i < hd; i += NT) U[i] = u[h * hd + i];

  // segmented scan layout: column ci, segment cp of np_seg
  const int ci = tid % hd, cp = tid / hd, np_seg = NT / hd;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    for (int t0 = c0; t0 < c0 + chunk; t0 += TILE) {
      const int n = min(TILE, c0 + chunk - t0);
      __syncthreads();             // the previous tile is done with smem

      // 1. load the tile
      for (int e = tid; e < n * hd; e += NT) {
        const int t = e / hd, i = e % hd;
        const size_t g = base + (size_t)(t0 + t) * row + i;
        Q[t * LDK + i] = to_f32(r[g]);
        K[t * LDK + i] = to_f32(k[g]);
        Lb[t * LDK + i] = lw[g];
      }
      for (int e = tid; e < n * TV; e += NT) {
        const int t = e / TV, jj = e % TV;
        V[e] = jj < tv ? to_f32(v[base + (size_t)(t0 + t) * row + j0 + jj])
                       : 0.f;
      }
      __syncthreads();

      // 2. current-token bonus and per-segment sums of log w
      const int seg = (n + np_seg - 1) / np_seg;
      const int ta = min(n, cp * seg), tb = min(n, ta + seg);
      {
        float s = 0.f;
        for (int t = ta; t < tb; ++t) s += Lb[t * LDK + ci];
        part[cp * hd + ci] = s;
      }
      for (int t = tid; t < n; t += NT) {
        float d = 0.f;
        for (int i = 0; i < hd; ++i)
          d += Q[t * LDK + i] * (U[i] * K[t * LDK + i]);
        diag[t] = d;
      }
      __syncthreads();

      // 3. L = cumsum(log w) within the tile; q and k'
      {
        float L = 0.f;
        for (int p = 0; p < cp; ++p) L += part[p * hd + ci];
        for (int t = ta; t < tb; ++t) {
          const int o = t * LDK + ci;
          const float lwv = Lb[o];
          const float Lm1 = L;
          L += lwv;
          Q[o] *= expf(Lm1);
          KD[o] = K[o] * expf(-L);
          Lb[o] = L;
        }
      }
      __syncthreads();

      // 4. A = q k'^T below the diagonal (4 x 4 per thread); k~ in place
      {
        const int ty = tid / 16, tx = tid % 16;
        if (tx <= ty && ty * 4 < n) {
          float acc[4][4] = {};
          for (int i = 0; i < hd; ++i) {
            float qa[4], kb[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) qa[a] = Q[(ty * 4 + a) * LDK + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) kb[c] = KD[(tx * 4 + c) * LDK + i];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[a][c] += qa[a] * kb[c];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int t = ty * 4 + a, tau = tx * 4 + c;
              if (tau < t && t < n) A[t * LDA + tau] = acc[a][c];
            }
        }
      }
      for (int e = tid; e < n * hd; e += NT) {
        const int t = e / hd, i = e % hd;
        K[t * LDK + i] *= expf(Lb[(n - 1) * LDK + i] - Lb[t * LDK + i]);
      }
      for (int i = tid; i < hd; i += NT) Lend[i] = Lb[(n - 1) * LDK + i];
      __syncthreads();

      // 5. y = q S + A v + diag v
      for (int e = tid; e < n * TV; e += NT) {
        const int t = e / TV, jj = e % TV;
        float cross = 0.f, intra = 0.f;
        for (int i = 0; i < hd; ++i) cross += Q[t * LDK + i] * St[i * TV + jj];
        for (int tau = 0; tau < t; ++tau)
          intra += A[t * LDA + tau] * V[tau * TV + jj];
        if (jj < tv)
          y[base + (size_t)(t0 + t) * row + j0 + jj] =
              cross + intra + diag[t] * V[t * TV + jj];
      }
      __syncthreads();

      // 6. S <- exp(L_end) S + k~^T v
      for (int e = tid; e < hd * TV; e += NT) {
        const int i = e / TV, jj = e % TV;
        float s = 0.f;
        for (int tau = 0; tau < n; ++tau)
          s += K[tau * LDK + i] * V[tau * TV + jj];
        St[e] = expf(Lend[i]) * St[e] + s;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < hd * TV; e += NT) {
    const int i = e / TV, jj = e % TV;
    if (jj < tv) s_out[(size_t)bh * hd * hd + (size_t)i * hd + j0 + jj] = St[e];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* s_out, int B, int S,
           int H, int hd, int chunk, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (hd + TV - 1) / TV);
  wkv6_kernel<T><<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, S, H, hd,
      chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v: (B, S, H, hd) in the entry's type; lw: (B, S, H, hd) f32;
// u: (H, hd) f32; s0: (B, H, hd, hd) f32; y: (B, S, H, hd) f32;
// s_out: (B, H, hd, hd) f32.  All contiguous.  hd divides 256 and is at
// most 64; chunk divides S.
int wkv6_f32(const void* r, const void* k, const void* v, const void* lw,
             const void* u, const void* s0, void* y, void* s_out, int B,
             int S, int H, int hd, int chunk, void* stream) {
  return launch<float>(r, k, v, lw, u, s0, y, s_out, B, S, H, hd, chunk,
                       stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* lw,
              const void* u, const void* s0, void* y, void* s_out, int B,
              int S, int H, int hd, int chunk, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, s_out, B, S, H, hd,
                               chunk, stream);
}

}  // extern "C"
