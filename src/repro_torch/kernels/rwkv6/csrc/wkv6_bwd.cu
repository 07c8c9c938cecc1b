// K3': the RWKV6 WKV scan's backward, for Hopper (sm_90a).
//
// The reference has no backward Pallas kernel: it differentiates its plain
// chunked scan (src/repro/models/rwkv6.py::wkv_chunked) with jax.grad.
// This is the backward of K3 (wkv6.cu, which replaces
// src/repro/kernels/rwkv6/kernel.py::_wkv6_kernel).  Plain version:
// src/repro_torch/kernels/rwkv6/ref.py (wkv6_bwd_plain), the same walk
// and identity in plain PyTorch.
//
// Forward, per (batch b, head h), state S (hd x hd, row i = key index):
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// Given dy and dS_T (the gradient of the final state), the reverse walk
// with G_t = dL/dS_t, G_T = dS_T, is
//   dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
//   dk_t = G_t v_t + u o r_t (v_t . dy_t)
//   dv_t = G_t^T k_t + (sum_i r_t u k_t) dy_t = sum_i k_t[i] (G_t[i] + r_t[i] u[i] dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0
//   du = sum_t r_t o k_t (v_t . dy_t)   (summed over the batch by the wrapper)
// and, with A_t = r_t o (S_{t-1} dy_t) and B_t = k_t o (G_t v_t),
//   dlogw_t = sum_j S_T[:, j] dS_T[:, j] + sum_{tau > t} A_tau - sum_{s >= t} B_s
// (w_t S_{t-1} = S_t - k_t v_t^T turns the per-token product
// sum_j G_t S_{t-1} w_t into differences of running sums), so no state of
// the forward is ever held beside G: only the vector S_{t-1} dy_t.
//
// Design: one block per (b, h), walking tokens in reverse order, tile by
// tile (64 tokens, the forward's tiles).  Warp w owns state rows
// 32 w .. 32 w + 31, one row a lane, in registers: G for the whole call,
// and during each tile's forward re-walk the state S from the tile's
// entering state (the forward's pass-1 scratch, kept by the autograd
// function) -- never S_{t-1} = (S_t - k v^T) / w, which overflows under a
// strong decay.  Per tile:
//   1. the tile's r, k, w = exp(log w), v and dy into shared memory;
//   2. the forward re-walk: per token, a_t[i] = S_{t-1}[i] . dy_t and the
//      state update, row-local (no shuffle, no barrier); after the last
//      tile's walk, S is S_T and gives the dlogw identity's first term;
//   3. the reverse walk: per token, row-local dr, dk, dlogw and the G
//      update, and dv's column sums over the warp's rows by a butterfly
//      reduce-scatter of shuffles (each lane ends with hd / 32 columns)
//      into a per-warp shared buffer; one barrier a tile, then the warps'
//      partial columns are added and written.
// All arithmetic is float32 on the CUDA cores; r/k/v arrive as float32 or
// bfloat16 (widened as they are loaded), the rest as float32, and every
// gradient is written in float32 (the wrapper casts dr/dk/dv to r's type).
//
// What bounds it: at rwkv6-1.6b's training layer (4 x 512 tokens, 32
// heads of 64) the function moves ~42 MB (0.013 ms at 3.35 TB/s) and does
// ~10 hd^2 FLOP a token and head (~0.7 GFLOP): bytes bound it.  What sets
// this design's time is the chain of 2 x S dependent token steps per block
// (128 blocks of 2 warps, one a SM), each some 500 instructions of one
// warp, and the shuffles of dv's reduce-scatter; a chunked form on the
// tensor cores (the forward's design, mirrored in time) is later work.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (src/repro_torch/kernels/_build.py); the entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;           // tokens per tile (the forward's tiles)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Reduce-scatter of p[0 .. N) over the 32 lanes of a warp: at each xor
// offset OFF the lanes keep the half of the remaining columns selected by
// their OFF bit and add their partner's copy of it; once a single column
// is left, the remaining offsets add it whole.  The columns a lane holds
// at the end are base + q (q < max(N0 / 32, 1)).
template <int N0, int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float (&p)[N0], int lane,
                                               int& base) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      constexpr int HL = N / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int q = 0; q < HL; ++q) {
        const float send = up ? p[q] : p[q + HL];
        const float keep = up ? p[q + HL] : p[q];
        p[q] = keep + __shfl_xor_sync(FULL, send, OFF);
      }
      if (up) base += HL;
      reduce_scatter<N0, HL, OFF / 2>(p, lane, base);
    } else {
      p[0] += __shfl_xor_sync(FULL, p[0], OFF);
      reduce_scatter<N0, 1, OFF / 2>(p, lane, base);
    }
  }
}

template <int HD>
constexpr int kWarps = (HD + 31) / 32;   // warps a block: one row a lane

template <int HD>
constexpr size_t smem_bytes() {   // r, k, w, v, dy, a; dv partials per warp
  return ((size_t)6 * TILE * HD + (size_t)kWarps<HD> * TILE * HD) *
         sizeof(float);
}

// Grid B * H blocks of 32 * kWarps<HD> threads.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kWarps<HD>)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ dsT,
                const float* __restrict__ states, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dlw, float* __restrict__ du_part,
                float* __restrict__ ds0, int S, int H) {
  constexpr int NW = kWarps<HD>;
  constexpr int NC = HD / 32 > 0 ? HD / 32 : 1;   // columns a lane ends with
  extern __shared__ __align__(16) float sm[];
  float* Rs = sm;                  // TILE x HD each
  float* Ks = Rs + TILE * HD;
  float* Ws = Ks + TILE * HD;
  float* Vs = Ws + TILE * HD;
  float* DYs = Vs + TILE * HD;
  float* As = DYs + TILE * HD;
  float* DVp = As + TILE * HD;     // NW x TILE x HD

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i = 32 * warp + lane;  // this thread's state row
  const bool own = i < HD;
  const size_t rs = (size_t)H * HD;                 // token stride
  const size_t base = (size_t)b * S * rs + (size_t)h * HD;
  const int n_tiles = (S + TILE - 1) / TILE;
  const float ui = own ? u[h * HD + i] : 0.f;

  float G[HD];                     // row i of G_t
#pragma unroll
  for (int j = 0; j < HD; ++j)
    G[j] = own ? dsT[((size_t)bh * HD + i) * HD + j] : 0.f;
  float c = 0.f;                   // P_t: the dlogw identity's running sum
  float du_acc = 0.f;

  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * TILE, n = min(TILE, S - t0);
    __syncthreads();               // the last tile's shared data are read
    for (int e = tid; e < TILE * HD; e += 32 * NW) {
      const int t = e / HD, d = e % HD;
      const bool in = t < n;
      const size_t g = base + (size_t)(t0 + t) * rs + d;
      Rs[e] = in ? to_f32(r[g]) : 0.f;
      Ks[e] = in ? to_f32(k[g]) : 0.f;
      Vs[e] = in ? to_f32(v[g]) : 0.f;
      Ws[e] = in ? expf(lw[g]) : 1.f;
      DYs[e] = in ? dy[g] : 0.f;
    }
    __syncthreads();

    // forward re-walk from the state entering the tile
    {
      float Sr[HD];
      const float* st = states + ((size_t)bh * n_tiles + tile) * HD * HD;
#pragma unroll
      for (int j = 0; j < HD; ++j) Sr[j] = own ? st[(size_t)i * HD + j] : 0.f;
      for (int t = 0; t < n; ++t) {
        const float ki = own ? Ks[t * HD + i] : 0.f;
        const float wi = own ? Ws[t * HD + i] : 0.f;
        const float4* v4 = reinterpret_cast<const float4*>(Vs + t * HD);
        const float4* d4 = reinterpret_cast<const float4*>(DYs + t * HD);
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < HD / 4; ++q) {
          const float4 vv = v4[q], dd = d4[q];
          const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
          const float dx[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a += Sr[4 * q + e] * dx[e];
            Sr[4 * q + e] = wi * Sr[4 * q + e] + ki * vx[e];
          }
        }
        if (own) As[t * HD + i] = a;   // read back by this thread only
      }
      if (tile == n_tiles - 1) {       // Sr is S_T: P_T = S_T[i] . dS_T[i]
#pragma unroll
        for (int j = 0; j < HD; ++j) c += Sr[j] * G[j];
      }
    }

    // reverse walk
    for (int t = n - 1; t >= 0; --t) {
      const float ri = own ? Rs[t * HD + i] : 0.f;
      const float ki = own ? Ks[t * HD + i] : 0.f;
      const float wi = own ? Ws[t * HD + i] : 0.f;
      const float ai = own ? As[t * HD + i] : 0.f;
      const float rui = ri * ui;
      const float4* v4 = reinterpret_cast<const float4*>(Vs + t * HD);
      const float4* d4 = reinterpret_cast<const float4*>(DYs + t * HD);
      float gv = 0.f, vdy = 0.f, part[HD];
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 vv = v4[q], dd = d4[q];
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
        const float dx[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          gv += G[j] * vx[e];
          vdy += vx[e] * dx[e];
          part[j] = ki * (G[j] + rui * dx[e]);
          G[j] = wi * G[j] + ri * dx[e];        // G_{t-1}
        }
      }
      const float bt = ki * gv;
      if (own) {
        const size_t g = base + (size_t)(t0 + t) * rs + i;
        dr[g] = ai + ui * ki * vdy;
        dk[g] = gv + rui * vdy;
        dlw[g] = c - bt;
      }
      c += ai * ri - bt;
      du_acc += ri * ki * vdy;
      int col = 0;
      reduce_scatter<HD, HD, 16>(part, lane, col);
#pragma unroll
      for (int q = 0; q < NC; ++q)
        DVp[(warp * TILE + t) * HD + col + q] = part[q];
    }
    __syncthreads();               // every warp's dv partials are written
    for (int e = tid; e < n * HD; e += 32 * NW) {
      const int t = e / HD, j = e % HD;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += DVp[(w * TILE + t) * HD + j];
      dv[base + (size_t)(t0 + t) * rs + j] = s;
    }
  }
  if (own) {
#pragma unroll
    for (int j = 0; j < HD; ++j) ds0[((size_t)bh * HD + i) * HD + j] = G[j];
    du_part[(size_t)bh * HD + i] = du_acc;
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* dy, const void* dsT,
           const void* states, void* dr, void* dk, void* dv, void* dlw,
           void* du_part, void* ds0, int B, int S, int H, void* stream) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<T, HD><<<B * H, 32 * kWarps<HD>, bytes,
                           (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)dy, (const float*)dsT,
      (const float*)states, (float*)dr, (float*)dk, (float*)dv,
      (float*)dlw, (float*)du_part, (float*)ds0, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* lw,
             const void* u, const void* dy, const void* dsT,
             const void* states, void* dr, void* dk, void* dv, void* dlw,
             void* du_part, void* ds0, int B, int S, int H, int hd,
             void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
#define WKV6_BWD_CASE(HD_)                                                  \
  case HD_:                                                                 \
    return launch<T, HD_>(r, k, v, lw, u, dy, dsT, states, dr, dk, dv, dlw, \
                          du_part, ds0, B, S, H, stream);
  switch (hd) {
    WKV6_BWD_CASE(4)
    WKV6_BWD_CASE(8)
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WKV6_BWD_CASE
}

}  // namespace

extern "C" {

// r, k, v: (B, S, H, hd) in the entry's type; lw, dy, dr, dk, dv, dlw:
// (B, S, H, hd) float32; u: (H, hd); dsT, ds0: (B, H, hd, hd); states:
// (B * H, ceil(S / 64), hd, hd), the state entering each 64-token tile
// (K3's pass-1 scratch); du_part: (B, H, hd).  All float32 unless said,
// contiguous and 16-byte aligned; hd is 4, 8, 16, 32 or 64.
int wkv6_bwd_f32(const void* r, const void* k, const void* v, const void* lw,
                 const void* u, const void* dy, const void* dsT,
                 const void* states, void* dr, void* dk, void* dv, void* dlw,
                 void* du_part, void* ds0, int B, int S, int H, int hd,
                 void* stream) {
  return dispatch<float>(r, k, v, lw, u, dy, dsT, states, dr, dk, dv, dlw,
                         du_part, ds0, B, S, H, hd, stream);
}

int wkv6_bwd_bf16(const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* dy,
                  const void* dsT, const void* states, void* dr, void* dk,
                  void* dv, void* dlw, void* du_part, void* ds0, int B,
                  int S, int H, int hd, void* stream) {
  return dispatch<bf16>(r, k, v, lw, u, dy, dsT, states, dr, dk, dv, dlw,
                        du_part, ds0, B, S, H, hd, stream);
}

}  // extern "C"
