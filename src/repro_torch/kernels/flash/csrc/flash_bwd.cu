// K2': the flash-attention backward, for Hopper (sm_90a).
//
// The reference has no backward Pallas kernel: it differentiates its plain
// attention (src/repro/models/common.py: full_attention, chunked_attention)
// with jax.grad.  This is the backward of K2 (flash.cu, which replaces
// src/repro/kernels/flash/kernel.py::_flash_fwd_kernel).  Plain version:
// src/repro_torch/kernels/flash/ref.py (flash_bwd_plain), the same
// equations in plain PyTorch.
//
// Per (batch b, query head h), with s = q k^T * scale (scale = 1/sqrt(hd)),
// the causal mask kpos <= qpos (both from 0) and keys past T masked, and
// lse the forward's log-sum-exp of each query row (flash.cu writes it):
//   P  = exp(s - lse)                    (the forward's probabilities)
//   D  = rowsum(dO o o)                  (one value per query row)
//   dP = dO v^T,   dS = P o (dP - D)
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dO
// GQA: query head h reads kv head h / (H / KV); dk and dv of a kv head sum
// over its query heads.
//
// Three launches per call, on the caller's stream:
// - flash_bwd_dot_kernel: D, one thread per query row, into a float32
//   scratch (B, H, S);
// - flash_bwd_dkdv_kernel: grid (B * KV, ceil(T / 64)), one block per kv
//   head and 64-key tile.  It keeps its K and V tiles and its dk and dv
//   accumulators for the whole call and walks the query heads of its kv
//   head and, under the causal mask, the query tiles at or after its key
//   tile; P and dS are recomputed per 64 x 64 tile.  A kv head's query
//   heads are summed inside the block, so no atomics are needed and the
//   result does not depend on the order blocks run in;
// - flash_bwd_dq_kernel: grid (B * H, ceil(S / 64)), one block per query
//   head and 64-row query tile, walking the key tiles the mask keeps (the
//   longest query tiles first), with its dq accumulator in registers.
//
// Arithmetic: float32 FMAs on the CUDA cores for both input types; bf16
// inputs are widened to float32 as they are loaded into shared memory and
// the results rounded to bf16 as they are stored.  256 threads as 16 x 16:
// a thread owns rows ty + 16 i (i < 4) and columns tx + 16 j (j < 4) of
// each 64 x 64 score tile, and the same rows times columns tx + 16 j
// (j < hd / 16) of its accumulators; shared rows are padded to hd + 1 and
// 65 floats, so a warp's column reads fall in distinct banks.
//
// What bounds it: at qwen3-0.6b's training layer (4 x 512 tokens, 16
// query heads / 8 kv heads of 128, causal) the five products over the
// causal pairs are ~10.8 GFLOP against ~25 MB of inputs and outputs: the
// function is bound by operations (0.011 ms at the bf16 tensor-core peak,
// 0.16 ms at the float32 CUDA-core peak).  This first design uses the
// CUDA cores only, recomputes q k^T in both the dk/dv and the dq kernel,
// and reloads the Q and dO tiles once per key tile; mma.sync / wgmma
// products and a fused dq (FlashAttention-2 keeps dq in a float32 buffer
// updated by atomics) are later work.
//
// Built by nvcc into the same plain-C shared library as flash.cu and
// called through ctypes (src/repro_torch/kernels/_build.py); the entry
// point returns cudaGetLastError() after the last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int NT = 256;            // threads per block, 16 x 16
constexpr int RI = BQ / 16;        // score rows per thread
constexpr int CJ = BK / 16;        // score columns per thread
constexpr int LDP = BK + 1;        // padded row of the P and dS tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows r0 .. r0 + 63 of a (rows x HD) slice with row stride ld (elements)
// into a float32 shared tile with rows of HD + 1; rows >= n are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t ld, int r0, int n) {
  for (int e = threadIdx.x; e < 64 * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] =
        r0 + r < n ? to_f32(src[(size_t)(r0 + r) * ld + d]) : 0.f;
  }
}

// D[b, h, s] = sum_d dO[b, s, h, d] o[b, s, h, d]
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dO,
                                     float* __restrict__ D, int B, int S,
                                     int H, int hd) {
  const long row = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long)B * S * H) return;
  const int h = row % H;
  const long bs = row / H;
  const int s = bs % S, b = bs / S;
  const T* op = o + row * hd;
  const T* dp = dO + row * hd;
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) acc += to_f32(op[d]) * to_f32(dp[d]);
  D[((size_t)b * H + h) * S + s] = acc;
}

// The 64 x 64 tiles s = Q K^T and dp = dO V^T of this thread's rows and
// columns, then P = exp(s scale - lse) (0 where masked) and
// dS = P (dp - D) into the shared tiles Ps and dSs.
template <int HD>
__device__ __forceinline__ void score_tiles(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int S, int T_len, int causal, float scale) {
  constexpr int LD = HD + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RI][CJ], dp[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RI], g[RI], kk[CJ], vv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = Qs[(ty + 16 * i) * LD + d];
      g[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      kk[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] += a[i] * kk[j];
        dp[i][j] += g[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      const bool ok = qpos < S && kpos < T_len && (!causal || kpos <= qpos);
      const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
      Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = p * (dp[i][j] - Ds[r]);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {   // K, V, Q, dO tiles; P, dS; lse, D
  return ((size_t)4 * 64 * (HD + 1) + 2 * BQ * LDP + 2 * BQ) * sizeof(float);
}

// Grid (B * KV, ceil(T / 64)).
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int T_len, int H, int KV,
                      int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                // BK x LD
  float* Vs = Ks + BK * LD;        // BK x LD
  float* Qs = Vs + BK * LD;        // BQ x LD
  float* dOs = Qs + BQ * LD;       // BQ x LD
  float* Ps = dOs + BQ * LD;       // BQ x LDP
  float* dSs = Ps + BQ * LDP;      // BQ x LDP
  float* Ls = dSs + BQ * LDP;      // BQ
  float* Ds = Ls + BQ;             // BQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * BK;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KV * HD;
  const size_t koff = (size_t)b * T_len * krow + (size_t)kvh * HD;
  load_tile<T, HD>(Ks, k + koff, krow, k0, T_len);
  load_tile<T, HD>(Vs, v + koff, krow, k0, T_len);

  float adk[RI][DJ], adv[RI][DJ];  // key rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // under the causal mask the query tiles before the key tile see none of
  // its keys (BQ == BK: query tile index >= key tile index)
  const int q_start = causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* db = D + ((size_t)b * H + h) * S;
    for (int q0 = q_start; q0 < S; q0 += BQ) {
      __syncthreads();             // the last tile's Q, dO, P, dS are read
      load_tile<T, HD>(Qs, q + qoff, qrow, q0, S);
      load_tile<T, HD>(dOs, dO + qoff, qrow, q0, S);
      for (int r = tid; r < BQ; r += NT) {
        Ls[r] = q0 + r < S ? lb[q0 + r] : 0.f;
        Ds[r] = q0 + r < S ? db[q0 + r] : 0.f;
      }
      __syncthreads();
      score_tiles<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, S, T_len,
                      causal, scale);
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q over the tile's query rows
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[RI], ds[RI], gd[DJ], qd[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          p[i] = Ps[r * LDP + ty + 16 * i];
          ds[i] = dSs[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gd[j] = dOs[r * LD + tx + 16 * j];
          qd[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            adv[i][j] += p[i] * gd[j];
            adk[i][j] += ds[i] * qd[j];
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr < T_len) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const size_t at = koff + (size_t)kr * krow + tx + 16 * j;
        store(dk + at, adk[i][j] * scale);
        store(dv + at, adv[i][j]);
      }
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {     // Q, dO, K, V tiles; P, dS; lse, D
  return dkdv_smem_bytes<HD>();
}

// Grid (B * H, ceil(S / 64)): block (bh, y) takes query tile
// ceil(S / 64) - 1 - y (the longest causal key range first).
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq, int S,
                    int T_len, int H, int KV, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* Ls = dSs + BQ * LDP;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KV * HD;
  const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
  const size_t koff = (size_t)b * T_len * krow + (size_t)kvh * HD;
  load_tile<T, HD>(Qs, q + qoff, qrow, q0, S);
  load_tile<T, HD>(dOs, dO + qoff, qrow, q0, S);
  const float* lb = lse + ((size_t)b * H + h) * S;
  const float* db = D + ((size_t)b * H + h) * S;
  for (int r = tid; r < BQ; r += NT) {
    Ls[r] = q0 + r < S ? lb[q0 + r] : 0.f;
    Ds[r] = q0 + r < S ? db[q0 + r] : 0.f;
  }

  float adq[RI][DJ];               // query rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adq[i][j] = 0.f;

  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();               // the last tile's K and dS are read
    load_tile<T, HD>(Ks, k + koff, krow, k0, T_len);
    load_tile<T, HD>(Vs, v + koff, krow, k0, T_len);
    __syncthreads();
    score_tiles<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, S, T_len,
                    causal, scale);
    __syncthreads();
    // dq += dS K over the tile's keys
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RI], kd[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dSs[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kd[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) adq[i][j] += ds[i] * kd[j];
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        store(dq + qoff + (size_t)r * qrow + tx + 16 * j, adq[i][j] * scale);
    }
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const void* lse, void* dq, void* dk, void* dv,
               void* D, int B, int S, int T_len, int H, int KV, int causal,
               float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)B * S * H;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      (const T*)o, (const T*)dO, (float*)D, B, S, H, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, HD>
      <<<dim3(B * KV, (T_len + BK - 1) / BK), NT, bytes, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dO,
          (const float*)lse, (const float*)D, (T*)dk, (T*)dv, S, T_len, H,
          KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD>
      <<<dim3(B * H, (S + BQ - 1) / BQ), NT, dq_smem_bytes<HD>(), st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dO,
          (const float*)lse, (const float*)D, (T*)dq, S, T_len, H, KV,
          causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dO, const void* lse, void* dq, void* dk, void* dv,
             void* D, int B, int S, int T_len, int H, int KV, int hd,
             int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KV < 1 || H % KV != 0 ||
      (S + BQ - 1) / BQ > 65535 || (T_len + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S,
                               T_len, H, KV, causal, scale, stream);
    case 32:
      return launch_bwd<T, 32>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S,
                               T_len, H, KV, causal, scale, stream);
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S,
                               T_len, H, KV, causal, scale, stream);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S,
                                T_len, H, KV, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, dO, dq: (B, S, H, hd); k, v, dk, dv: (B, T, KV, hd); all
// contiguous, in the entry's type.  lse: (B, H, S) float32 from the
// forward; D: a float32 scratch of B * H * S.  H is a multiple of KV; hd is
// 16, 32, 64 or 128; causal is 0 or 1; scale is 1 / sqrt(hd).
int flash_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                  const void* dO, const void* lse, void* dq, void* dk,
                  void* dv, void* D, int B, int S, int T, int H, int KV,
                  int hd, int causal, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S, T, H, KV,
                         hd, causal, scale, stream);
}

int flash_bwd_bf16(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, const void* lse, void* dq,
                   void* dk, void* dv, void* D, int B, int S, int T, int H,
                   int KV, int hd, int causal, float scale, void* stream) {
  return dispatch<bf16>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S, T, H, KV,
                        hd, causal, scale, stream);
}

}  // extern "C"
