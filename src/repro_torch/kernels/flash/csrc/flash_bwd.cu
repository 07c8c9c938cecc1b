// K2': the flash-attention backward, for Hopper (sm_90a).
//
// The reference has no backward Pallas kernel: it differentiates its plain
// attention (src/repro/models/common.py:212-289: full_attention,
// chunked_attention) with jax.grad.  This is the backward of K2 (flash.cu,
// which replaces src/repro/kernels/flash/kernel.py::_flash_fwd_kernel).
// Plain version: src/repro_torch/kernels/flash/ref.py (flash_bwd_plain),
// the same equations in plain PyTorch.
//
// Per (batch b, query head h), with s = q k^T * scale (scale = 1/sqrt(hd)),
// the causal mask kpos <= qpos (both from 0), under a sliding window > 0
// also kpos > qpos - window (the reference's mask, common.py:235-236,
// 276-277), keys past T masked, and lse the forward's log-sum-exp of each
// query row over the kept keys (flash.cu writes it):
//   P  = exp(s - lse)                    (the forward's probabilities)
//   D  = rowsum(dO o o)                  (one value per query row)
//   dP = dO v^T,   dS = P o (dP - D)
//   dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dO
// GQA: query head h reads kv head h / (H / KV); dk and dv of a kv head sum
// over its query heads.
//
// Three launches per call, on the caller's stream, for both entries:
// - flash_bwd_dot_kernel: D into a float32 scratch (B, H, S).  A row is
//   read by hd / 8 (bf16) or hd / 4 (f32) neighbouring threads, 16 bytes
//   each, and summed by shuffles: every load is coalesced;
// - a dk/dv kernel, grid (B * KV, ceil(T / 64)): one block per kv head and
//   64-key tile, keeping dk and dv for the whole call and walking the
//   query heads of its kv head and, under the causal mask, the query tiles
//   at or after its key tile (blockIdx.y = 0, the key tile with the most
//   query tiles, first); under a window only those before
//   min(S, k0 + 63 + window), the last query that sees one of its keys.  A
//   kv head's query heads are summed inside the block: no atomics, and the
//   result does not depend on the order blocks run in;
// - a dq kernel, grid (B * H, ceil(S / 64)): one block per query head and
//   64-row query tile, walking the key tiles the mask keeps (the longest
//   query tiles first; under a window from the tile holding the window's
//   first key of the tile's first row, max(0, q0 - window + 1) rounded
//   down to a tile), with dq in registers.
// Every masked pair's P and dS are 0 by a select, so a row or key that
// sees nothing in a tile adds nothing.
// k_offset is the position of key 0 (k and v a block of a longer key
// sequence, as in flash.cu): the masks compare kpos + k_offset with qpos,
// the dk/dv walk starts at the query tile holding k0 + k_offset, the dq
// walk ends before the block's first key past the tile.  Given the output
// and lse of the whole sequence's softmax (split.py combines the blocks'),
// P is the block's share of it, and dk, dv are the block's and dq its
// share of the whole dq; a row with no kept key (lse -inf) gets dq = 0.
// s = q k^T and dP = dO v^T are computed in both: seven products in place
// of five, the price of a deterministic dq (FlashAttention-2 adds dq into a
// float32 buffer with atomics).
//
// bfloat16 entry (the training type): flash_bwd_dkdv_mma_kernel and
// flash_bwd_dq_mma_kernel, on the tensor cores, K2's tools
// (flash.cu:29-78) applied to the backward:
// - 4 warps; a warp owns 16 rows of the block's 64 (keys in dk/dv, query
//   rows in dq).  Every product is mma.sync.m16n8k16 bf16 x bf16 -> f32
//   with its operands from ldmatrix: q k^T and dO v^T as in the forward,
//   ldmatrix.trans wherever the operand's rows are the product's depth
//   (P^T dO, dS^T q and dS k).
// - P = 2^(s scale log2(e) - lse log2(e)) on the accumulator fragments,
//   0 where masked, and dS = P o (dP - D) in registers.  Both are rounded
//   to bf16 only as the A operand of the next product: the m16n8
//   accumulator layout of two adjacent 8-column tiles is the m16k16 A
//   layout, so no P or dS tile goes through shared memory.  The dk/dv
//   kernel computes s^T = k q^T and dP^T = v dO^T (keys as rows) over 32
//   query columns at a time, to keep its two 16 x hd accumulators (128
//   floats a thread at hd 128) in registers.
// - Shared tiles in bf16, rows padded to hd + 8 elements so that the 8 row
//   addresses of each ldmatrix fall in distinct 16-byte bank groups.  The
//   tiles the block walks (Q, dO, lse and D in dk/dv; K and V in dq) are
//   copied by cp.async into the stage the block is not reading: step j + 1
//   loads while step j computes.  At hd 128 a block holds 6 tiles of
//   64 x 136 bf16 (104 KB, plus 1 KB of lse and D): two blocks per SM.
//
// float32 entry: flash_bwd_dkdv_f32_kernel and flash_bwd_dq_f32_kernel,
// float32 FMAs on the CUDA cores (an exact float32 route: bf16 or TF32
// operands would break the 1e-4 float32 contract).  256 threads as
// 16 x 16: a thread owns rows ty + 16 i (i < 4) and columns tx + 16 j of
// each 64 x 64 score tile and of its accumulators; float32 shared rows
// padded to hd + 1 and 65.
//
// What bounds it: at qwen3-0.6b's training layer (4 x 512 tokens, 16 query
// heads / 8 kv heads of 128, causal, bf16) the five products over the
// causal pairs are ~10.8 GFLOP (0.011 ms at the bf16 tensor-core peak)
// against ~50 MB of inputs and outputs (0.015 ms at 3.35 TB/s): the bound
// is bytes (chip_smoke.py::flash_bwd_bound_ms).  The design's time
// (~0.104 ms on an H100: D ~0.006, dk/dv ~0.059, dq ~0.039; PERF.md
// section 6) is set by the chain of its longest blocks, not by the tensor
// cores' rate: the 256 dk/dv blocks run in one wave of two a SM, the first
// key tiles' blocks walking 16 query tiles of 256 products a warp; each
// step is the latency of its ldmatrix -> mma -> exp2 -> mma sequence.
// Splitting those blocks' query heads over blocks (with a deterministic
// sum of the partial dk, dv) is the next step.
// - ptxas -v (sm_90a, CUDA 12.8), bf16 dk/dv / dq: 248 / 248 registers
//   at hd 128 (186 / 152 at 64, 130 / 123 at 32, 104 / 100 at 16), no
//   spills; 256 / 192 HMMA in the hd-128 kernels' SASS.  The dq kernel
//   takes its 64 keys as two halves of 32: over all 64 at once it spilled
//   at hd 128.  The windowed dk/dv kernel (WINDOW true) takes 255
//   registers at hd 128 with 44 bytes of spill stores (190, 143, 132 at 64,
//   32, 16).  At window 128 the training layer takes 0.068 ms (dk/dv 0.034,
//   dq 0.028; 0.104 without a window): PERF.md, section 6.
//
// Built by nvcc into the plain-C shared library repro_torch_flash_bwd and
// called through ctypes (src/repro_torch/kernels/_build.py); the entry
// points return cudaGetLastError() after the last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile

// ---------------------------------------------------------------------------
// D = rowsum(dO o o), both entries
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot16(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float dot16(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(x[i]), q = __bfloat1622float2(y[i]);
    s += p.x * q.x + p.y * q.y;
  }
  return s;
}

template <typename T> struct Vec16;               // 16 bytes of T
template <> struct Vec16<float> { typedef float4 type; };
template <> struct Vec16<bf16> { typedef uint4 type; };

// D[b, h, s] = sum_d dO[b, s, h, d] o[b, s, h, d].  Each row (b, s, h) of
// HD elements is read by L = HD / (16 / sizeof(T)) neighbouring threads,
// 16 bytes each, and summed over the L lanes by shuffles.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                     float* __restrict__ D, int B, int S, int H) {
  typedef typename Vec16<T>::type V;
  constexpr int PER = 16 / sizeof(T);          // elements a thread reads
  constexpr int L = HD / PER;                  // threads a row
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "row split");
  const long rows = (long)B * S * H;
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int part = threadIdx.x % L;
  float acc = 0.f;
  if (row < rows) {
    const V a = reinterpret_cast<const V*>(o + row * HD)[part];
    const V b = reinterpret_cast<const V*>(dO + row * HD)[part];
    acc = dot16(a, b);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, L);
  if (row < rows && part == 0) {
    const int h = row % H;
    const long bs = row / H;
    const int s = bs % S, b = bs / S;
    D[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int NT = 256;            // threads per block, 16 x 16
constexpr int RI = BQ / 16;        // score rows per thread
constexpr int CJ = BK / 16;        // score columns per thread
constexpr int LDP = BK + 1;        // padded row of the P and dS tiles

// rows r0 .. r0 + 63 of a (rows x HD) slice with row stride ld (elements)
// into a float32 shared tile with rows of HD + 1; rows >= n are zero
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              size_t ld, int r0, int n) {
  for (int e = threadIdx.x; e < 64 * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] = r0 + r < n ? src[(size_t)(r0 + r) * ld + d] : 0.f;
  }
}

// The 64 x 64 tiles s = Q K^T and dp = dO V^T of this thread's rows and
// columns, then P = exp(s scale - lse) (0 where masked) and
// dS = P (dp - D) into the shared tiles Ps and dSs.
template <int HD>
__device__ __forceinline__ void score_tiles(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int S, int T_len, int causal, int window, int kofs, float scale) {
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
      const int c = tx + 16 * j, kpos = k0 + c, kg = kpos + kofs;
      const bool ok = qpos < S && kpos < T_len &&
                      (!causal || kg <= qpos) &&
                      (window <= 0 || kg > qpos - window);
      const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
      Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = p * (dp[i][j] - Ds[r]);
    }
  }
}

template <int HD>
constexpr size_t f32_smem_bytes() {   // K, V, Q, dO tiles; P, dS; lse, D
  return ((size_t)4 * 64 * (HD + 1) + 2 * BQ * LDP + 2 * BQ) * sizeof(float);
}

// Grid (B * KV, ceil(T / 64)).
template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, float* __restrict__ dk,
                          float* __restrict__ dv, int S, int T_len, int H,
                          int KV, int causal, int window, int kofs,
                          float scale) {
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
  load_tile_f32<HD>(Ks, k + koff, krow, k0, T_len);
  load_tile_f32<HD>(Vs, v + koff, krow, k0, T_len);

  float adk[RI][DJ], adv[RI][DJ];  // key rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // under the causal mask the query tiles before the key tile (at its
  // position k0 + kofs) see none of its keys; under a window no query at
  // or past k0 + kofs + 63 + window sees one
  const int q_start = causal ? (k0 + kofs) / BQ * BQ : 0;
  const int q_end = window > 0 ? min(S, k0 + kofs + BK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* db = D + ((size_t)b * H + h) * S;
    for (int q0 = q_start; q0 < q_end; q0 += BQ) {
      __syncthreads();             // the last tile's Q, dO, P, dS are read
      load_tile_f32<HD>(Qs, q + qoff, qrow, q0, S);
      load_tile_f32<HD>(dOs, dO + qoff, qrow, q0, S);
      for (int r = tid; r < BQ; r += NT) {
        Ls[r] = q0 + r < S ? lb[q0 + r] : 0.f;
        Ds[r] = q0 + r < S ? db[q0 + r] : 0.f;
      }
      __syncthreads();
      score_tiles<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, S, T_len,
                      causal, window, kofs, scale);
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
        dk[at] = adk[i][j] * scale;
        dv[at] = adv[i][j];
      }
    }
  }
}

// Grid (B * H, ceil(S / 64)): block (bh, y) takes query tile
// ceil(S / 64) - 1 - y (the longest causal key range first).
template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, float* __restrict__ dq,
                        int S, int T_len, int H, int KV, int causal,
                        int window, int kofs, float scale) {
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
  load_tile_f32<HD>(Qs, q + qoff, qrow, q0, S);
  load_tile_f32<HD>(dOs, dO + qoff, qrow, q0, S);
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

  const int k_end = causal ? min(T_len, q0 + BQ - kofs) : T_len;
  const int k_begin =
      window > 0 ? max(0, q0 - window + 1 - kofs) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();               // the last tile's K and dS are read
    load_tile_f32<HD>(Ks, k + koff, krow, k0, T_len);
    load_tile_f32<HD>(Vs, v + koff, krow, k0, T_len);
    __syncthreads();
    score_tiles<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, S, T_len,
                    causal, window, kofs, scale);
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
        dq[qoff + (size_t)r * qrow + tx + 16 * j] = adq[i][j] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_NT = 32 * MMA_WARPS;   // threads per block
constexpr int PAD = 8;                   // bf16 elements of padding per row
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr size_t mma_smem_bytes() {      // 6 bf16 tiles; 2 stages of lse, D
  return (size_t)6 * 64 * (HD + PAD) * sizeof(bf16) +
         (size_t)4 * BQ * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8 i .. 8 i + 7 give the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows r0 .. r0 + 63 of a (rows x HD) bf16 slice with row stride ld
// elements into the shared tile at byte address dst (rows of HD + PAD);
// rows >= n are zero-filled.  Thread tid copies the 16-byte chunk tid % CH
// of rows tid / CH + RS i.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          size_t ld, int r0, int n,
                                          int tid) {
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  constexpr int RS = MMA_NT / CH;  // rows per pass of the block
  const int r = tid / CH;
  const bf16* g = src + (size_t)(r0 + r) * ld + (tid % CH) * 8;
  dst += (r * (HD + PAD) + (tid % CH) * 8) * sizeof(bf16);
#pragma unroll
  for (int i = 0; i < 64 / RS; ++i) {
    const bool in = r0 + r + RS * i < n;
    cp_async16(dst + RS * i * (HD + PAD) * sizeof(bf16),
               in ? g + (size_t)RS * i * ld : src, in);
  }
}

// 64 floats of a (B, H, S) row from s0 into shared memory (zero past S)
__device__ __forceinline__ void load_row64(uint32_t dst, const float* src,
                                           int s0, int S, int tid) {
  if (tid < 64) {
    const bool in = s0 + tid < S;
    cp_async4(dst + tid * sizeof(float), in ? src + s0 + tid : src, in);
  }
}

// Lane offsets (bytes) of the three ldmatrix patterns, for shared rows of
// LDS elements:
// - a_lane: the A operand (16 rows x 16 deep) of a row-major tile;
// - b_lane: the B operand of 16 output columns x 16 deep from a tile whose
//   rows are the output columns (k^T, v^T: non-transposed ldmatrix);
// - t_lane: the B operand of 16 deep x 16 output columns from a tile whose
//   rows are the depth (P^T dO, dS K: ldmatrix.trans).
template <int LDS>
__device__ __forceinline__ uint32_t a_lane(int lane) {
  return ((lane % 16) * LDS + (lane / 16) * 8) * sizeof(bf16);
}
template <int LDS>
__device__ __forceinline__ uint32_t b_lane(int lane) {
  return ((lane % 8 + (lane / 16) * 8) * LDS + ((lane / 8) % 2) * 8) *
         sizeof(bf16);
}
template <int LDS>
__device__ __forceinline__ uint32_t t_lane(int lane) {
  return ((lane % 8 + ((lane / 8) % 2) * 8) * LDS + (lane / 16) * 8) *
         sizeof(bf16);
}

// c[n] (16 rows x 8 NN columns) += A (16 rows of the tile at a, depth HD)
// times B^T (NN rows of the tile at b, depth HD), for NN = 8 * NP2 * 2:
// both operands by non-transposed ldmatrix.
template <int HD, int NP2>
__device__ __forceinline__ void mma_abt(float (&c)[2 * NP2][4], uint32_t a,
                                        uint32_t b) {
  constexpr int LDS = HD + PAD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(a + 16 * kk * sizeof(bf16), af);
    uint32_t bf[NP2][4];
#pragma unroll
    for (int np = 0; np < NP2; ++np)
      ldsm_x4(b + (16 * np * LDS + 16 * kk) * sizeof(bf16), bf[np]);
#pragma unroll
    for (int np = 0; np < NP2; ++np) {
      mma_bf16(c[2 * np], af, bf[np][0], bf[np][1]);
      mma_bf16(c[2 * np + 1], af, bf[np][2], bf[np][3]);
    }
  }
}

// acc (16 rows x HD) += A (16 x 16 KS, bf16 fragments in registers) times
// the tile at b (16 KS rows of depth x HD columns, ldmatrix.trans)
template <int HD, int KS>
__device__ __forceinline__ void mma_at(float (&acc)[HD / 8][4],
                                       const uint32_t (&a)[KS][4],
                                       uint32_t b) {
  constexpr int LDS = HD + PAD;
  constexpr int DG = HD / 16 < 4 ? HD / 16 : 4;   // fragments per batch
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int d0 = 0; d0 < HD / 16; d0 += DG) {
      uint32_t bf[DG][4];
#pragma unroll
      for (int i = 0; i < DG; ++i)
        ldsm_x4_trans(b + (16 * kk * LDS + 16 * (d0 + i)) * sizeof(bf16),
                      bf[i]);
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        mma_bf16(acc[2 * (d0 + i)], a[kk], bf[i][0], bf[i][1]);
        mma_bf16(acc[2 * (d0 + i) + 1], a[kk], bf[i][2], bf[i][3]);
      }
    }
  }
}

// Grid (B * KV, ceil(T / 64)).  Warp w owns keys k0 + 16 w .. + 15; the
// block walks (query head g of the kv head, query tile) steps, step j + 1's
// Q, dO, lse and D loading by cp.async while step j computes.  WINDOW
// (window > 0) is a template argument: the window's terms are compiled out
// of the unwindowed kernel, which at hd 128 would otherwise spill (255
// registers, 32 bytes; without them 248 and none).
template <int HD, bool WINDOW>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int S, int T_len, int H,
                          int KV, int causal, int window, int kofs,
                          float scale) {
  constexpr int LDS = HD + PAD;
  constexpr int ND = HD / 8;       // 8-column tiles of dk and dv
  constexpr uint32_t TILE_B = 64 * LDS * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t Ks = smem_addr(mma_smem);
  const uint32_t Vs = Ks + TILE_B;
  const uint32_t Qs = Vs + TILE_B;         // 2 stages
  const uint32_t dOs = Qs + 2 * TILE_B;    // 2 stages
  float* Lf = reinterpret_cast<float*>(mma_smem + 6 * TILE_B);  // 2 x 64
  float* Df = Lf + 2 * BQ;                                       // 2 x 64

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * BK;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KV * HD;
  const size_t koff = (size_t)b * T_len * krow + (size_t)kvh * HD;
  const float scale_log2 = scale * LOG2E;
  // under the causal mask the query tiles before the key tile (at its
  // position k0 + kofs) see none of its keys: the walk starts at the query
  // tile holding it; under a window it ends before the first query past
  // every key's window
  const int q_start = causal ? min(S, (k0 + kofs) / BQ * BQ) : 0;
  const int q_end = WINDOW ? min(S, k0 + kofs + BK - 1 + window) : S;
  const int nq = max(0, (q_end - q_start + BQ - 1) / BQ);  // tiles a head
  const int steps = G * nq;

  auto load_step = [&](int j) {    // step j's tiles into stage j % 2
    const int h = kvh * G + j / nq, q0 = q_start + (j % nq) * BQ;
    const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
    const int st = j % 2;
    load_tile<HD>(Qs + st * TILE_B, q + qoff, qrow, q0, S, tid);
    load_tile<HD>(dOs + st * TILE_B, dO + qoff, qrow, q0, S, tid);
    load_row64(smem_addr(Lf + st * BQ), lse + ((size_t)b * H + h) * S, q0, S,
               tid);
    load_row64(smem_addr(Df + st * BQ), D + ((size_t)b * H + h) * S, q0, S,
               tid);
  };

  load_tile<HD>(Ks, k + koff, krow, k0, T_len, tid);
  load_tile<HD>(Vs, v + koff, krow, k0, T_len, tid);
  if (steps > 0) load_step(0);
  cp_async_commit();

  float adk[ND][4], adv[ND][4];    // rows g, g + 8; columns 8 j + 2 t, + 1
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  const uint32_t ka = Ks + 16 * warp * LDS * sizeof(bf16) + a_lane<LDS>(lane);
  const uint32_t va = Vs + 16 * warp * LDS * sizeof(bf16) + a_lane<LDS>(lane);
  const int kr0 = k0 + 16 * warp + g;        // this lane's first key row

  for (int j = 0; j < steps; ++j) {
    const int st = j % 2;
    const int q0 = q_start + (j % nq) * BQ;
    if (j + 1 < steps) {
      load_step(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // step j's tiles landed for all threads
    const uint32_t Qt = Qs + st * TILE_B, dOt = dOs + st * TILE_B;
    const float* Lt = Lf + st * BQ;
    const float* Dt = Df + st * BQ;
    // the warp's keys see no query of this tile's half h2 when every key
    // is past its last row: skip that half
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c0 = 32 * h2;                 // first query column
      if (causal && k0 + kofs + 16 * warp > q0 + c0 + 31) continue;
      // nor when every query of the half is past every key's window
      if (WINDOW && q0 + c0 - window >= k0 + kofs + 16 * warp + 15)
        continue;
      // s^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_abt<HD, 2>(s, ka,
                     Qt + c0 * LDS * sizeof(bf16) + b_lane<LDS>(lane));
      mma_abt<HD, 2>(dp, va,
                     dOt + c0 * LDS * sizeof(bf16) + b_lane<LDS>(lane));
      // P^T and dS^T on the fragments; bf16 A operands of the next products
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = c0 + 8 * n + 2 * t;    // query column in the tile
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c + e % 2, kpos = kr0 + 8 * (e / 2);
          const int qpos = q0 + qc, kg = kpos + kofs;
          const bool ok = qpos < S && kpos < T_len &&
                          (!causal || kg <= qpos) &&
                          (!WINDOW || kg > qpos - window);
          const float pe = ex2(fmaf(s[n][e], scale_log2, -Lt[qc] * LOG2E));
          p[e] = ok ? pe : 0.f;
          ds[e] = p[e] * (dp[n][e] - Dt[qc]);
        }
        pa[n / 2][2 * (n % 2)] = pack_bf16(p[0], p[1]);
        pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p[2], p[3]);
        da[n / 2][2 * (n % 2)] = pack_bf16(ds[0], ds[1]);
        da[n / 2][2 * (n % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += P^T dO, dk += dS^T Q over the 32 queries
      const uint32_t off = c0 * LDS * sizeof(bf16) + t_lane<LDS>(lane);
      mma_at<HD, 2>(adv, pa, dOt + off);
      mma_at<HD, 2>(adk, da, Qt + off);
    }
    __syncthreads();               // stage st is read; step j + 2 may land
  }
  if (steps == 0) cp_async_wait<0>();  // no query sees the key tile

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = kr0 + 8 * i;
    if (kr < T_len) {
      bf16* dkr = dk + koff + (size_t)kr * krow + 2 * t;
      bf16* dvr = dv + koff + (size_t)kr * krow + 2 * t;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * d) =
            __floats2bfloat162_rn(adk[d][2 * i] * scale,
                                  adk[d][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * d) =
            __floats2bfloat162_rn(adv[d][2 * i], adv[d][2 * i + 1]);
      }
    }
  }
}

// Grid (B * H, ceil(S / 64)): block (bh, y) takes query tile
// ceil(S / 64) - 1 - y (the longest causal key range first).  Warp w owns
// query rows q0 + 16 w .. + 15; key tile j + 1 loads while tile j computes.
template <int HD>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, bf16* __restrict__ dq,
                        int S, int T_len, int H, int KV, int causal,
                        int window, int kofs, float scale) {
  constexpr int LDS = HD + PAD;
  constexpr int ND = HD / 8;
  constexpr uint32_t TILE_B = 64 * LDS * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t Qs = smem_addr(mma_smem);
  const uint32_t dOs = Qs + TILE_B;
  const uint32_t Ks = dOs + TILE_B;        // 2 stages
  const uint32_t Vs = Ks + 2 * TILE_B;     // 2 stages

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KV * HD;
  const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
  const size_t koff = (size_t)b * T_len * krow + (size_t)kvh * HD;
  const float scale_log2 = scale * LOG2E;
  // the block's keys (local positions) the tile's rows can see
  const int k_end = causal ? min(T_len, q0 + BQ - kofs) : T_len;
  // the first key tile holding a key inside the window of row q0
  const int k_begin =
      window > 0 ? max(0, q0 - window + 1 - kofs) / BK * BK : 0;
  const int n_tiles = max(0, (k_end - k_begin + BK - 1) / BK);
  const int row0 = q0 + 16 * warp;           // this warp's first row

  if (n_tiles > 0) {               // else the tile's rows see no key: dq 0
    load_tile<HD>(Qs, q + qoff, qrow, q0, S, tid);
    load_tile<HD>(dOs, dO + qoff, qrow, q0, S, tid);
    load_tile<HD>(Ks, k + koff, krow, k_begin, T_len, tid);
    load_tile<HD>(Vs, v + koff, krow, k_begin, T_len, tid);
    cp_async_commit();
  }

  // this lane's rows g, g + 8: lse in log2 units and D
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    const size_t at = ((size_t)b * H + h) * S + r;
    l2[i] = r < S ? lse[at] * LOG2E : 0.f;
    dd[i] = r < S ? D[at] : 0.f;
  }

  float adq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;

  const uint32_t qa = Qs + 16 * warp * LDS * sizeof(bf16) + a_lane<LDS>(lane);
  const uint32_t ga = dOs + 16 * warp * LDS * sizeof(bf16) + a_lane<LDS>(lane);

  for (int j = 0; j < n_tiles; ++j) {
    const int kt0 = k_begin + j * BK, st = j % 2;
    if (j + 1 < n_tiles) {
      load_tile<HD>(Ks + (1 - st) * TILE_B, k + koff, krow, kt0 + BK, T_len,
                    tid);
      load_tile<HD>(Vs + (1 - st) * TILE_B, v + koff, krow, kt0 + BK, T_len,
                    tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // tile j (and Q, dO) landed
    const uint32_t Kt = Ks + st * TILE_B, Vt = Vs + st * TILE_B;
    // 32 keys at a time (dq, s and dP in registers at hd 128 without a
    // spill); a half whose keys are all past the warp's rows is skipped
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c0 = 32 * h2;                 // first key of the half
      if (causal && kt0 + kofs + c0 > row0 + 15) continue;
      // nor one whose keys are all at or below every row's window edge
      if (window > 0 && kt0 + kofs + c0 + 31 <= row0 - window) continue;
      // s = Q K^T and dP = dO V^T: 16 rows x 32 keys
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      const uint32_t kv = c0 * LDS * sizeof(bf16) + b_lane<LDS>(lane);
      mma_abt<HD, 2>(s, qa, Kt + kv);
      mma_abt<HD, 2>(dp, ga, Vt + kv);
      uint32_t da[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kt0 + c0 + 8 * n + 2 * t + e % 2;
          const int qpos = row0 + g + 8 * (e / 2), kg = kpos + kofs;
          const bool ok = qpos < S && kpos < T_len &&
                          (!causal || kg <= qpos) &&
                          (window <= 0 || kg > qpos - window);
          const float pe = ex2(fmaf(s[n][e], scale_log2, -l2[e / 2]));
          ds[e] = ok ? pe * (dp[n][e] - dd[e / 2]) : 0.f;
        }
        da[n / 2][2 * (n % 2)] = pack_bf16(ds[0], ds[1]);
        da[n / 2][2 * (n % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dq += dS K over the half's keys
      mma_at<HD, 2>(adq, da,
                    Kt + c0 * LDS * sizeof(bf16) + t_lane<LDS>(lane));
    }
    __syncthreads();               // stage st is read; tile j + 2 may land
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r < S) {
      bf16* dqr = dq + qoff + (size_t)r * qrow + 2 * t;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * d) =
            __floats2bfloat162_rn(adq[d][2 * i] * scale,
                                  adq[d][2 * i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch_dot(const void* o, const void* dO, void* D, int B, int S,
                       int H, cudaStream_t st) {
  constexpr int L = HD / (16 / sizeof(T));
  const long threads = (long)B * S * H * L;
  flash_bwd_dot_kernel<T, HD><<<(unsigned)((threads + 255) / 256), 256, 0,
                                st>>>((const T*)o, (const T*)dO, (float*)D,
                                      B, S, H);
  return cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const void* lse, void* dq, void* dk, void* dv,
               void* D, int B, int S, int T_len, int H, int KV, int causal,
               int window, int kofs, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  if (err == cudaSuccess) err = launch_dot<float, HD>(o, dO, D, B, S, H, st);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32_kernel<HD>
      <<<dim3(B * KV, (T_len + BK - 1) / BK), NT, bytes, st>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)dO, (const float*)lse, (const float*)D, (float*)dk,
          (float*)dv, S, T_len, H, KV, causal, window, kofs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32_kernel<HD>
      <<<dim3(B * H, (S + BQ - 1) / BQ), NT, bytes, st>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)dO, (const float*)lse, (const float*)D, (float*)dq,
          S, T_len, H, KV, causal, window, kofs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
cudaError_t allow_mma_smem() {
  const int bytes = (int)mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<HD, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<HD, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  return err != cudaSuccess ? err : cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dO, const void* lse, void* dq, void* dk, void* dv,
                void* D, int B, int S, int T_len, int H, int KV, int causal,
                int window, int kofs, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = mma_smem_bytes<HD>();
  cudaError_t err = allow_mma_smem<HD>();
  if (err == cudaSuccess) err = launch_dot<bf16, HD>(o, dO, D, B, S, H, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * KV, (T_len + BK - 1) / BK);
  if (window > 0)
    flash_bwd_dkdv_mma_kernel<HD, true><<<grid, MMA_NT, bytes, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO,
        (const float*)lse, (const float*)D, (bf16*)dk, (bf16*)dv, S, T_len,
        H, KV, causal, window, kofs, scale);
  else
    flash_bwd_dkdv_mma_kernel<HD, false><<<grid, MMA_NT, bytes, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO,
        (const float*)lse, (const float*)D, (bf16*)dk, (bf16*)dv, S, T_len,
        H, KV, causal, window, kofs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_mma_kernel<HD>
      <<<dim3(B * H, (S + BQ - 1) / BQ), MMA_NT, bytes, st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO,
          (const float*)lse, (const float*)D, (bf16*)dq, S, T_len, H, KV,
          causal, window, kofs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int blocks_per_sm(int which) {
  cudaError_t err = allow_mma_smem<HD>();
  int n = 0;
  if (err == cudaSuccess)
    err = which == 0
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, flash_bwd_dkdv_mma_kernel<HD, false>, MMA_NT,
                    mma_smem_bytes<HD>())
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, flash_bwd_dq_mma_kernel<HD>, MMA_NT,
                    mma_smem_bytes<HD>());
  return err == cudaSuccess ? n : -(int)err;
}

bool valid(int B, int S, int T_len, int H, int KV, int window, int kofs) {
  return B >= 1 && S >= 1 && T_len >= 1 && KV >= 1 && H % KV == 0 &&
         window >= 0 && kofs >= 0 && (S + BQ - 1) / BQ <= 65535 &&
         (T_len + BK - 1) / BK <= 65535;
}

}  // namespace

extern "C" {

// q, o, dO, dq: (B, S, H, hd); k, v, dk, dv: (B, T, KV, hd); all
// contiguous and 16-byte aligned, in the entry's type.  lse: (B, H, S)
// float32 from the forward; D: a float32 scratch of B * H * S.  H is a
// multiple of KV; hd is 16, 32, 64 or 128 (a smaller head size is
// zero-padded by the wrapper, which passes the true scale); causal is 0 or
// 1; window >= 0 (0: none; > 0: keep kpos > qpos - window) and k_offset
// >= 0 (the position of key 0), as in the forward that wrote lse (or lse
// and o of the whole key sequence, of which k and v are a block); scale is
// 1 / sqrt(hd).
int flash_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                  const void* dO, const void* lse, void* dq, void* dk,
                  void* dv, void* D, int B, int S, int T, int H, int KV,
                  int hd, int causal, int window, int k_offset, float scale,
                  void* stream) {
  if (!valid(B, S, T, H, KV, window, k_offset))
    return (int)cudaErrorInvalidValue;
#define FLASH_BWD_F32(HD_)                                                   \
  case HD_:                                                                  \
    return launch_f32<HD_>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S, T, H,   \
                           KV, causal, window, k_offset, scale, stream);
  switch (hd) {
    FLASH_BWD_F32(16)
    FLASH_BWD_F32(32)
    FLASH_BWD_F32(64)
    FLASH_BWD_F32(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_F32
}

int flash_bwd_bf16(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, const void* lse, void* dq,
                   void* dk, void* dv, void* D, int B, int S, int T, int H,
                   int KV, int hd, int causal, int window, int k_offset,
                   float scale, void* stream) {
  if (!valid(B, S, T, H, KV, window, k_offset))
    return (int)cudaErrorInvalidValue;
#define FLASH_BWD_BF16(HD_)                                                  \
  case HD_:                                                                  \
    return launch_bf16<HD_>(q, k, v, o, dO, lse, dq, dk, dv, D, B, S, T, H,  \
                            KV, causal, window, k_offset, scale, stream);
  switch (hd) {
    FLASH_BWD_BF16(16)
    FLASH_BWD_BF16(32)
    FLASH_BWD_BF16(64)
    FLASH_BWD_BF16(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_BF16
}

// Blocks of the bf16 dk/dv (which = 0) or dq (which = 1) kernel resident
// per SM at head size hd (the occupancy API, at the kernel's shared memory
// and registers); minus a CUDA error.
int flash_bwd_bf16_blocks_per_sm(int hd, int which) {
  switch (hd) {
    case 16: return blocks_per_sm<16>(which);
    case 32: return blocks_per_sm<32>(which);
    case 64: return blocks_per_sm<64>(which);
    case 128: return blocks_per_sm<128>(which);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
