// K2: the flash-attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash/kernel.py
// (_flash_fwd_kernel; entry flash_attention_fwd, GQA wrapper
// ops.py::flash_attention, oracle ref.py::attention_ref).  Plain version:
// src/repro_torch/kernels/flash/ref.py (attention_plain).
//
// Per (batch b, query head h) it computes
//   out = softmax(q k^T * scale, mask) v,    scale = 1 / sqrt(hd)
// with an online softmax over the key tiles: a running max m, a running
// sum l and an accumulator acc, all float32, rescaled by exp(m_old - m_new)
// at each tile, and out = acc / max(l, 1e-30) cast to q's type.  The causal
// mask keeps kpos <= qpos, both counted from 0; keys at kpos >= T are
// masked; masked scores are -1e30, as in the TPU kernel.  q/k/v arrive as
// float32 or bfloat16 and all arithmetic is float32.
//
// Design.
// - Grid (B * H, ceil(S / 64)): one block per (batch x head, 64-row query
//   tile).  The TPU grid's sequential key-block axis becomes a loop inside
//   the block, so m, l and acc stay in registers for the whole row tile.
//   Query tiles are taken in reverse order, so the blocks with the most
//   key tiles under the causal mask are scheduled first.
// - The kernel reads the model layout (B, S, H, hd) for q and
//   (B, T, KV, hd) for k/v in place: the kv head of query head h is
//   h / (H / KV), so K and V are never repeated per query head (the
//   reference's transformer repeats them, and ops.py broadcasts them), and
//   the ragged edges (rows past S, keys past T) are masked here, with no
//   padding on the host.
// - Shared memory holds the Q tile, the current K and V tiles (float32,
//   64 x hd each: 96 KB at hd 128, so it is dynamic shared memory, set with
//   cudaFuncSetAttribute) and the 64 x 64 tile of probabilities.  Q and K
//   rows are padded to hd + 1 floats so that the column walks of q k^T are
//   free of bank conflicts.
// - 256 threads as 16 x 16: a thread owns query rows ty + 16 i (i < 4)
//   and key columns tx + 16 j (j < 4) of the score tile, and the same rows
//   times output columns tx + 16 j (j < hd / 16) of acc.  The 16 threads
//   of a row are 16 lanes of one warp, so the row max and row sum are
//   shuffles, and every thread keeps its rows' m and l itself.
// - Key tiles wholly above the diagonal are skipped, as in the TPU kernel.
//
// What bounds it on the H100: at the served shape (1 x 512 x 512, 16 query
// heads and 8 kv heads of 128, causal, bfloat16) the function moves 6.29 MB
// (0.00188 ms at 3.35 TB/s) and needs 1.08 GFLOP over the causal pairs
// (0.00109 ms on bfloat16 tensor cores), so bytes bound it.  This simple
// version runs float32 FMAs on the CUDA cores (no wgmma, no TMA) from
// shared memory, one block per SM at the served shape (128 blocks for 132
// SMs), and the block of the last query tile walks all 8 key tiles: its
// time is that block's chain of shared-memory loads and FMAs.
// chip_smoke.py measures it beside its bound.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (src/repro_torch/kernels/_build.py); each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int NT = 256;            // threads per block, 16 x 16
constexpr int RI = BQ / 16;        // query rows per thread
constexpr int CJ = BK / 16;        // score columns per thread
constexpr int LDP = BK + 16;       // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return ((size_t)(BQ + BK) * (HD + 1) + (size_t)BK * HD +
          (size_t)BQ * LDP) * sizeof(float);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                 int H, int KV, int causal, float scale) {
  constexpr int LD = HD + 1;       // padded row of the Q and K tiles
  constexpr int DJ = HD / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // BQ x LD
  float* Ks = Qs + BQ * LD;        // BK x LD
  float* Vs = Ks + BK * LD;        // BK x HD
  float* Ps = Vs + BK * HD;        // BQ x LDP

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KV * HD;
  const T* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const T* kb = k + (size_t)b * T_len * krow + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * T_len * krow + (size_t)kvh * HD;
  T* ob = o + (size_t)b * S * qrow + (size_t)h * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[r * LD + d] =
        q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * qrow + d]) : 0.f;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q is loaded; the last tile's K, V, P are read
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < T_len;
      Ks[r * LD + d] = in ? to_f32(kb[(size_t)(k0 + r) * krow + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[(size_t)(k0 + r) * krow + d]) : 0.f;
    }
    __syncthreads();

    // scores of this thread's rows and columns
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RI], kk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] += a[i] * kk[j];
    }

    // online softmax: mask, row max, rescale, probabilities, row sum
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < T_len && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float p[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = Ps[(ty + 16 * i) * LDP + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[t * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += p[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        store(&ob[(size_t)r * qrow + tx + 16 * j], acc[i][j] / den);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int T_len, int H, int KV, int causal, float scale,
              void* stream) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, NT, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, T_len, H, KV, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_len, int H, int KV, int hd, int causal, float scale,
           void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KV < 1 || H % KV != 0 ||
      (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, B, S, T_len, H, KV, causal, scale,
                              stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, S, T_len, H, KV, causal, scale,
                              stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, T_len, H, KV, causal, scale,
                              stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, T_len, H, KV, causal, scale,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, T, KV, hd); all contiguous, in the entry's
// type.  H is a multiple of KV; hd is 16, 32, 64 or 128; causal is 0 or 1;
// scale is 1 / sqrt(hd).
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int T, int H, int KV, int hd, int causal,
                  float scale, void* stream) {
  return launch<float>(q, k, v, o, B, S, T, H, KV, hd, causal, scale, stream);
}

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T, int H, int KV, int hd, int causal,
                   float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, hd, causal, scale,
                               stream);
}

}  // extern "C"
