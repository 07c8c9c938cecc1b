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
// mask keeps kpos <= qpos, both counted from 0; a sliding window > 0 also
// keeps only kpos > qpos - window (the reference's full_attention /
// chunked_attention, src/repro/models/common.py:235-236,276-277; the TPU
// kernel takes no window); keys at kpos >= T are masked; masked scores are
// -1e30, as in the TPU kernel.
// k_offset is the position of key 0 (k and v a block of a longer key
// sequence, one rank's block of the keys' sequence: split.py); the masks
// compare kpos + k_offset with qpos.  A row with no kept key in the block
// writes a zero output row and lse = -inf (the block adds nothing to the
// row's softmax when split.py combines the blocks).
//
// Common to both entries:
// - Grid (B * H, ceil(S / 64)): one block per (batch x head, 64-row query
//   tile).  The TPU grid's sequential key-block axis becomes a loop inside
//   the block, so m, l and acc stay in registers for the whole row tile.
//   Query tiles are taken in reverse order, so the blocks with the most
//   key tiles under the causal mask are scheduled first.  Under a window
//   every query tile from the window's width on walks the same number of
//   key tiles, so the order matters only for the first few; it is kept.
// - The kernel reads the model layout (B, S, H, hd) for q and
//   (B, T, KV, hd) for k/v in place: the kv head of query head h is
//   h / (H / KV), so K and V are never repeated per query head, and the
//   ragged edges (rows past S, keys past T) are masked here, with no
//   padding on the host.
// - Key tiles wholly above the diagonal are skipped, as in the TPU kernel.
//   Under a window the key loop also starts at the tile holding the first
//   key inside the window of the query tile's first row,
//   max(0, q0 - window + 1) rounded down to a key tile: the tiles before
//   it are skipped.  The tiles after it may still be wholly outside the
//   window of the tile's later rows (with a window under 64 a row's first
//   visited tile can be).  Such a row has no kept key yet: its running max
//   stays -1e30, and its probabilities are taken against 0 in place of the
//   max, so each masked score gives exp(-1e30) = 0, not exp(0) = 1.  The row
//   then adds nothing to l or acc until its first kept key (its diagonal
//   is always visited), and its lse is that of the kept keys alone.
//
// bfloat16 entry (the served type): flash_fwd_mma_kernel, on the tensor
// cores, with FlashAttention-2's register-resident softmax.
// - 4 warps (128 threads); warp w owns query rows 16 w .. 16 w + 15 of the
//   block's 64.  Both products run as mma.sync.m16n8k16 bf16 x bf16 -> f32
//   with operands from ldmatrix: S = Q K^T (Q's fragments are loaded into
//   registers once; each k-step loads its four K fragments before its
//   eight products), the online softmax on S's accumulator fragments (a
//   thread holds 2 rows x 16 columns; row max by two quad shuffles, row
//   sums per thread, added across the quad once at the end), then P is
//   rounded to bf16 in registers and is directly the A operand of P V (the
//   m16n8 accumulator layout of two adjacent score tiles is the m16k16 A
//   layout).  No shared-memory P tile.  Rounding P to bf16 before P V is
//   what the reference's full_attention does in bf16; attention_plain
//   keeps P in float32, within the 2e-2 bf16 contract.
// - The softmax works in log2 units: m is the row max of the raw scores
//   times scale log2(e), and p = 2^(s scale log2(e) - m) is one FFMA and
//   one ex2.approx.  acc is rescaled only when a row max of the warp moved
//   (a warp vote); in late key tiles it rarely does.  Shared-memory and
//   global addresses are computed once per thread, outside the tile loop.
// - Shared memory holds bf16 tiles: Q (64 x hd) and two stages of K and V
//   (64 x hd each).  Rows are padded to hd + 8 elements (16 bytes), so the
//   8 row addresses of each ldmatrix fall in 8 different 16-byte bank
//   groups: no bank conflicts at any hd.  At hd 128 that is
//   5 x 64 x 136 x 2 = 87,040 bytes per block (80 KB unpadded), so two
//   blocks are resident per SM (the smem limit, 227 KB, allows two;
//   __launch_bounds__(128, 2) keeps the registers within two as well).
//   flash_fwd_bf16_blocks_per_sm reports the figure from the occupancy
//   API; chip_smoke.py prints it beside ptxas -v.
// - K and V tiles are copied with cp.async (16 bytes a thread, zero-filled
//   past T) into the stage the block is not reading, so tile j + 1's load
//   overlaps tile j's products; one __syncthreads after the wait and one
//   after the products, before the stage is refilled.
// - Why mma.sync and not wgmma: at the served shape (1 x 512 x 512, 16
//   query heads / 8 kv heads of 128, causal) the function moves 6.29 MB
//   (0.00188 ms at 3.35 TB/s) and needs 1.08 GFLOP over the causal pairs;
//   even mma.sync at half of the 989 TFLOP/s wgmma rate does that in about
//   0.002 ms.  What sets the kernel's time there is the chain of the last
//   query tile's block (8 tile steps, one block per SM in a single wave of
//   128 blocks) and the launch, not the tensor cores' peak.  A tile step
//   is bound by the latency of its dependent ldmatrix -> mma -> softmax ->
//   mma sequence within one warp, not by a pipe's throughput.
// - Measured and not kept (PERF.md, section 6): splitting the long query
//   tiles' key ranges across blocks, with a second kernel to merge the
//   partial (m, l, acc), shortened the chain, but blocks then share SMs
//   and the merge costs more than the chain saves, at 128 to 2048 tokens;
//   32 rows per warp (128-row blocks) spills at hd 128 and halves the
//   blocks at the served shape; issuing tile j + 1's q k^T beside tile j's
//   softmax (K one tile ahead of V) gained nothing.
// - ptxas -v (sm_90a, CUDA 12.8): 210 registers at hd 128 (147, 124, 102 at
//   hd 64, 32, 16; 206, 146, 114, 92 before the window's terms), no spills;
//   128 HMMA in the hd 128 kernel's SASS.  At window 128 the served shape
//   takes 0.0084 ms of device time (0.0146 without a window) and 2048
//   tokens 0.0238 (0.0693): PERF.md, section 6.
//
// float32 entry: flash_fwd_f32_kernel, float32 FMAs on the CUDA cores (an
// exact float32 route: rounding the operands to bf16 or TF32 would break
// the 2e-5 float32 contract).  Shared memory holds the Q tile, the current
// K and V tiles (float32, 64 x hd each: 96 KB at hd 128, one block per
// SM) and the 64 x 64 tile of probabilities; Q and K rows are padded to
// hd + 1 floats.  256 threads as 16 x 16: a thread owns query rows
// ty + 16 i (i < 4) and key columns tx + 16 j (j < 4) of the score tile,
// and the same rows times output columns tx + 16 j (j < hd / 16) of acc;
// the 16 threads of a row are 16 lanes of one warp, so the row max and
// row sum are shuffles.
//
// Both entries optionally write each query row's log-sum-exp of its masked,
// scaled scores (m + log l, in natural units; the bf16 kernel keeps m in
// log2 units and converts) to a float32 (B, H, S) array, which the backward
// K2' (flash_bwd.cu) reads to recompute P; serving passes a null pointer.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (src/repro_torch/kernels/_build.py); each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int NT = 256;            // threads per block, 16 x 16
constexpr int RI = BQ / 16;        // query rows per thread
constexpr int CJ = BK / 16;        // score columns per thread
constexpr int LDP = BK + 16;       // padded row of the probability tile

template <int HD>
constexpr size_t smem_bytes() {
  return ((size_t)(BQ + BK) * (HD + 1) + (size_t)BK * HD +
          (size_t)BQ * LDP) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int T_len, int H,
                     int KV, int causal, int window, int kofs,
                     float scale) {
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
  const float* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const float* kb = k + (size_t)b * T_len * krow + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * T_len * krow + (size_t)kvh * HD;
  float* ob = o + (size_t)b * S * qrow + (size_t)h * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[r * LD + d] = q0 + r < S ? qb[(size_t)(q0 + r) * qrow + d] : 0.f;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // the block's keys (local positions) the tile's rows can see
  const int k_end = causal ? min(T_len, q0 + BQ - kofs) : T_len;
  const int k_begin =
      window > 0 ? max(0, q0 - window + 1 - kofs) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q is loaded; the last tile's K, V, P are read
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < T_len;
      Ks[r * LD + d] = in ? kb[(size_t)(k0 + r) * krow + d] : 0.f;
      Vs[r * HD + d] = in ? vb[(size_t)(k0 + r) * krow + d] : 0.f;
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
        const int kpos = k0 + tx + 16 * j, kg = kpos + kofs;
        const bool ok = kpos < T_len && (!causal || kg <= qpos) &&
                        (window <= 0 || kg > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      // a row with no kept key yet takes its probabilities against 0
      const float m_sub = m_new == NEG_INF ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_sub);
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
        ob[(size_t)r * qrow + tx + 16 * j] = acc[i][j] / den;
      if (lse != nullptr && tx == 0)     // -inf: no kept key
        lse[((size_t)b * H + h) * S + r] =
            l[i] > 0.f ? m[i] + logf(den) : -__int_as_float(0x7f800000);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async double buffering
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int MMA_WARPS = 4;
constexpr int MMA_NT = 32 * MMA_WARPS;   // threads per block
constexpr int PAD = 8;                   // bf16 elements of padding per row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
constexpr size_t mma_smem_bytes() {      // Q, 2 stages of K and of V
  return (size_t)(BQ + 4 * BK) * (HD + PAD) * sizeof(bf16);
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

// rows r0 .. r0 + 63 of a (rows x hd) slice with row stride ld elements
// into the shared tile at byte address dst (rows of HD + PAD); rows >= n
// are zero-filled.  Thread tid copies the 16-byte chunk tid % CH of rows
// tid / CH + RS i.
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
  for (int i = 0; i < BK / RS; ++i) {
    const bool in = r0 + r + RS * i < n;
    cp_async16(dst + RS * i * (HD + PAD) * sizeof(bf16),
               in ? g + (size_t)RS * i * ld : src, in);
  }
}

// Grid (B * H, ceil(S / 64)): block (bh, y) takes query tile
// ceil(S / 64) - 1 - y (the longest causal key range first; under a window
// the ranges are equal from the window's width on).
template <int HD>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int T_len, int H,
                     int KV, int causal, int window, int kofs,
                     float scale_log2) {
  constexpr int LDS = HD + PAD;    // shared row, in elements
  constexpr int KD = HD / 16;      // k-steps of q k^T
  constexpr int NS = BK / 8;       // 8-key tiles of the scores
  constexpr int ND = HD / 8;       // 8-column tiles of the output
  constexpr int DG = HD / 16 < 4 ? HD / 16 : 4;   // v fragments per batch
  static_assert(BQ == 16 * MMA_WARPS && BK % 16 == 0 && HD % 16 == 0,
                "tile shapes");
  constexpr uint32_t STAGE = BK * LDS * sizeof(bf16);   // bytes
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t Qs = smem_addr(mma_smem);        // BQ x LDS
  const uint32_t Ks = Qs + BQ * LDS * sizeof(bf16);   // 2 stages
  const uint32_t Vs = Ks + 2 * STAGE;                 // 2 stages

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;           // fragment row, column pair
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)KV * HD;
  const bf16* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * T_len * krow + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * T_len * krow + (size_t)kvh * HD;
  bf16* ob = o + (size_t)b * S * qrow + (size_t)h * HD;
  // the block's keys (local positions) the tile's rows can see
  const int k_end = causal ? min(T_len, q0 + BQ - kofs) : T_len;
  // the first key tile holding a key inside the window of row q0
  const int k_begin =
      window > 0 ? max(0, q0 - window + 1 - kofs) / BK * BK : 0;
  const int n_tiles = max(0, (k_end - k_begin + BK - 1) / BK);
  const int row0 = q0 + 16 * warp;                // this warp's first row
  // each lane's row address in the ldmatrix of Q, K and V (bytes)
  const uint32_t q_lane =
      ((16 * warp + lane % 16) * LDS + (lane / 16) * 8) * sizeof(bf16);
  const uint32_t k_lane =
      ((lane % 8 + (lane / 16) * 8) * LDS + ((lane / 8) % 2) * 8) *
      sizeof(bf16);
  const uint32_t v_lane =
      ((lane % 8 + ((lane / 8) % 2) * 8) * LDS + (lane / 16) * 8) *
      sizeof(bf16);

  if (n_tiles > 0) {               // else every row of the tile is empty
    load_tile<HD>(Qs, qb, qrow, q0, S, tid);
    load_tile<HD>(Ks, kb, krow, k_begin, T_len, tid);
    load_tile<HD>(Vs, vb, krow, k_begin, T_len, tid);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp's 16: acc[j] holds columns 8 j + 2 t, +1;
  // m is kept in log2 units (scores times scale_log2)
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[KD][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK, st = j % 2;
    if (j + 1 < n_tiles) {              // tile j + 1 into the other stage
      load_tile<HD>(Ks + (1 - st) * STAGE, kb, krow, k0 + BK, T_len, tid);
      load_tile<HD>(Vs + (1 - st) * STAGE, vb, krow, k0 + BK, T_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // tile j (and Q) landed for all threads
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(Qs + q_lane + 16 * kk * sizeof(bf16), qf[kk]);
    }
    const uint32_t Kt = Ks + st * STAGE + k_lane;
    const uint32_t Vt = Vs + st * STAGE + v_lane;

    // s = q k^T: 16 rows x 64 keys per warp, as 8 tiles of 16 x 8; each
    // k-step loads all its K fragments before its products
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[NS / 2][4];      // keys 16 np .. + 15, dims 16 kk .. + 15
#pragma unroll
      for (int np = 0; np < NS / 2; ++np)
        ldsm_x4(Kt + (16 * np * LDS + 16 * kk) * sizeof(bf16), kf[np]);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        mma_bf16(s[2 * np], qf[kk], kf[np][0], kf[np][1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[np][2], kf[np][3]);
      }
    }

    // mask, row max of the raw scores over the quad (the scale is > 0);
    // the window masks keys at or below qpos - window of the warp's rows
    if (k0 + BK > T_len || (causal && k0 + kofs + BK - 1 > row0) ||
        (window > 0 && k0 + kofs <= row0 + 15 - window)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + 2 * t + e % 2, kg = kpos + kofs;
          const int qpos = row0 + g + 8 * (e / 2);
          if (kpos >= T_len || (causal && kg > qpos) ||
              (window > 0 && kg <= qpos - window))
            s[n][e] = NEG_INF;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with every score of the tile masked keeps its max
      const float m_new =
          mx[i] == NEG_INF ? m[i] : fmaxf(m[i], mx[i] * scale_log2);
      alpha[i] = m_new > m[i] ? ex2(m[i] - m_new) : 1.f;
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // a row with no kept key yet takes its probabilities against 0:
    // 2^(-1e30 scale_log2) = 0 for each masked score
    const float m_sub[2] = {m[0] == NEG_INF ? 0.f : m[0],
                            m[1] == NEG_INF ? 0.f : m[1]};
    // rescale acc only when a row max of the warp moved (late tiles rarely)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
    }

    // p = 2^(s scale_log2 - m) in float32 for l, in bf16 as the A operand
    // of p v: score tiles 2 kk and 2 kk + 1 are the k-step kk of p v
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = ex2(fmaf(s[n][0], scale_log2, -m_sub[0]));
      const float p1 = ex2(fmaf(s[n][1], scale_log2, -m_sub[0]));
      const float p2 = ex2(fmaf(s[n][2], scale_log2, -m_sub[1]));
      const float p3 = ex2(fmaf(s[n][3], scale_log2, -m_sub[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[n / 2][2 * (n % 2)] = pack_bf16(p0, p1);
      pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p2, p3);
    }

    // acc += p v: v's rows are keys, so its B fragments come transposed;
    // DG fragments are loaded before their products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int d0 = 0; d0 < HD / 16; d0 += DG) {
        uint32_t vf[DG][4];        // keys 16 kk .. + 15, dims 16 dp .. + 15
#pragma unroll
        for (int i = 0; i < DG; ++i)
          ldsm_x4_trans(Vt + (16 * kk * LDS + 16 * (d0 + i)) * sizeof(bf16),
                        vf[i]);
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          mma_bf16(acc[2 * (d0 + i)], pa[kk], vf[i][0], vf[i][1]);
          mma_bf16(acc[2 * (d0 + i) + 1], pa[kk], vf[i][2], vf[i][3]);
        }
      }
    }
    __syncthreads();               // stage st is read; tile j + 2 may land
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r < S) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      if (lse != nullptr && t == 0)   // m in log2 units; -inf: no kept key
        lse[((size_t)b * H + h) * S + r] =
            l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2
                   : -__int_as_float(0x7f800000);
      bf16* orow = ob + (size_t)r * qrow + 2 * t;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
            __floats2bfloat162_rn(acc[d][2 * i] * inv,
                                  acc[d][2 * i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int T_len, int H, int KV,
               int causal, int window, int kofs, float scale,
               void* stream) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_f32_kernel<HD><<<grid, NT, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, S, T_len, H, KV, causal, window, kofs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int T_len, int H, int KV,
                int causal, int window, int kofs, float scale,
                void* stream) {
  const size_t bytes = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_mma_kernel<HD><<<grid, MMA_NT, bytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      S, T_len, H, KV, causal, window, kofs, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int blocks_per_sm() {
  const size_t bytes = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_fwd_mma_kernel<HD>, MMA_NT, bytes);
  return err == cudaSuccess ? n : -(int)err;
}

bool valid(int B, int S, int T_len, int H, int KV, int window, int kofs) {
  return B >= 1 && S >= 1 && T_len >= 1 && KV >= 1 && H % KV == 0 &&
         window >= 0 && kofs >= 0 && (S + BQ - 1) / BQ <= 65535;
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, T, KV, hd); all contiguous, in the entry's
// type (the bf16 entry's pointers 16-byte aligned).  H is a multiple of
// KV; hd is 16, 32, 64 or 128 (a smaller head size is zero-padded by the
// wrapper, which passes the true scale); causal is 0 or 1; window >= 0 (0:
// none; > 0: keep kpos > qpos - window); k_offset >= 0 is the position of
// key 0 (0: q and k start together); scale is 1 / sqrt(hd).
// lse, when not null: (B, H, S) float32, the log-sum-exp of each query
// row's masked, scaled scores (m + log l), which the backward (K2',
// flash_bwd.cu) reads; serving passes null.
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int S, int T, int H, int KV, int hd,
                  int causal, int window, int k_offset, float scale,
                  void* stream) {
  if (!valid(B, S, T, H, KV, window, k_offset))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_f32<16>(q, k, v, o, lse, B, S, T, H, KV, causal,
                            window, k_offset, scale, stream);
    case 32:
      return launch_f32<32>(q, k, v, o, lse, B, S, T, H, KV, causal,
                            window, k_offset, scale, stream);
    case 64:
      return launch_f32<64>(q, k, v, o, lse, B, S, T, H, KV, causal,
                            window, k_offset, scale, stream);
    case 128:
      return launch_f32<128>(q, k, v, o, lse, B, S, T, H, KV, causal,
                             window, k_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int T, int H, int KV, int hd,
                   int causal, int window, int k_offset, float scale,
                   void* stream) {
  if (!valid(B, S, T, H, KV, window, k_offset))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_bf16<16>(q, k, v, o, lse, B, S, T, H, KV, causal,
                             window, k_offset, scale, stream);
    case 32:
      return launch_bf16<32>(q, k, v, o, lse, B, S, T, H, KV, causal,
                             window, k_offset, scale, stream);
    case 64:
      return launch_bf16<64>(q, k, v, o, lse, B, S, T, H, KV, causal,
                             window, k_offset, scale, stream);
    case 128:
      return launch_bf16<128>(q, k, v, o, lse, B, S, T, H, KV, causal,
                              window, k_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the bf16 kernel resident per SM at head size hd (the occupancy
// API, at the kernel's shared memory and registers); minus a CUDA error.
int flash_fwd_bf16_blocks_per_sm(int hd) {
  switch (hd) {
    case 16: return blocks_per_sm<16>();
    case 32: return blocks_per_sm<32>();
    case 64: return blocks_per_sm<64>();
    case 128: return blocks_per_sm<128>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
