// K3: the RWKV6 WKV scan (data-dependent-decay linear attention), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv6_kernel; entry wkv6_fwd, model-layout wrapper ops.py::wkv6).
// Plain versions: src/repro_torch/kernels/rwkv6/ref.py (wkv6_chunked_plain,
// the reference's chunked math; wkv6_plain, the per-token recurrence;
// wkv6_tiled_plain, the decomposition below in plain PyTorch).
//
// Per (batch b, head h), with an hd x hd float32 state S carried along
// the sequence and log w <= 0 the per-token decay:
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// y and the final S are written in float32; r/k/v arrive as float32 or
// bfloat16, log w, u and S0 as float32.  The chunked form is exact for any
// tiling, so the kernel takes its own tiles of 64 tokens across the whole
// sequence, whatever chunk the caller names: a 511-token prompt (chunk 1)
// is 8 tiles, the last one ragged, as a 512-token prompt is.
//
// Two passes, one launch each, on the caller's stream:
// - Pass 1, wkv6_states_kernel: grid (B * H, ceil(hd / 16)), one block of
//   8 warps per head and 16 rows of the state (the key index: rows are
//   independent, so a block reads only its 16 columns of k and log w and
//   no block repeats another's scan or exponentials).  It walks the tiles
//   in order, two at a time: per tile, G = the suffix sums of log w
//   (G_t = the sum over the tile's later tokens) and tot their total, and
//   S <- exp(tot) S + (k exp(G))^T v, the product on the tensor cores with
//   the k-steps split over two accumulators.  The state entering each tile
//   goes to a float32 scratch (B * H, n_tiles, hd, hd), the last to s_out.
//   The next pair's k, v and log w are loaded into registers while the
//   block works on the current pair.
// - Pass 2, wkv6_outputs_kernel: grid (B * H, n_tiles), 4 warps: every
//   tile at once from its entering state.  With the tile split into four
//   sub-tiles of 16 tokens, and within sub-tile J: F = cumsum(log w) from
//   its start, F-_t = F_{t-1} (0 at the start), tot_J its total.  For a
//   query t of sub-tile I, q^ = r exp(F-), Lam_I = tot_0 + ... + tot_{I-1}:
//     y = (q^ exp(Lam_I)) S                                 earlier tiles
//       + sum_{J<I} (q^ (k exp(tot_J - F) exp(D_IJ))^T) v   earlier sub-tiles
//       + sum_{tau<t in I} (sum_i r k exp(F-_t - F_tau)) v  own sub-tile
//       + (r . u . k) v_t
//   with D_IJ = tot_{J+1} + ... + tot_{I-1}.  Every exponent is a sum of
//   log w over tokens, so no factor exceeds 1 and nothing overflows,
//   however strong the decay (the reference's k' = k exp(-L) overflows
//   float32 in a 64-token tile once log w averages below about -1.4), and
//   none is a difference of two sums longer than a sub-tile, whose
//   rounding would cost the small exponents that matter most.  Steps:
//   1. loads: log w first (cp.async), then r and k; the entering state
//      and v, first read in step 6, as a second group;
//   2. F and tot per (column, sub-tile); the bonus r . u . k per token;
//   3. per warp, its sub-tile's 16 x 16 block of A = q k'^T: the two 8 x 8
//      blocks on the diagonal pairwise on the CUDA cores (the factors as
//      running products of w, the 16 lanes' partial sums reduced and
//      scattered by shuffles), the 8 x 8 block below them on the tensor
//      cores, split at the sub-tile's token 7;
//   4. q^ in place of r and k exp(tot_J - F) in place of k; the tables
//      exp(Lam_I) and exp(D_IJ);
//   5. A below the own sub-tiles, twelve 16 x 8 tiles, three a warp;
//   6. per warp 16 value columns of all 64 rows: (q^ exp(Lam)) S + A v
//      + bonus v, on the tensor cores.
//
// Tensor cores: mma.sync.m16n8k8 with TF32 operands and float32
// accumulation, for every product of both passes.  The bfloat16 entry
// rounds the float32 operands to TF32 once (10 mantissa bits against
// bfloat16's 7; r/k/v in bfloat16 are exact in TF32); the float32 entry
// splits each operand into a TF32 high part and a TF32 remainder and
// takes three products (3xTF32), which keeps the float32 1e-4 contract.
// wgmma and TMA are not used: the products are 64 x 64 x 64 per tile and
// the tensor cores are far from the limit; the time goes to the chains of
// dependent loads, exponentials, shuffles and barriers around them.
//
// What bounds it on the H100: at the served shape (1 x 512 tokens x 32
// heads x 64) the function moves 15.7 MB (0.0047 ms at 3.35 TB/s) and
// needs a few tens of MFLOP: bytes bound it.  What sets the time is the
// chain of dependent steps: pass 1's walk (four 128-token steps of loads,
// a scan, exponentials and 16 products a warp) over 128 blocks, one per
// SM; pass 2's six steps, 256 blocks two per SM (110 KB of shared memory
// each) in one wave, whose first step moves every block's 56 KB at once
// through the L2.  The old design (one block per head and 16 value
// columns walking every tile with q k'^T recomputed per column block on
// the CUDA cores) took 0.12 ms there and a step per token at chunk 1.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (src/repro_torch/kernels/_build.py); each entry point launches both
// passes and returns cudaGetLastError() after the last launch.  hd is at
// most 64 and a multiple of 4 (the wrapper pads smaller head sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HD = 64;             // tile width; smaller heads are zero-padded
constexpr int TILE = 64;           // tokens per tile
constexpr int SUB = 16;            // tokens per sub-tile (16 query rows)
constexpr int NSUB = TILE / SUB;
constexpr int NT = 128;            // threads per pass-2 block
constexpr int TI = 16;             // state rows per pass-1 block
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory row strides (floats), chosen so that the fragment loads of
// a warp fall in distinct banks: (row t, column g) reads and (row g,
// columns 2t, 2t + 1) pairs need a stride = 8 (mod 32), (rows 2t, 2t + 1,
// column g) reads 4 (mod 16).
constexpr int LD1K = TI + 8;       // pass 1, k~ [token][state row]
constexpr int LD1V = HD + 8;       // pass 1, v [token][value column]
constexpr int LD = HD + 8;         // pass 2, r, k, F and A

typedef __nv_bfloat16 bf16;

template <typename T> struct Raw4;              // four elements as loaded
template <> struct Raw4<float> { typedef float4 type; };
template <> struct Raw4<bf16> { typedef uint2 type; };

__device__ __forceinline__ float4 to_f32x4(float4 x) { return x; }
__device__ __forceinline__ float4 to_f32x4(uint2 x) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// four consecutive elements at p (16-byte aligned in float32, 8 in
// bfloat16), or zeros when !in
template <typename T>
__device__ __forceinline__ typename Raw4<T>::type ld4(const T* p, bool in) {
  typedef typename Raw4<T>::type R;
  return in ? *reinterpret_cast<const R*>(p) : R{};
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col).
// Lane (g = lane / 4, t = lane % 4) holds a = {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)}, b = {(t, g), (t + 4, g)} and
// c = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 2 takes the k index of each group of 8 in the order 0, 4, 1, 5, 2,
// 6, 3, 7: a lane's two k-values t and t + 4 are then the adjacent columns
// 2t, 2t + 1 of the A operand (one float2 load) and rows 2t, 2t + 1 of the
// B operand.  A product sums over k, so one order on both operands gives
// the same result.

// Fragments in TF32: the high parts and, with SPLIT (3xTF32, the float32
// entry), the TF32 remainders.
template <bool SPLIT>
struct FragA {
  uint32_t hi[4], lo[4];
};

template <bool SPLIT>
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool SPLIT>
__device__ __forceinline__ FragA<SPLIT> frag_a(float a0, float a1, float a2,
                                               float a3) {
  FragA<SPLIT> f;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(a[i]);
    if (SPLIT) f.lo[i] = tf32(a[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

template <bool SPLIT>
__device__ __forceinline__ FragB<SPLIT> frag_b(float b0, float b1) {
  FragB<SPLIT> f;
  f.hi[0] = tf32(b0);
  f.hi[1] = tf32(b1);
  if (SPLIT) {
    f.lo[0] = tf32(b0 - __uint_as_float(f.hi[0]));
    f.lo[1] = tf32(b1 - __uint_as_float(f.hi[1]));
  }
  return f;
}

// c += a b (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi)
template <bool SPLIT>
__device__ __forceinline__ void mma(float (&c)[4], const FragA<SPLIT>& a,
                                    const FragB<SPLIT>& b) {
  if (SPLIT) {
    mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  }
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// ---------------------------------------------------------------------------
// Pass 1: the state entering each tile
// ---------------------------------------------------------------------------

constexpr int NT1 = 256;           // pass 1: 8 warps, one per 8 value columns
constexpr int PAIR = 2 * TILE;     // tokens a step of pass 1 takes
constexpr int SEG = PAIR / (NT1 / TI);   // tokens per scan segment (8)
constexpr int NSEG = PAIR / SEG;
constexpr size_t STATES_SMEM =
    (PAIR * LD1K + PAIR * LD1V + NSEG * TI + 2 * TI) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NT1)
wkv6_states_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ lw, const float* __restrict__ s0,
                   float* __restrict__ scratch, float* __restrict__ s_out,
                   int S, int H, int hd) {
  constexpr bool SPLIT = sizeof(T) == 4;
  typedef typename Raw4<T>::type R4;
  extern __shared__ __align__(16) float sm1[];
  float* Kt = sm1;                   // k, then k 2^G    [token][state row]
  float* Vt = Kt + PAIR * LD1K;      // v                [token][column]
  float* part = Vt + PAIR * LD1V;    // segment sums of log2 w
  float* tot = part + NSEG * TI;     // [tile of the pair][state row]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * TI;
  const int n_tiles = (S + TILE - 1) / TILE;
  const size_t rs = (size_t)H * hd;                  // token stride
  const size_t base = (size_t)b * S * rs + (size_t)h * hd;
  const size_t hh = (size_t)hd * hd;

  // this lane's state fragment: rows i0 + g, i0 + g + 8; columns
  // 8 warp + 2t, + 1
  const int ra = i0 + g, rb = ra + 8, c = 8 * warp + 2 * t;
  const bool in_a = ra < hd && c < hd, in_b = rb < hd && c < hd;
  float s[4];
  {
    const float* p = s0 + (size_t)bh * hh;
    s[0] = in_a ? p[(size_t)ra * hd + c] : 0.f;
    s[1] = in_a ? p[(size_t)ra * hd + c + 1] : 0.f;
    s[2] = in_b ? p[(size_t)rb * hd + c] : 0.f;
    s[3] = in_b ? p[(size_t)rb * hd + c + 1] : 0.f;
  }
  auto store_state = [&](const float (&x)[4], float* dst) {
    if (in_a)
      *reinterpret_cast<float2*>(dst + (size_t)ra * hd + c) =
          make_float2(x[0], x[1]);
    if (in_b)
      *reinterpret_cast<float2*>(dst + (size_t)rb * hd + c) =
          make_float2(x[2], x[3]);
  };

  // suffix-scan layout: state row ii, segment sg of SEG tokens (segments
  // 0..7 are the pair's first tile, 8..15 its second)
  const int ii = tid % TI, sg = tid / TI;

  // the next pair's k (128 tokens x 16 rows: two 4-vectors a thread), v
  // (128 x 64: eight) and this thread's SEG values of log w, in registers
  R4 pk[2], pv[8];
  float pl[SEG];
  auto prefetch = [&](int t0) {
    const int n = min(PAIR, S - t0);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int q = tid + NT1 * m, row = q / 4, col = i0 + 4 * (q % 4);
      pk[m] = ld4(k + base + (size_t)(t0 + row) * rs + col,
                  row < n && col < hd);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int q = tid + NT1 * m, row = q / 16, col = 4 * (q % 16);
      pv[m] = ld4(v + base + (size_t)(t0 + row) * rs + col,
                  row < n && col < hd);
    }
#pragma unroll
    for (int e = 0; e < SEG; ++e) {
      const int row = SEG * sg + e;
      pl[e] = row < n && i0 + ii < hd
                  ? lw[base + (size_t)(t0 + row) * rs + i0 + ii] : 0.f;
    }
  };

  prefetch(0);
  for (int j = 0; j < n_tiles; j += 2) {
    store_state(s, scratch + ((size_t)bh * n_tiles + j) * hh);
    __syncthreads();             // the last pair's products are done
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int q = tid + NT1 * m;
      st4(Kt + (q / 4) * LD1K + 4 * (q % 4), to_f32x4(pk[m]));
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int q = tid + NT1 * m;
      st4(Vt + (q / 16) * LD1V + 4 * (q % 16), to_f32x4(pv[m]));
    }
    float l2[SEG], sum = 0.f;
#pragma unroll
    for (int e = 0; e < SEG; ++e) {
      l2[e] = pl[e] * LOG2E;
      sum += l2[e];
    }
    part[sg * TI + ii] = sum;
    __syncthreads();
    if (j + 2 < n_tiles) prefetch((j + 2) * TILE);

    // G (suffix sums of log2 w to the end of each tile of the pair) and
    // each tile's total; k <- k 2^G (rows past the sequence are zero)
    {
      const int first = sg / (NSEG / 2) * (NSEG / 2);
      float after = 0.f, all = 0.f;
#pragma unroll
      for (int p = NSEG / 2 - 1; p >= 0; --p) {
        const float x = part[(first + p) * TI + ii];
        if (first + p > sg) after += x;
        all += x;
      }
      if (sg == first) tot[(first / (NSEG / 2)) * TI + ii] = all;
#pragma unroll
      for (int e = SEG - 1; e >= 0; --e) {
        Kt[(SEG * sg + e) * LD1K + ii] *= ex2(after);
        after += l2[e];
      }
    }
    __syncthreads();

    // per tile of the pair: (k 2^G)^T v on the tensor cores, the k-steps
    // over two accumulators each; S_mid = 2^tot0 S + P0 enters the second
    // tile and 2^tot1 S_mid + P1 the next pair
    float p2[2][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < PAIR / 8; ++ks) {
      const float* kr = Kt + (8 * ks + t) * LD1K;
      const float* vr = Vt + (8 * ks + t) * LD1V + 8 * warp + g;
      mma<SPLIT>(p2[ks / 8][ks % 2],
                 frag_a<SPLIT>(kr[g], kr[g + 8], kr[4 * LD1K + g],
                               kr[4 * LD1K + g + 8]),
                 frag_b<SPLIT>(vr[0], vr[4 * LD1V]));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float da = ex2(tot[q * TI + g]), db = ex2(tot[q * TI + g + 8]);
      s[0] = da * s[0] + p2[q][0][0] + p2[q][1][0];
      s[1] = da * s[1] + p2[q][0][1] + p2[q][1][1];
      s[2] = db * s[2] + p2[q][0][2] + p2[q][1][2];
      s[3] = db * s[3] + p2[q][0][3] + p2[q][1][3];
      if (q == 0 && j + 1 < n_tiles)
        store_state(s, scratch + ((size_t)bh * n_tiles + j + 1) * hh);
    }
  }
  store_state(s, s_out + (size_t)bh * hh);
}

// ---------------------------------------------------------------------------
// Pass 2: every tile's outputs from its entering state
// ---------------------------------------------------------------------------

constexpr int LDB = HD + 4;        // pass 2, v and S: read as B (rows 2t, 2t+1)
constexpr int N_OFF = NSUB * (NSUB - 1) / 2;   // (I, J) pairs with J < I

constexpr int OUT_SMEM_FLOATS = 4 * TILE * LD    // R (then q^), K (then
                                                 // k 2^G), F, A
                                + 2 * TILE * LDB  // v, S
                                + NSUB * HD       // tot
                                + NSUB * HD       // 2^Lam per sub-tile
                                + N_OFF * HD      // 2^D per (I, J)
                                + TILE + HD;      // bonus, u
constexpr size_t OUT_SMEM = OUT_SMEM_FLOATS * sizeof(float);

// The twelve 16 x 8 tiles of A below the own sub-tiles, three a warp:
// (query sub-tile I, key tile jn of 8 keys), jn < 2 I.
__constant__ int kJobI[NT / 32][3] = {{3, 3, 3}, {3, 3, 3}, {2, 2, 2},
                                      {2, 1, 1}};
__constant__ int kJobN[NT / 32][3] = {{0, 1, 2}, {3, 4, 5}, {0, 1, 2},
                                      {3, 0, 1}};

// one butterfly step of a reduce-scatter over the 16 lanes of a half-warp:
// lanes with bit m keep the upper W slots, the others the lower, each
// adding its partner's copy of them
template <int W>
__device__ __forceinline__ void reduce_step(float (&acc)[32], bool up, int m) {
#pragma unroll
  for (int p = 0; p < W; ++p) {
    const float send = up ? acc[p] : acc[p + W];
    const float keep = up ? acc[p + W] : acc[p];
    acc[p] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
wkv6_outputs_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u,
                    const float* __restrict__ scratch, float* __restrict__ y,
                    int S, int H, int hd) {
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) float sm[];
  float* Rs = sm;                    // r, then q^ = r 2^(F_{t-1})
  float* Ks = Rs + TILE * LD;        // k, then k 2^(tot_J - F)
  float* Fs = Ks + TILE * LD;        // log w, then F (per sub-tile, log2)
  float* As = Fs + TILE * LD;        // A[t][tau], tau <= t
  float* Vs = As + TILE * LD;        // v
  float* Ss = Vs + TILE * LDB;       // the entering state
  float* tot = Ss + TILE * LDB;      // [J][i]
  float* El = tot + NSUB * HD;       // [I][i] = 2^Lam_I
  float* Dt = El + NSUB * HD;        // [I (I - 1) / 2 + J][i] = 2^D_IJ
  float* bonus = Dt + N_OFF * HD;
  float* U = bonus + TILE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tile = blockIdx.y, n_tiles = gridDim.y;
  const int t0 = tile * TILE, n = min(TILE, S - t0);
  const size_t rs = (size_t)H * hd;
  const size_t base = (size_t)b * S * rs + (size_t)h * hd;

  // 1. log w and (float32) r and k by cp.async, a first group; the
  //    entering state and (float32) v, first read in step 6, a second;
  //    bfloat16 r and k through registers, bfloat16 v held in registers
  //    until step 5 (4-vectors; zeros past n and hd)
  typename Raw4<T>::type xv[8];
  {
    const float* st = scratch + ((size_t)bh * n_tiles + tile) * hd * hd;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
      const bool tin = row < n && col < hd;
      const size_t o = base + (size_t)(t0 + row) * rs + col;
      cp_async16(Fs + row * LD + col, tin ? lw + o : lw, tin);
      if (SPLIT) {
        cp_async16(Rs + row * LD + col,
                   tin ? reinterpret_cast<const float*>(r + o) : lw, tin);
        cp_async16(Ks + row * LD + col,
                   tin ? reinterpret_cast<const float*>(k + o) : lw, tin);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
      const bool sin = row < hd && col < hd, tin = row < n && col < hd;
      const size_t o = base + (size_t)(t0 + row) * rs + col;
      cp_async16(Ss + row * LDB + col, sin ? st + (size_t)row * hd + col : st,
                 sin);
      if (SPLIT)
        cp_async16(Vs + row * LDB + col,
                   tin ? reinterpret_cast<const float*>(v + o) : lw, tin);
      else
        xv[m] = ld4(v + o, tin);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (!SPLIT) {
      typename Raw4<T>::type xr[8], xk[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
        const bool tin = row < n && col < hd;
        const size_t o = base + (size_t)(t0 + row) * rs + col;
        xr[m] = ld4(r + o, tin);
        xk[m] = ld4(k + o, tin);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
        st4(Rs + row * LD + col, to_f32x4(xr[m]));
        st4(Ks + row * LD + col, to_f32x4(xk[m]));
      }
    }
    if (tid < HD) U[tid] = tid < hd ? u[(size_t)h * hd + tid] : 0.f;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  __syncthreads();

  // 2. per (column, sub-tile): F = cumsum of log2 w from the sub-tile's
  //    start, tot its total; the current-token bonus r . u . k per token
  {
    const int i = tid % HD;
#pragma unroll
    for (int J = tid / HD; J < NSUB; J += NT / HD) {
      float F = 0.f;
#pragma unroll
      for (int e = 0; e < SUB; ++e) {
        const int o = (SUB * J + e) * LD + i;
        F += Fs[o] * LOG2E;
        Fs[o] = F;
      }
      tot[J * HD + i] = F;
    }
    const int tok = tid / 2, half = tid % 2;
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i4 = 32 * half + 4 * ((e + half) % 8);
      const float4 a = lds4(Rs + tok * LD + i4), c = lds4(Ks + tok * LD + i4),
                   w = lds4(U + i4);
      d += a.x * w.x * c.x + a.y * w.y * c.y + a.z * w.z * c.z +
           a.w * w.w * c.w;
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) bonus[tok] = d;
  }
  __syncthreads();

  // 3. sub-tile `warp`'s 16 x 16 block of A (tau <= t)
  {
    // 3a. its two 8 x 8 diagonal blocks, pairwise: A[t][tau] for tau < t,
    //     sum_i r_t k_tau 2^(F_{t-1} - F_tau), with 2^(F_{t-1} - F_tau) =
    //     the product over tau < s < t of w_s = 2^(F_s - F_{s-1}).  Lane
    //     (blk, lq) takes columns 4 lq .. 4 lq + 3 of all 28 pairs of block
    //     blk; a reduce-scatter over the 16 lanes leaves each two sums.
    const int blk = lane / 16, lq = lane % 16;
    const int row0 = SUB * warp + 8 * blk;
    float acc[32];
#pragma unroll
    for (int p = 0; p < 32; ++p) acc[p] = 0.f;
    {
      float4 F[8], R[8], w[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        F[a] = lds4(Fs + (row0 + a) * LD + 4 * lq);
        R[a] = lds4(Rs + (row0 + a) * LD + 4 * lq);
      }
#pragma unroll
      for (int a = 1; a < 7; ++a)
        w[a] = make_float4(ex2(F[a].x - F[a - 1].x), ex2(F[a].y - F[a - 1].y),
                           ex2(F[a].z - F[a - 1].z), ex2(F[a].w - F[a - 1].w));
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        const float4 kc = lds4(Ks + (row0 + c) * LD + 4 * lq);
        float4 e = make_float4(kc.x, kc.y, kc.z, kc.w);   // k 2^(F_{t-1} - F_tau)
#pragma unroll
        for (int a = c + 1; a < 8; ++a) {
          acc[a * (a - 1) / 2 + c] += R[a].x * e.x + R[a].y * e.y +
                                      R[a].z * e.z + R[a].w * e.w;
          if (a < 7)
            e = make_float4(e.x * w[a].x, e.y * w[a].y, e.z * w[a].z,
                            e.w * w[a].w);
        }
      }
    }
    reduce_step<16>(acc, lq & 8, 8);
    reduce_step<8>(acc, lq & 4, 4);
    reduce_step<4>(acc, lq & 2, 2);
    reduce_step<2>(acc, lq & 1, 1);
    const int slot0 = 16 * ((lq >> 3) & 1) + 8 * ((lq >> 2) & 1) +
                      4 * ((lq >> 1) & 1) + 2 * (lq & 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = slot0 + e;
      int a = 1;
      while (a * (a + 1) / 2 <= p) ++a;
      if (p < 28) As[(row0 + a) * LD + row0 + p - a * (a - 1) / 2] = acc[e];
    }
    // zeros on and above the diagonal of the 16 x 16 block (its rows
    // 8..15 x keys 0..7 quadrant is 3b's)
    for (int e = lane; e < SUB * SUB; e += 32) {
      const int qa = e / SUB, kc = e % SUB;
      if ((qa < 8 && kc >= 8) || (qa / 8 == kc / 8 && kc % 8 >= qa % 8))
        As[(SUB * warp + qa) * LD + SUB * warp + kc] = 0.f;
    }

    // 3b. rows 8..15 x keys 0..7 of the block on the tensor cores, split
    //     at the sub-tile's token 7: r_t 2^(F_{t-1} - F_7) against
    //     k_tau 2^(F_7 - F_tau)
    const int tq = SUB * warp + 8 + g, tk = SUB * warp + g;
    const int mid = SUB * warp + 7;
    float co[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const int pc = 8 * ks + 2 * t;
      const float2 fm = lds2(Fs + mid * LD + pc);
      const float2 rq = lds2(Rs + tq * LD + pc);
      const float2 fq = lds2(Fs + (tq - 1) * LD + pc);
      const float2 kk = lds2(Ks + tk * LD + pc);
      const float2 fk = lds2(Fs + tk * LD + pc);
      mma<SPLIT>(co,
                 frag_a<SPLIT>(0.f, rq.x * ex2(fq.x - fm.x), 0.f,
                               rq.y * ex2(fq.y - fm.y)),
                 frag_b<SPLIT>(kk.x * ex2(fm.x - fk.x),
                               kk.y * ex2(fm.y - fk.y)));
    }
    *reinterpret_cast<float2*>(As + tq * LD + SUB * warp + 2 * t) =
        make_float2(co[2], co[3]);
  }
  __syncthreads();

  // 4. q^ = r 2^(F_{t-1}) in place of r (F_{t-1} = 0 at a sub-tile's
  //    start) and k 2^(tot_J - F) in place of k; the factors of steps 5
  //    and 6, every exponent a sum of log2 w: 2^Lam_I (Lam_I = tot_0 + ...
  //    + tot_{I-1}) and 2^D_IJ (D_IJ = tot_{J+1} + ... + tot_{I-1})
  {
    const int i = tid % HD;
    float tj[NSUB];
#pragma unroll
    for (int J = 0; J < NSUB; ++J) tj[J] = tot[J * HD + i];
#pragma unroll
    for (int m = 0; m < TILE / 2; ++m) {
      const int row = tid / HD + 2 * m, o = row * LD + i;
      const float fm = row % SUB ? Fs[o - LD] : 0.f;
      Rs[o] *= ex2(fm);
      Ks[o] *= ex2(tj[row / SUB] - Fs[o]);
    }
    if (tid < HD) {
#pragma unroll
      for (int I = 0; I < NSUB; ++I) {
        float x = 0.f;
#pragma unroll
        for (int J = 0; J < I; ++J) x += tj[J];
        El[I * HD + i] = ex2(x);
      }
    } else {
#pragma unroll
      for (int I = 1; I < NSUB; ++I)
#pragma unroll
        for (int J = 0; J < I; ++J) {
          float x = 0.f;
#pragma unroll
          for (int J2 = J + 1; J2 < I; ++J2) x += tj[J2];
          Dt[(I * (I - 1) / 2 + J) * HD + i] = ex2(x);
        }
    }
  }
  __syncthreads();

  // 5. A below the own sub-tiles: for a query of sub-tile I and a key of
  //    an earlier sub-tile J, q^ against k 2^(tot_J - F) 2^D_IJ; and the
  //    bfloat16 v into shared memory
  {
    if (!SPLIT) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int q = tid + NT * m;
        st4(Vs + (q / 16) * LDB + 4 * (q % 16), to_f32x4(xv[m]));
      }
    }
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      const int I = kJobI[warp][jj], jn = kJobN[warp][jj];
      const int ta = SUB * I + g, tb = ta + 8, tau = 8 * jn + g;
      const float* dt = Dt + (I * (I - 1) / 2 + jn / 2) * HD;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks) {
        const int pc = 8 * ks + 2 * t;
        const float2 qa = lds2(Rs + ta * LD + pc), qb = lds2(Rs + tb * LD + pc);
        const float2 kk = lds2(Ks + tau * LD + pc), dd = lds2(dt + pc);
        mma<SPLIT>(c, frag_a<SPLIT>(qa.x, qb.x, qa.y, qb.y),
                   frag_b<SPLIT>(kk.x * dd.x, kk.y * dd.y));
      }
      *reinterpret_cast<float2*>(As + ta * LD + 8 * jn + 2 * t) =
          make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(As + tb * LD + 8 * jn + 2 * t) =
          make_float2(c[2], c[3]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 6. warp w: value columns 16 w .. 16 w + 15 of all 64 rows,
  //    y = (q^ 2^Lam) S + A v + (r . u . k) v
  float yacc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[mi][nt][e] = 0.f;
  const int c0 = 16 * warp + g;             // this lane's B column
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    const int pc = 8 * ks + 2 * t;
    FragB<SPLIT> bs[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      bs[nt] = frag_b<SPLIT>(Ss[pc * LDB + c0 + 8 * nt],
                             Ss[(pc + 1) * LDB + c0 + 8 * nt]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float2 e = lds2(El + mi * HD + pc);
      const float2 qa = lds2(Rs + (SUB * mi + g) * LD + pc);
      const float2 qb = lds2(Rs + (SUB * mi + g + 8) * LD + pc);
      const FragA<SPLIT> fa = frag_a<SPLIT>(qa.x * e.x, qb.x * e.x,
                                            qa.y * e.y, qb.y * e.y);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma<SPLIT>(yacc[mi][nt], fa, bs[nt]);
    }
  }
#pragma unroll
  for (int kt = 0; kt < TILE / 8; ++kt) {
    const int pc = 8 * kt + 2 * t;
    FragB<SPLIT> bv[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      bv[nt] = frag_b<SPLIT>(Vs[pc * LDB + c0 + 8 * nt],
                             Vs[(pc + 1) * LDB + c0 + 8 * nt]);
#pragma unroll
    for (int mi = kt / 2; mi < 4; ++mi) {
      const float2 aa = lds2(As + (SUB * mi + g) * LD + pc);
      const float2 ab = lds2(As + (SUB * mi + g + 8) * LD + pc);
      const FragA<SPLIT> fa = frag_a<SPLIT>(aa.x, ab.x, aa.y, ab.y);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma<SPLIT>(yacc[mi][nt], fa, bv[nt]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int ta = SUB * mi + g, tb = ta + 8;
    const float ba = bonus[ta], bb = bonus[tb];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = 16 * warp + 8 * nt + 2 * t;
      const float2 va = lds2(Vs + ta * LDB + c), vb = lds2(Vs + tb * LDB + c);
      if (ta < n && c < hd)
        *reinterpret_cast<float2*>(y + base + (size_t)(t0 + ta) * rs + c) =
            make_float2(yacc[mi][nt][0] + ba * va.x,
                        yacc[mi][nt][1] + ba * va.y);
      if (tb < n && c < hd)
        *reinterpret_cast<float2*>(y + base + (size_t)(t0 + tb) * rs + c) =
            make_float2(yacc[mi][nt][2] + bb * vb.x,
                        yacc[mi][nt][3] + bb * vb.y);
    }
  }
}

template <typename T>
cudaError_t allow_smem() {           // once per entry: above 48 KB
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)STATES_SMEM);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        wkv6_outputs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)OUT_SMEM);
  }();
  return err;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* s_out,
           void* scratch, int B, int S, int H, int hd, void* stream) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  wkv6_states_kernel<T><<<dim3(B * H, (hd + TI - 1) / TI), NT1, STATES_SMEM,
                          st>>>(
      (const T*)k, (const T*)v, (const float*)lw, (const float*)s0,
      (float*)scratch, (float*)s_out, S, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_outputs_kernel<T><<<dim3(B * H, (S + TILE - 1) / TILE), NT, OUT_SMEM,
                           st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)scratch, (float*)y, S, H, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int pass) {
  int n = 0;
  cudaError_t err;
  err = allow_smem<T>();
  if (err == cudaSuccess)
    err = pass == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, wkv6_states_kernel<T>, NT1, STATES_SMEM)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, wkv6_outputs_kernel<T>, NT, OUT_SMEM);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// r, k, v: (B, S, H, hd) in the entry's type; lw: (B, S, H, hd) f32;
// u: (H, hd) f32; s0: (B, H, hd, hd) f32; y: (B, S, H, hd) f32;
// s_out: (B, H, hd, hd) f32; scratch: (B * H, ceil(S / 64), hd, hd) f32.
// All contiguous and 16-byte aligned; hd a multiple of 4, at most 64.
int wkv6_f32(const void* r, const void* k, const void* v, const void* lw,
             const void* u, const void* s0, void* y, void* s_out,
             void* scratch, int B, int S, int H, int hd, void* stream) {
  return launch<float>(r, k, v, lw, u, s0, y, s_out, scratch, B, S, H, hd,
                       stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* lw,
              const void* u, const void* s0, void* y, void* s_out,
              void* scratch, int B, int S, int H, int hd, void* stream) {
  return launch<bf16>(r, k, v, lw, u, s0, y, s_out, scratch, B, S, H, hd,
                      stream);
}

// Resident blocks per SM of pass 1 or 2 of the bfloat16 (bf16 != 0) or
// float32 entry, from the occupancy calculator; -(CUDA error) on failure.
int wkv6_blocks_per_sm(int pass, int bf16_entry) {
  return bf16_entry ? blocks_per_sm<bf16>(pass) : blocks_per_sm<float>(pass);
}

}  // extern "C"
