// K3': the RWKV6 WKV scan's backward, for Hopper (sm_90a).
//
// The reference has no backward Pallas kernel: it differentiates its plain
// chunked scan (src/repro/models/rwkv6.py:97-131, wkv_chunked) with
// jax.grad.  This is the backward of K3 (wkv6.cu, which replaces
// src/repro/kernels/rwkv6/kernel.py::_wkv6_kernel).  Plain versions:
// src/repro_torch/kernels/rwkv6/ref.py (wkv6_bwd_tiled_plain, the
// decomposition below in plain PyTorch; wkv6_bwd_plain, the per-token
// reverse walk).
//
// Forward, per (batch b, head h), state S (hd x hd, row i = key index):
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// Given dy and dS_T, with G_t = dL/dS_t (G_T = dS_T):
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0
//   dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
//   dk_t = G_t v_t + u o r_t (v_t . dy_t)
//   dv_t = G_t^T k_t + (sum_i r_t u k_t) dy_t
//   du = sum_t r_t o k_t (v_t . dy_t)   (summed over the batch)
//   dlogw_t = c_t - B_t,  c_t = rowsum(S_t o G_t),  B_t = k_t o (G_t v_t)
// and c_{t-1} = c_t + A_t - B_t with A_t = r_t o (S_{t-1} dy_t) (since
// w_t S_{t-1} = S_t - k_t v_t^T): within a tile, dlogw needs only the
// vectors A and B and c at the tile's end, never a per-token state.
//
// The backward is the same kind of scan as the forward, mirrored in time,
// over the forward's 64-token tiles.  Three launches on the caller's
// stream:
// - B1, wkv6_bwd_states_kernel: grid (B * H, ceil(hd / 16)), 8 warps per
//   head and 16 rows of G (rows are independent).  It walks the tiles from
//   last to first, writing G at each tile's end to a float32 scratch
//   (B * H, n_tiles, hd, hd) and stepping
//     G <- diag(2^tot) G + (r o 2^F-)^T dy
//   (F- the exclusive prefix sums of log2 w over the tile, tot their
//   total) on the tensor cores; its last G is ds0.  The next tile's r, dy
//   and log w load into registers while the block works on the current.
// - B2, wkv6_bwd_tiles_kernel: grid (B * H, n_tiles), 8 warps: every tile
//   at once, from the forward's state entering it (K3's pass-1 scratch)
//   and B1's G at its end.  The tile is four 16-token sub-tiles; within
//   sub-tile J, F = cumsum(log2 w) from its start, F-_t = F_{t-1} (0 at the
//   start), tot_J its total.  After the shared loads and tables (w, F,
//   k~ = k 2^(tot_J - F), the bonus r . u . k, dy v^T on the diagonal
//   sub-tiles, A' below), two walks over the four sub-tiles run at the
//   same time, warps 0-3 and 4-7:
//     forward, S at each sub-tile's start (S_{J+1} = diag(2^tot_J) S_J
//       + k~^T v):  a_t = 2^F-_t o (S_J dy_t)
//       + sum_{s<t in J} (dy_t . v_s) k_s prod_{s<r<t} w_r;
//     backward, G at each sub-tile's end (G_{J-1} = diag(2^tot_J) G_J
//       + (r 2^F-)^T dy):  g_t = 2^(tot_J - F_t) o (G_J v_t)
//       + sum_{s>t in J} (dy_s . v_t) r_s prod_{t<r<s} w_r,
//       dv_t = k~_t G_J + sum_{s>t in J} A'[s][t] dy_s + (r u k)_t dy_t,
//       with A'[s][t] = sum_i r_s k_t prod_{t<r<s} w_r;
//   then dr = a + u k (v.dy), dk = g + u r (v.dy), A = r o a, B = k o g,
//   and dlogw by the recursion from c at the tile's end, rowsum(S o G) of
//   the last sub-tile's S and B1's G.  The state terms, the updates and
//   dy v^T on the tensor cores; the in-sub-tile sums (a 16 x 16 triangle a
//   sub-tile) on the CUDA cores as running products of w, branch-free.  A
//   warp owns 16 rows of its walk's state: the forward walk needs no
//   barrier between sub-tiles (a warp reads only its own rows of S), the
//   backward one a barrier of its 4 warps a sub-tile (dv reads all of G),
//   with G in two stages.  Each B2 block also writes its tile's du terms.
// - B3, wkv6_bwd_du_kernel: du summed over the batch and the tiles.
// Every exponent is a sum of log w over tokens (<= 0): no factor exceeds
// 1, and none is a difference of two sums longer than a sub-tile, however
// strong the decay; S_{t-1} = (S_t - k v^T) / w is never formed.  Blocks
// share no sum, and every sum has one fixed order: the result is
// deterministic.
//
// Tensor cores: mma.sync.m16n8k8, TF32 operands and float32 accumulation
// for the bfloat16 entry (r/k/v in bfloat16 are exact in TF32); the
// float32 entry splits each operand into a TF32 high part and remainder
// and takes three products (3xTF32), as K3 does.  dr, dk and dv are
// written in r's type, dlogw, du and ds0 in float32.
//
// What bounds it: at rwkv6-1.6b's training layer (4 x 512 tokens, 32
// heads of 64, bf16 r/k/v) the function moves ~107 MB (0.032 ms at 3.35
// TB/s); the per-token walk's ~2.7 G operations would take 0.0054 ms as
// TF32 products on the tensor cores (0.040 ms as float32 on the CUDA
// cores): the bound is bytes (chip_smoke.py::wkv6_bwd_bound_ms).  This
// design takes ~0.224 ms on an H100 (B1 ~0.040, B2 ~0.180, B3 ~0.004;
// PERF.md section 6).  B2 holds 211 KB of shared memory, so one block
// runs on an SM at a time: each block's loads (88 KB, with every SM
// loading at once) do not overlap another block's work, and its two walks
// are chains of dependent sub-tile steps.  Measured and not kept: 16 warps
// a block, each walk on 8 (no faster in bf16 timed in turns with this
// one; f32 5% faster); a persistent block per SM prefetching its next
// tile into L2 (no faster); the sub-tile loops unrolled (the two walks'
// code then thrashed the instruction cache: 1.6x slower).
// - ptxas -v (sm_90a, CUDA 12.8): B2 128 registers and a 144-byte stack
//   frame (A of the forward walk), with 8 / 24 bytes of spill stores /
//   loads (bf16; 16 / 48 in f32); B1 102 / 140 registers; B3 32; no other
//   spills.  92 / 276 HMMA in B2's SASS, 8 / 24 in B1's.
//
// Built by nvcc into the plain-C shared library repro_torch_wkv6_bwd and
// called through ctypes (src/repro_torch/kernels/_build.py); the entry
// points return cudaGetLastError() after the last launch.  hd is at most
// 64 and a multiple of 4 (the wrapper pads smaller head sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HD = 64;             // tile width; smaller heads are zero-padded
constexpr int TILE = 64;           // tokens per tile (the forward's tiles)
constexpr int SUB = 16;            // tokens per sub-tile
constexpr int NSUB = TILE / SUB;
constexpr int NT = 256;            // threads per block, both passes
constexpr int TI = 16;             // rows of G per B1 block
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

template <typename T> struct Raw4;              // four elements as loaded
template <> struct Raw4<float> { typedef float4 type; };
template <> struct Raw4<bf16> { typedef uint2 type; };

__device__ __forceinline__ float4 to_f32x4(float4 x) { return x; }
__device__ __forceinline__ float4 to_f32x4(uint2 x) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.y));
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

// two adjacent outputs at p, in the output's type
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// B2 takes the k index of each group of 8 in the order 0, 4, 1, 5, 2, 6,
// 3, 7 (K3's pass 2 does the same): a lane's two k-values t and t + 4 are
// then the adjacent columns 2t, 2t + 1 of a row-major A operand (one
// float2 load) and rows 2t, 2t + 1 of a row-major B operand.  A product
// sums over k, so one order on both operands gives the same result.

// ---------------------------------------------------------------------------
// B1: G at the end of each tile
// ---------------------------------------------------------------------------

constexpr int SEG = TILE / (NT / TI);   // tokens per scan segment (4)
constexpr int NSEG = TILE / SEG;
constexpr int LD1R = TI + 8;       // r 2^F- [token][state row]
constexpr int LD1Y = HD + 8;       // dy [token][column]
constexpr size_t STATES_SMEM =
    (TILE * LD1R + TILE * LD1Y + NSEG * TI + TI) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NT)
wkv6_bwd_states_kernel(const T* __restrict__ r, const float* __restrict__ lw,
                       const float* __restrict__ dy,
                       const float* __restrict__ dsT,
                       float* __restrict__ gscratch, float* __restrict__ ds0,
                       int S, int H, int hd) {
  constexpr bool SPLIT = sizeof(T) == 4;
  typedef typename Raw4<T>::type R4;
  extern __shared__ __align__(16) float sm1[];
  float* Rt = sm1;                   // r, then r 2^F-  [token][state row]
  float* Yt = Rt + TILE * LD1R;      // dy              [token][column]
  float* part = Yt + TILE * LD1Y;    // segment sums of log2 w
  float* tot = part + NSEG * TI;     // per state row

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * TI;
  const int n_tiles = (S + TILE - 1) / TILE;
  const size_t rs = (size_t)H * hd;                  // token stride
  const size_t base = (size_t)b * S * rs + (size_t)h * hd;
  const size_t hh = (size_t)hd * hd;

  // this lane's fragment of G: rows i0 + g, i0 + g + 8; columns
  // 8 warp + 2t, + 1
  const int ra = i0 + g, rb = ra + 8, c = 8 * warp + 2 * t;
  const bool in_a = ra < hd && c < hd, in_b = rb < hd && c < hd;
  float G[4];
  {
    const float* p = dsT + (size_t)bh * hh;
    G[0] = in_a ? p[(size_t)ra * hd + c] : 0.f;
    G[1] = in_a ? p[(size_t)ra * hd + c + 1] : 0.f;
    G[2] = in_b ? p[(size_t)rb * hd + c] : 0.f;
    G[3] = in_b ? p[(size_t)rb * hd + c + 1] : 0.f;
  }
  auto store_state = [&](const float (&x)[4], float* dst) {
    if (in_a)
      *reinterpret_cast<float2*>(dst + (size_t)ra * hd + c) =
          make_float2(x[0], x[1]);
    if (in_b)
      *reinterpret_cast<float2*>(dst + (size_t)rb * hd + c) =
          make_float2(x[2], x[3]);
  };

  // scan layout: state row ii, segment sg of SEG tokens
  const int ii = tid % TI, sg = tid / TI;

  // the next tile's r (64 tokens x 16 rows: one 4-vector a thread), dy
  // (64 x 64: four) and this thread's SEG values of log w, in registers
  R4 pr;
  float4 py[4];
  float pl[SEG];
  auto prefetch = [&](int t0) {
    const int n = min(TILE, S - t0);
    {
      const int row = tid / 4, col = i0 + 4 * (tid % 4);
      pr = ld4(r + base + (size_t)(t0 + row) * rs + col, row < n && col < hd);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
      py[m] = ld4(dy + base + (size_t)(t0 + row) * rs + col,
                  row < n && col < hd);
    }
#pragma unroll
    for (int e = 0; e < SEG; ++e) {
      const int row = SEG * sg + e;
      pl[e] = row < n && i0 + ii < hd
                  ? lw[base + (size_t)(t0 + row) * rs + i0 + ii] : 0.f;
    }
  };

  prefetch((n_tiles - 1) * TILE);
  for (int j = n_tiles - 1; j >= 0; --j) {
    store_state(G, gscratch + ((size_t)bh * n_tiles + j) * hh);
    __syncthreads();             // the last tile's products are done
    st4(Rt + (tid / 4) * LD1R + 4 * (tid % 4), to_f32x4(pr));
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = tid + NT * m;
      st4(Yt + (q / 16) * LD1Y + 4 * (q % 16), py[m]);
    }
    float l2[SEG], sum = 0.f;
#pragma unroll
    for (int e = 0; e < SEG; ++e) {
      l2[e] = pl[e] * LOG2E;
      sum += l2[e];
    }
    part[sg * TI + ii] = sum;
    __syncthreads();
    if (j > 0) prefetch((j - 1) * TILE);

    // F- (the exclusive prefix sums of log2 w over the tile) and the
    // tile's total; r <- r 2^F- (rows past the sequence are zero)
    {
      float before = 0.f, all = 0.f;
#pragma unroll
      for (int p = 0; p < NSEG; ++p) {
        const float x = part[p * TI + ii];
        if (p < sg) before += x;
        all += x;
      }
      if (sg == 0) tot[ii] = all;
#pragma unroll
      for (int e = 0; e < SEG; ++e) {
        Rt[(SEG * sg + e) * LD1R + ii] *= ex2(before);
        before += l2[e];
      }
    }
    __syncthreads();

    // G <- diag(2^tot) G + (r 2^F-)^T dy on the tensor cores, the k-steps
    // over two accumulators
    float p2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < TILE / 8; ++ks) {
      const float* rr = Rt + (8 * ks + t) * LD1R;
      const float* yr = Yt + (8 * ks + t) * LD1Y + 8 * warp + g;
      mma<SPLIT>(p2[ks % 2],
                 frag_a<SPLIT>(rr[g], rr[g + 8], rr[4 * LD1R + g],
                               rr[4 * LD1R + g + 8]),
                 frag_b<SPLIT>(yr[0], yr[4 * LD1Y]));
    }
    const float da = ex2(tot[g]), db = ex2(tot[g + 8]);
    G[0] = da * G[0] + p2[0][0] + p2[1][0];
    G[1] = da * G[1] + p2[0][1] + p2[1][1];
    G[2] = db * G[2] + p2[0][2] + p2[1][2];
    G[3] = db * G[3] + p2[0][3] + p2[1][3];
  }
  store_state(G, ds0 + (size_t)bh * hh);
}

// ---------------------------------------------------------------------------
// B2: every tile's gradients
// ---------------------------------------------------------------------------

// Shared rows of 64 floats padded to 72: a lane's (row g, columns 2t,
// 2t + 1) float2 reads fall in distinct banks.
constexpr int LD = HD + 8;
constexpr int ARR = TILE * LD;     // floats of one [token][column] array
constexpr int LDM = SUB + 1;       // M's diagonal blocks [t][s]
constexpr int LDA = SUB + 8;       // A'^T's diagonal blocks [t][s]
constexpr int WALK = NT / 2;       // threads of each walk: 4 warps

constexpr int TILES_SMEM_FLOATS = 11 * ARR              // R, K, K~, V, dy,
                                                        // F, w, S, 2 x G, B
                                  + NSUB * SUB * LDM    // M on the diagonal
                                  + NSUB * SUB * LDA    // A'^T likewise
                                  + NSUB * HD           // tot
                                  + NSUB * HD + HD      // c: sub-tile sums,
                                                        // tile end
                                  + TILE + HD;          // bonus, u
constexpr size_t TILES_SMEM = TILES_SMEM_FLOATS * sizeof(float);

// a barrier of the 4 warps of one walk (id 1: forward, 2: backward)
__device__ __forceinline__ void walk_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WALK) : "memory");
}

// c[n] (16 tokens x the 16 columns 16 m .. 16 m + 15, as 2 tiles of 8) =
// A16 (16 token rows, row-major, depth 64) times St^T, St's rows being
// the output columns: the state's rows 16 m .. + 15 as the B operand
template <bool SPLIT>
__device__ __forceinline__ void rows_times_state(const float* A16,
                                                 const float* St, int m,
                                                 int g, int t,
                                                 float (&c)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  const float* a0 = A16 + g * LD + 2 * t;
  const float* bb = St + (16 * m + g) * LD + 2 * t;
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    const float2 x = lds2(a0 + 8 * ks), y = lds2(a0 + 8 * LD + 8 * ks);
    const FragA<SPLIT> fa = frag_a<SPLIT>(x.x, y.x, x.y, y.y);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 z = lds2(bb + 8 * n * LD + 8 * ks);
      mma<SPLIT>(c[n], fa, frag_b<SPLIT>(z.x, z.y));
    }
  }
}

// The walked state's 16 rows 16 m .. + 15 (all 64 columns) from registers
// (C layout) into a shared [row][column] array
__device__ __forceinline__ void store_rows(float* St, int m, int g, int t,
                                           const float (&st)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(St + (16 * m + g) * LD + 8 * n + 2 * t) =
        make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(St + (16 * m + g + 8) * LD + 8 * n + 2 * t) =
        make_float2(st[n][2], st[n][3]);
  }
}

__device__ __forceinline__ void load_rows(const float* St, int m, int g,
                                          int t, float (&st)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 x = lds2(St + (16 * m + g) * LD + 8 * n + 2 * t);
    const float2 y = lds2(St + (16 * m + g + 8) * LD + 8 * n + 2 * t);
    st[n][0] = x.x;
    st[n][1] = x.y;
    st[n][2] = y.x;
    st[n][3] = y.y;
  }
}

// st (rows 16 m .., C layout) <- diag(2^tot) st + A^T B over the 16 tokens
// of a sub-tile: a(s, i) the A operand's value at token s (of 16) and
// state row i, B the 16 token rows of a [token][column] array
template <bool SPLIT, typename FA>
__device__ __forceinline__ void update_rows(float (&st)[8][4],
                                            const float* tot_J, int m,
                                            int g, int t, FA a,
                                            const float* B16) {
  const float ea = ex2(tot_J[16 * m + g]), eb = ex2(tot_J[16 * m + g + 8]);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    st[n][0] *= ea;
    st[n][1] *= ea;
    st[n][2] *= eb;
    st[n][3] *= eb;
  }
#pragma unroll
  for (int ks = 0; ks < SUB / 8; ++ks) {
    const int s = 8 * ks + 2 * t;            // tokens s, s + 1
    const int i = 16 * m + g;                // rows i, i + 8
    const FragA<SPLIT> fa =
        frag_a<SPLIT>(a(s, i), a(s, i + 8), a(s + 1, i), a(s + 1, i + 8));
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* b0 = B16 + s * LD + 8 * n + g;
      mma<SPLIT>(st[n], fa, frag_b<SPLIT>(b0[0], b0[LD]));
    }
  }
}

// Grid (B * H, n_tiles), 8 warps.  After the shared loads and tables,
// warps 0-3 walk the sub-tiles forward (S) and warps 4-7 backward (G), at
// the same time; warp m of a walk owns the state's rows 16 m .. + 15 and
// the 16 columns 16 m .. + 15 of each sub-tile's 16 x 64 outputs.
template <typename T>
__global__ void __launch_bounds__(NT)
wkv6_bwd_tiles_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ lw,
                      const float* __restrict__ u,
                      const float* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ gscratch,
                      T* __restrict__ dr, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ dlw,
                      float* __restrict__ du_part, int S, int H, int hd) {
  constexpr bool SPLIT = sizeof(T) == 4;
  typedef typename Raw4<T>::type R4;
  extern __shared__ __align__(16) float sm[];
  float* Rs = sm;                    // r
  float* Ks = Rs + ARR;              // k
  float* KT = Ks + ARR;              // k~ = k 2^(tot_J - F)
  float* Vs = KT + ARR;              // v
  float* Ys = Vs + ARR;              // dy
  float* Fs = Ys + ARR;              // log w, then F (per sub-tile, log2)
  float* Ws = Fs + ARR;              // w
  float* Ss = Ws + ARR;              // S [i][j], then A = r o a [t][i]
  float* Gs = Ss + ARR;              // G [i][j], 2 stages
  float* Bs = Gs + 2 * ARR;          // B = k o g [t][i]
  float* Md = Bs + ARR;              // [J][t][s] = dy_t . v_s
  float* AdT = Md + NSUB * SUB * LDM;   // [J][t][s] = A'[s][t], s > t
  float* tot = AdT + NSUB * SUB * LDA;  // [J][i]
  float* csub = tot + NSUB * HD;     // [J][i]: sum of A - B over J
  float* cend = csub + NSUB * HD;    // [i]: c at the tile's end
  float* bonus = cend + HD;          // [t]
  float* U = bonus + TILE;           // [i]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tile = blockIdx.y, n_tiles = gridDim.y;
  const size_t rs = (size_t)H * hd;
  const size_t hh = (size_t)hd * hd;
  const int t0 = tile * TILE, n = min(TILE, S - t0);
  const size_t base = (size_t)b * S * rs + (size_t)h * hd;
  const float* st_in = states + ((size_t)bh * n_tiles + tile) * hh;
  const float* g_end = gscratch + ((size_t)bh * n_tiles + tile) * hh;

  // 0. loads (zeros past n and hd) by cp.async, in two groups: log w, dy
  //    and (float32) r, k, v first; the entering state and G at the tile's
  //    end, first read by the walks, second.  bfloat16 r, k, v through
  //    registers.
  {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
      const bool tin = row < n && col < hd;
      const size_t o = base + (size_t)(t0 + row) * rs + col;
      const int at = row * LD + col;
      cp_async16(Fs + at, tin ? lw + o : lw, tin);
      cp_async16(Ys + at, tin ? dy + o : dy, tin);
      if (SPLIT) {
        cp_async16(Rs + at, tin ? reinterpret_cast<const float*>(r + o) : lw,
                   tin);
        cp_async16(Ks + at, tin ? reinterpret_cast<const float*>(k + o) : lw,
                   tin);
        cp_async16(Vs + at, tin ? reinterpret_cast<const float*>(v + o) : lw,
                   tin);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
      const bool sin = row < hd && col < hd;
      const size_t o = (size_t)row * hd + col;
      const int at = row * LD + col;
      cp_async16(Ss + at, sin ? st_in + o : st_in, sin);
      cp_async16(Gs + at, sin ? g_end + o : g_end, sin);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (!SPLIT) {
      R4 xr[4], xk[4], xv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int q = tid + NT * m, row = q / 16, col = 4 * (q % 16);
        const bool tin = row < n && col < hd;
        const size_t o = base + (size_t)(t0 + row) * rs + col;
        xr[m] = ld4(r + o, tin);
        xk[m] = ld4(k + o, tin);
        xv[m] = ld4(v + o, tin);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int q = tid + NT * m, at = (q / 16) * LD + 4 * (q % 16);
        st4(Rs + at, to_f32x4(xr[m]));
        st4(Ks + at, to_f32x4(xk[m]));
        st4(Vs + at, to_f32x4(xv[m]));
      }
    }
    if (tid < HD) U[tid] = tid < hd ? u[(size_t)h * hd + tid] : 0.f;
    for (int e = tid; e < NSUB * SUB * LDA; e += NT) AdT[e] = 0.f;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  __syncthreads();

  // 1. per (column i, sub-tile J): w, F = cumsum of log2 w from the
  //    sub-tile's start, tot_J, k~ = k 2^(tot_J - F); the bonus r . u . k
  //    per token
  {
    const int i = tid % HD, J = tid / HD;
    float F = 0.f;
#pragma unroll
    for (int e = 0; e < SUB; ++e) {
      const int o = (SUB * J + e) * LD + i;
      const float l2 = Fs[o] * LOG2E;
      Ws[o] = ex2(l2);
      F += l2;
      Fs[o] = F;
    }
    tot[J * HD + i] = F;
#pragma unroll
    for (int e = 0; e < SUB; ++e) {
      const int o = (SUB * J + e) * LD + i;
      KT[o] = Ks[o] * ex2(F - Fs[o]);
    }
    const int tok = tid / 4, part = tid % 4;
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i4 = 16 * part + 4 * e;
      const float4 a = lds4(Rs + tok * LD + i4);
      const float4 c = lds4(Ks + tok * LD + i4),
                   w = lds4(U + i4);
      d += a.x * w.x * c.x + a.y * w.y * c.y + a.z * w.z * c.z +
           a.w * w.w * c.w;
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) bonus[tok] = d;
  }
  __syncthreads();

  // 2a. M on the diagonal sub-tiles, Md[J][t][s] = dy_t . v_s, on the
  //     tensor cores: warp w takes sub-tile w / 2, keys 8 (w % 2) .. + 7
  {
    const int J = warp / 2, s0 = SUB * J + 8 * (warp % 2);
    const float* ya = Ys + (SUB * J + g) * LD + 2 * t;
    const float* yb = ya + 8 * LD;
    const float* vb = Vs + (s0 + g) * LD + 2 * t;
    float c2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const float2 a0 = lds2(ya + 8 * ks), a1 = lds2(yb + 8 * ks);
      const float2 bb = lds2(vb + 8 * ks);
      mma<SPLIT>(c2[ks % 2], frag_a<SPLIT>(a0.x, a1.x, a0.y, a1.y),
                 frag_b<SPLIT>(bb.x, bb.y));
    }
    float* m = Md + J * SUB * LDM + 8 * (warp % 2) + 2 * t;
    m[g * LDM] = c2[0][0] + c2[1][0];
    m[g * LDM + 1] = c2[0][1] + c2[1][1];
    m[(g + 8) * LDM] = c2[0][2] + c2[1][2];
    m[(g + 8) * LDM + 1] = c2[0][3] + c2[1][3];
  }
  // 2b. A' on the diagonal sub-tiles: for s > t in sub-tile J,
  //     A'[s][t] = sum_i r_s k_t prod_{t<r<s} w_r, stored transposed.  A
  //     half-warp takes four keys t of one sub-tile (t, 15 - t, 4 + t and
  //     11 - t), a lane 4 of the 64 columns; it walks s upward with each
  //     key's running product of w, and the four keys' sums over the 16
  //     lanes go through interleaved shuffles.
  {
    const int hw = tid / 16, hl = tid % 16, J = hw / 4, q = hw % 4;
    const int r0 = SUB * J;
    const int key[4] = {q, SUB - 1 - q, 4 + q, SUB - 5 - q};
    float4 kk[4], fac[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kk[e] = lds4(Ks + (r0 + key[e]) * LD + 4 * hl);
      fac[e] = make_float4(1.f, 1.f, 1.f, 1.f);
    }
    for (int s = 1; s < SUB; ++s) {
      const float4 rr = lds4(Rs + (r0 + s) * LD + 4 * hl);
      const float4 ww = lds4(Ws + (r0 + s) * LD + 4 * hl);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = rr.x * kk[e].x * fac[e].x + rr.y * kk[e].y * fac[e].y +
               rr.z * kk[e].z * fac[e].z + rr.w * kk[e].w * fac[e].w;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] += __shfl_xor_sync(0xffffffffu, p[e], off, 16);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (s > key[e]) {
          if (hl == 0) AdT[(J * SUB + key[e]) * LDA + s] = p[e];
          fac[e] = make_float4(fac[e].x * ww.x, fac[e].y * ww.y,
                               fac[e].z * ww.z, fac[e].w * ww.w);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (warp < NT / 64) {
    // 3. forward walk, warps 0-3: a for sub-tile I from S at its start,
    //    then S at the next sub-tile's start
    const int m = warp;
    if (tid < HD) {                  // du's terms of the tile, a column each
      float acc = 0.f;
      for (int tt = 0; tt < TILE; ++tt)
        acc += Rs[tt * LD + tid] * Ks[tt * LD + tid] *
               Md[((tt / SUB) * SUB + tt % SUB) * LDM + tt % SUB];
      if (tid < hd) du_part[((size_t)bh * n_tiles + tile) * hd + tid] = acc;
    }
    float st[8][4];
    load_rows(Ss, m, g, t, st);
    float areg[NSUB][2][4];          // A = r o a of this lane's outputs
    // not unrolled: the code of both walks stays in the instruction cache
    for (int I = 0; I < NSUB; ++I) {
      const int r0 = SUB * I;
      const float* mI = Md + I * SUB * LDM;
      float c[2][4];
      rows_times_state<SPLIT>(Ys + r0 * LD, Ss, m, g, t, c);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int oi = 16 * m + 8 * nn + 2 * t;     // columns oi, oi + 1
        // sum_{s < t} Md[t][s] k_s prod_{s < r < t} w_r, s from t - 1 down
        float own[4] = {0.f, 0.f, 0.f, 0.f}, fac[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
        for (int s = SUB - 1; s >= 0; --s) {
          const float2 kk = lds2(Ks + (r0 + s) * LD + oi);
          const float2 ww = lds2(Ws + (r0 + s) * LD + oi);
          const float m0 = mI[g * LDM + s], m1 = mI[(g + 8) * LDM + s];
          // selects, not branches: the loads of every s can be issued
          // ahead of the chain of products
          const float ma = s < g ? m0 : 0.f, mb = s < g + 8 ? m1 : 0.f;
          own[0] += ma * kk.x * fac[0];
          own[1] += ma * kk.y * fac[1];
          own[2] += mb * kk.x * fac[2];
          own[3] += mb * kk.y * fac[3];
          fac[0] = s < g ? fac[0] * ww.x : fac[0];
          fac[1] = s < g ? fac[1] * ww.y : fac[1];
          fac[2] = s < g + 8 ? fac[2] * ww.x : fac[2];
          fac[3] = s < g + 8 ? fac[3] * ww.y : fac[3];
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int tt = g + 8 * hr, row = r0 + tt;
          const float2 fm = tt ? lds2(Fs + (row - 1) * LD + oi)
                               : make_float2(0.f, 0.f);
          const float2 rr = lds2(Rs + row * LD + oi);
          const float2 kk = lds2(Ks + row * LD + oi);
          const float vdy = mI[tt * LDM + tt];
          const float a0 = ex2(fm.x) * c[nn][2 * hr] + own[2 * hr];
          const float a1 = ex2(fm.y) * c[nn][2 * hr + 1] + own[2 * hr + 1];
          areg[I][nn][2 * hr] = rr.x * a0;
          areg[I][nn][2 * hr + 1] = rr.y * a1;
          if (row < n && oi < hd)
            st2(dr + base + (size_t)(t0 + row) * rs + oi,
                a0 + U[oi] * kk.x * vdy, a1 + U[oi + 1] * kk.y * vdy);
        }
      }
      // S <- diag(2^tot_I) S + k~_I^T v_I, this warp's rows; the next
      // sub-tile reads them from shared memory, this warp alone
      update_rows<SPLIT>(
          st, tot + I * HD, m, g, t,
          [&](int s, int i) { return KT[(r0 + s) * LD + i]; },
          Vs + r0 * LD);
      if (I < NSUB - 1) {
        __syncwarp();                // the warp has read its rows of S
        store_rows(Ss, m, g, t, st);
        __syncwarp();
      }
    }
    // c at the tile's end, rowsum(S o G), for this warp's rows: G from B1's
    // scratch (the backward walk overwrites its shared copy)
    {
      float pa = 0.f, pb = 0.f;
      const int ra = 16 * m + g, rb = ra + 8;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const int c = 8 * nn + 2 * t;
        if (c < hd) {
          if (ra < hd) {
            const float2 x =
                *reinterpret_cast<const float2*>(g_end + ra * hd + c);
            pa += st[nn][0] * x.x + st[nn][1] * x.y;
          }
          if (rb < hd) {
            const float2 y =
                *reinterpret_cast<const float2*>(g_end + rb * hd + c);
            pb += st[nn][2] * y.x + st[nn][3] * y.y;
          }
        }
      }
      pa += __shfl_xor_sync(0xffffffffu, pa, 1);
      pa += __shfl_xor_sync(0xffffffffu, pa, 2);
      pb += __shfl_xor_sync(0xffffffffu, pb, 1);
      pb += __shfl_xor_sync(0xffffffffu, pb, 2);
      if (t == 0) {
        cend[ra] = pa;
        cend[rb] = pb;
      }
    }
    // A = r o a into S's place, once every forward warp has read S
    walk_sync(1);
#pragma unroll
    for (int I = 0; I < NSUB; ++I)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int oi = 16 * m + 8 * nn + 2 * t;
        *reinterpret_cast<float2*>(Ss + (SUB * I + g) * LD + oi) =
            make_float2(areg[I][nn][0], areg[I][nn][1]);
        *reinterpret_cast<float2*>(Ss + (SUB * I + g + 8) * LD + oi) =
            make_float2(areg[I][nn][2], areg[I][nn][3]);
      }
  } else {
    // 4. backward walk, warps 4-7: g and dv for sub-tile J from G at its
    //    end, then G at the previous sub-tile's end (into the other stage)
    const int m = warp - NT / 64;
    float st[8][4];
    load_rows(Gs, m, g, t, st);
    for (int J = NSUB - 1; J >= 0; --J) {   // not unrolled, as above
      const int r0 = SUB * J, p = (NSUB - 1 - J) % 2;
      const float* Gc = Gs + p * ARR;
      const float* mJ = Md + J * SUB * LDM;
      float c[2][4];
      rows_times_state<SPLIT>(Vs + r0 * LD, Gc, m, g, t, c);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int oi = 16 * m + 8 * nn + 2 * t;
        // sum_{s > t} Md[s][t] r_s prod_{t < r < s} w_r, s from t + 1 up
        float own[4] = {0.f, 0.f, 0.f, 0.f}, fac[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          const float2 rr = lds2(Rs + (r0 + s) * LD + oi);
          const float2 ww = lds2(Ws + (r0 + s) * LD + oi);
          const float m0 = mJ[s * LDM + g], m1 = mJ[s * LDM + g + 8];
          const float ma = s > g ? m0 : 0.f, mb = s > g + 8 ? m1 : 0.f;
          own[0] += ma * rr.x * fac[0];
          own[1] += ma * rr.y * fac[1];
          own[2] += mb * rr.x * fac[2];
          own[3] += mb * rr.y * fac[3];
          fac[0] = s > g ? fac[0] * ww.x : fac[0];
          fac[1] = s > g ? fac[1] * ww.y : fac[1];
          fac[2] = s > g + 8 ? fac[2] * ww.x : fac[2];
          fac[3] = s > g + 8 ? fac[3] * ww.y : fac[3];
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int tt = g + 8 * hr, row = r0 + tt;
          const float2 f = lds2(Fs + row * LD + oi);
          const float2 tj = lds2(tot + J * HD + oi);
          const float2 rr = lds2(Rs + row * LD + oi);
          const float2 kk = lds2(Ks + row * LD + oi);
          const float vdy = mJ[tt * LDM + tt];
          const float g0 = ex2(tj.x - f.x) * c[nn][2 * hr] + own[2 * hr];
          const float g1 = ex2(tj.y - f.y) * c[nn][2 * hr + 1] +
                           own[2 * hr + 1];
          *reinterpret_cast<float2*>(Bs + row * LD + oi) =
              make_float2(kk.x * g0, kk.y * g1);
          if (row < n && oi < hd)
            st2(dk + base + (size_t)(t0 + row) * rs + oi,
                g0 + U[oi] * rr.x * vdy, g1 + U[oi + 1] * rr.y * vdy);
        }
      }
      // dv = k~ G + A'^T dy + bonus dy for this warp's 16 columns
      {
        float c2[2][4] = {};
        const float* a0 = KT + (r0 + g) * LD + 2 * t;
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {
          const float2 x = lds2(a0 + 8 * ks), y = lds2(a0 + 8 * LD + 8 * ks);
          const FragA<SPLIT> fa = frag_a<SPLIT>(x.x, y.x, x.y, y.y);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const float* bg =
                Gc + (8 * ks + 2 * t) * LD + 16 * m + 8 * nn + g;
            mma<SPLIT>(c2[nn], fa, frag_b<SPLIT>(bg[0], bg[LD]));
          }
        }
        const float* ad = AdT + J * SUB * LDA + g * LDA + 2 * t;
#pragma unroll
        for (int ks = 0; ks < SUB / 8; ++ks) {
          const float2 x = lds2(ad + 8 * ks);
          const float2 y = lds2(ad + 8 * LDA + 8 * ks);
          const FragA<SPLIT> fa = frag_a<SPLIT>(x.x, y.x, x.y, y.y);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const float* by =
                Ys + (r0 + 8 * ks + 2 * t) * LD + 16 * m + 8 * nn + g;
            mma<SPLIT>(c2[nn], fa, frag_b<SPLIT>(by[0], by[LD]));
          }
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int oi = 16 * m + 8 * nn + 2 * t;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = r0 + g + 8 * hr;
            const float2 yy = lds2(Ys + row * LD + oi);
            const float bn = bonus[row];
            if (row < n && oi < hd)
              st2(dv + base + (size_t)(t0 + row) * rs + oi,
                  c2[nn][2 * hr] + bn * yy.x,
                  c2[nn][2 * hr + 1] + bn * yy.y);
          }
        }
      }
      // G at the previous sub-tile's end: diag(2^tot_J) G + (r 2^F-)^T dy,
      // this warp's rows, into the other stage
      if (J > 0) {
        update_rows<SPLIT>(
            st, tot + J * HD, m, g, t,
            [&](int s, int i) {
              const float fm = s ? Fs[(r0 + s - 1) * LD + i] : 0.f;
              return Rs[(r0 + s) * LD + i] * ex2(fm);
            },
            Ys + r0 * LD);
        store_rows(Gs + (1 - p) * ARR, m, g, t, st);
        walk_sync(2);                // G of J - 1 is whole
      }
    }
  }
  __syncthreads();

  // 5. dlogw_t = c_t - B_t from the tile's end down, c_{t-1} = c_t + A_t
  //    - B_t: per (column i, sub-tile J) its sum of A - B, then its c at
  //    its end from the later sub-tiles' sums, then its tokens
  {
    const int i = tid % HD, J = tid / HD, r0 = SUB * J;
    float sum = 0.f;
#pragma unroll
    for (int tt = 0; tt < SUB; ++tt)
      sum += Ss[(r0 + tt) * LD + i] - Bs[(r0 + tt) * LD + i];
    csub[J * HD + i] = sum;
    __syncthreads();
    float cc = cend[i];
    for (int J2 = NSUB - 1; J2 > J; --J2) cc += csub[J2 * HD + i];
#pragma unroll
    for (int tt = SUB - 1; tt >= 0; --tt) {
      const int row = r0 + tt;
      const float bt = Bs[row * LD + i];
      if (row < n && i < hd)
        dlw[base + (size_t)(t0 + row) * rs + i] = cc - bt;
      cc += Ss[row * LD + i] - bt;
    }
  }
}

// ---------------------------------------------------------------------------
// B3: du
// ---------------------------------------------------------------------------

// Grid H blocks of HD threads: du[h, i] = the sum over the batch and the
// tiles of B2's terms, in one fixed order.
__global__ void __launch_bounds__(HD)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                   int B, int H, int n_tiles, int hd) {
  const int h = blockIdx.x, i = threadIdx.x;
  if (i >= hd) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int j = 0; j < n_tiles; ++j)
      acc += du_part[(((size_t)b * H + h) * n_tiles + j) * hd + i];
  du[(size_t)h * hd + i] = acc;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t allow_smem() {           // once per entry: above 48 KB
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_states_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STATES_SMEM);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        wkv6_bwd_tiles_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILES_SMEM);
  }();
  return err;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* dy, const void* dsT,
           const void* states, void* dr, void* dk, void* dv, void* dlw,
           void* du, void* ds0, void* gscratch, void* du_part, int B, int S,
           int H, int hd, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 4 || hd > HD || hd % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (S + TILE - 1) / TILE;
  wkv6_bwd_states_kernel<T><<<dim3(B * H, (hd + TI - 1) / TI), NT,
                              STATES_SMEM, st>>>(
      (const T*)r, (const float*)lw, (const float*)dy, (const float*)dsT,
      (float*)gscratch, (float*)ds0, S, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_tiles_kernel<T><<<dim3(B * H, n_tiles), NT, TILES_SMEM, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)dy, (const float*)states,
      (const float*)gscratch, (T*)dr, (T*)dk, (T*)dv, (float*)dlw,
      (float*)du_part, S, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_du_kernel<<<H, HD, 0, st>>>((const float*)du_part, (float*)du, B,
                                       H, n_tiles, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int pass) {
  int n = 0;
  cudaError_t err = allow_smem<T>();
  if (err == cudaSuccess)
    err = pass == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, wkv6_bwd_states_kernel<T>, NT, STATES_SMEM)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, wkv6_bwd_tiles_kernel<T>, NT, TILES_SMEM);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// r, k, v, dr, dk, dv: (B, S, H, hd) in the entry's type; lw, dy, dlw:
// (B, S, H, hd) float32; u, du: (H, hd); dsT, ds0: (B, H, hd, hd);
// states: (B * H, ceil(S / 64), hd, hd), the state entering each 64-token
// tile (K3's pass-1 scratch); gscratch: the same shape, B1's G at each
// tile's end; du_part: (B * H, ceil(S / 64), hd).  All float32 unless
// said, contiguous and 16-byte aligned; hd a multiple of 4, at most 64.
int wkv6_bwd_f32(const void* r, const void* k, const void* v, const void* lw,
                 const void* u, const void* dy, const void* dsT,
                 const void* states, void* dr, void* dk, void* dv, void* dlw,
                 void* du, void* ds0, void* gscratch, void* du_part, int B,
                 int S, int H, int hd, void* stream) {
  return launch<float>(r, k, v, lw, u, dy, dsT, states, dr, dk, dv, dlw, du,
                       ds0, gscratch, du_part, B, S, H, hd, stream);
}

int wkv6_bwd_bf16(const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* dy,
                  const void* dsT, const void* states, void* dr, void* dk,
                  void* dv, void* dlw, void* du, void* ds0, void* gscratch,
                  void* du_part, int B, int S, int H, int hd, void* stream) {
  return launch<bf16>(r, k, v, lw, u, dy, dsT, states, dr, dk, dv, dlw, du,
                      ds0, gscratch, du_part, B, S, H, hd, stream);
}

// Resident blocks per SM of B1 (pass 1) or B2 (pass 2) of the bfloat16
// (bf16_entry != 0) or float32 entry, from the occupancy calculator;
// -(CUDA error) on failure.
int wkv6_bwd_blocks_per_sm(int pass, int bf16_entry) {
  return bf16_entry ? blocks_per_sm<bf16>(pass) : blocks_per_sm<float>(pass);
}

}  // extern "C"
