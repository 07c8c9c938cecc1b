// K1: the masked min-plus / min-max layered DP sweep of Algorithm 1, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/minplus/kernel.py
// (_sweep_kernel; entry sweep_minplus).  Plain versions:
// src/repro_torch/kernels/minplus/ref.py (sweep_plain, and
// sweep_cluster_plain for the cluster route's decomposition).
//
// For each threshold t it folds away every edge with beta > t, then runs
// K-1 two-stage layers, both min-reductions:
//   A[i][m]     = min_n dist[n][i] (+) Vc[n][i][m]      (communication hop)
//   dist'[m][j] = min_i A[i][m]    (+) Vs[i][m][j]      (segment extension)
// where (+) is + in "sum" mode and max in "max" mode, and writes the best
// terminal value min(dist[0][I], min over layers of dist[1:][I]).
//
// Two routes, one source; the wrapper (kernel.py::launch_plan) picks the
// route from the shape (S thresholds, N nodes, I + 1 cuts, dtype):
//
// * Cluster route (a few thresholds: every launch the planner makes).
//   Bound: latency -- the load of the graph, then K - 1 dependent layers of
//   two dependent reductions each.  The parent design ran one block per
//   threshold (at S = 1 one SM) and re-read the graph from L2 in every
//   layer, a chain of N dependent-ish L2 loads per output.  Here a
//   thread-block cluster of C blocks works on one threshold.  Block r owns
//   the destination nodes M_r = [r N / C, (r + 1) N / C) and keeps
//   Vc[:, :, M_r] and Vs[:, M_r, :] in its shared memory, masked once as
//   they are loaded (eight loads a thread in flight), for all layers.  Four
//   lanes share one output's reduction and a shuffle-min ends it, so a layer
//   is a few shared-memory loads a lane; every output has its lanes in one
//   pass.  Stage 1 needs all of dist, stage 2 only the block's own
//   A[:, M_r].  Each layer ends with every lane storing its new dist value
//   into every block's next dist buffer with st.async, whose bytes complete
//   that block's mbarrier; a block starts the next layer when its mbarrier
//   has counted the whole dist.  So no cluster barrier runs per layer (the
//   cooperative-groups cluster.sync() costs a GPU-scope fence and an L1
//   invalidation each time).  dist is double-buffered: a block writes
//   buffer b again only two layers later, after it has received the rows of
//   the layer in between from every block, which each sends only after it
//   has read b.  The early exit is decided from dist itself, which every
//   block reads whole in stage 1 and holds identically, so all blocks stop
//   after the same layer.  The best terminal value is reduced into rank 0
//   the same way.  C = 1 (the quickstart) stores locally and ends a layer
//   with a block barrier.
//
// * Tiled route (many thresholds: the all-thresholds sweeps).  Bound: L2
//   reads (every block reads the whole graph once a layer) and the
//   instruction throughput of the float64 compare-selects.  One block takes a tile of T thresholds
//   (dist and A for all T in shared memory, threshold-innermost) and applies
//   every (V, beta) pair it loads to all T of them in registers, so L2
//   traffic falls by T.  In max mode the mask costs one compare per output
//   instead of one per candidate (relax, unmask).  It takes any graph whose
//   dist and A fit one block at T = 1, as the parent design did.
//
// Graph axis (both routes): the six graph tensors may carry a leading axis
// of G graphs, and `graph` (int32, nullable) names the graph of every
// threshold slot; a slot's graph is read at the graph's own element counts
// (N (I + 1) N for Cc/Bc, (I + 1) N (I + 1) for Ss/Bs, I + 1 for sc/sb).
// A cluster offsets its base pointers by graph[s]; a tiled block by the
// graph of its first slot, since the wrapper pads each graph's thresholds
// to whole tiles with -inf (kernel.py::tile_slots), under which no edge
// passes and the sweep stops after its first layer.  So b-sweeps of many
// graphs (Planner.solve_many) take one launch and copy no graph.
//
// Exactness: every operation is +, max, min or a compare -- no sum over
// many terms and no multiply, so no FMA contraction can apply, and no
// fmin/fmax NaN rule is relied on -- so the float64 instantiation is
// bit-equal to the plain version in any reduction order.  The planner calls
// it in float64.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (src/repro_torch/kernels/_build.py); each entry point returns
// cudaGetLastError() after the launch, or a CUDA error code (or -1: no
// cluster of that size can be resident) when the launch is refused.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kParts = 4;                  // lanes sharing one reduction
constexpr int kOutsPerWarp = 32 / kParts;  // outputs a warp works on at once
constexpr size_t kMaxSmem = 232448;        // dynamic shared memory per block
constexpr int kClusterThreads = 1024;
constexpr int kTiledThreads = 512;

template <typename V> __device__ __forceinline__ V inf_value();
template <> __device__ __forceinline__ double inf_value<double>() {
  return CUDART_INF;
}
template <> __device__ __forceinline__ float inf_value<float>() {
  return CUDART_INF_F;
}

template <typename V, bool SUM>
__device__ __forceinline__ V combine(V a, V b) {
  if (SUM) return a + b;
  return a > b ? a : b;
}

template <typename V>
__device__ __forceinline__ V vmin(V acc, V c) {
  return c < acc ? c : acc;
}

// Row stride (in elements) of a block's graph slice: rounded up to 8 modulo
// 128 bytes' worth of elements, so the four lane groups of a warp, each
// reading 8 neighbouring elements of another row, hit disjoint banks.
__host__ __device__ inline int pad_stride(int x, int esize) {
  const int p = 128 / esize;
  return x + (((8 - x) % p) + p) % p;
}

// x / d for x d < 2^32 by one multiply-high: the shared-memory fill divides
// every element's index, and the GPU has no integer division instruction
// (a division is ~20 dependent instructions)
struct FastDiv {
  unsigned m, d;
  __device__ explicit FastDiv(int divisor)
      : m(divisor > 1 ? 0xffffffffu / divisor + 1 : 0), d(divisor) {}
  __device__ int operator()(int x) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(x), m))
                 : x;
  }
};

// Element offsets of slot `slot`'s graph in stacked (G, ...) inputs: the
// comm tensors, the segment tensors and the source vectors (all 0 for one
// graph, graph == null).
struct GraphOffsets {
  size_t com, seg, src;
};
__device__ __forceinline__ GraphOffsets graph_offsets(const int* graph,
                                                      int slot, int N,
                                                      int I1) {
  const size_t g = graph != nullptr ? __ldg(graph + slot) : 0;
  return {g * N * I1 * N, g * I1 * N * I1, g * I1};
}

__host__ __device__ inline int cluster_span(int N, int C) {
  return (N + C - 1) / C;
}

// Shared memory of the cluster route, in this order: dist[2][N][I1],
// bests[16], wbest[32] (identical offsets in every block: dist and bests are
// written remotely), three mbarriers (32 bytes), A[I1][M], Vc[N][pad(I1 M)],
// Vs[I1][pad(I1 M)], M = ceil(N / C).
__host__ __device__ inline size_t cluster_smem_bytes(int N, int I1, int C,
                                                     int esize) {
  const size_t M = cluster_span(N, C);
  const size_t row = pad_stride(static_cast<int>(I1 * M), esize);
  const size_t v = 2 * static_cast<size_t>(N) * I1 + kMaxCluster + 32 +
                   I1 * M + (N + I1) * row;
  return v * esize + 32;
}

inline int cluster_threads(int N, int I1, int C) {
  const int want = I1 * cluster_span(N, C) * kParts;
  const int t = (want + 31) / 32 * 32;
  return t < 128 ? 128 : (t > kClusterThreads ? kClusterThreads : t);
}

inline size_t tiled_smem_bytes(int N, int I1, int T, int esize) {
  return 2 * static_cast<size_t>(N) * I1 * T * esize;
}

inline int tiled_threads(int N, int I1) {
  const int t = (N * I1 + 31) / 32 * 32;
  return t > kTiledThreads ? kTiledThreads : t;
}

// ---------------------------------------------------------------- cluster --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared-memory location in block `rank`
__device__ __forceinline__ unsigned remote_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// store v into another block's shared memory; its mbarrier counts the bytes
__device__ __forceinline__ void store_remote(unsigned addr, double v,
                                             unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, "
      "[%2];" :: "r"(addr), "d"(v), "r"(mbar) : "memory");
}
__device__ __forceinline__ void store_remote(unsigned addr, float v,
                                             unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" :: "r"(addr), "f"(v), "r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(mbar)
               : "memory");
}

// one arrival that also expects `bytes` of remote stores in this phase
__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta"
        ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
}

// The cluster route.  CLUSTER is false for C = 1: the new dist rows are
// plain stores and a block barrier ends each layer.  With C > 1 each layer
// ends with every lane storing its outputs into every block's next dist
// buffer with st.async, whose bytes complete that block's mbarrier for the
// buffer; a block starts the next layer when its mbarrier has counted all
// N (I + 1) values.  No cluster barrier runs per layer: a block can write
// buffer b again only two layers later, after it has received this block's
// rows of the layer in between, which this block sends only after it has
// read b.  The early exit is decided from dist itself, which every block
// reads whole in stage 1 and holds identically, so every block stops after
// the same layer.
template <typename V, bool SUM, bool CLUSTER>
__global__ void __launch_bounds__(kClusterThreads, 1)
sweep_cluster_kernel(const V* __restrict__ ts,
                     const V* __restrict__ Cc,   // [n][i][m]
                     const V* __restrict__ Bc,
                     const V* __restrict__ Ss,   // [i][m][j]
                     const V* __restrict__ Bs,
                     const V* __restrict__ sc,   // [i]
                     const V* __restrict__ sb,
                     const int* __restrict__ graph,  // [S] or null
                     V* __restrict__ out, int N, int I1, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = CLUSTER ? static_cast<int>(cg::this_cluster().num_blocks())
                        : 1;
  const int rank = CLUSTER
      ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int s = blockIdx.x / C;
  const GraphOffsets go = graph_offsets(graph, s, N, I1);
  Cc += go.com;
  Bc += go.com;
  Ss += go.seg;
  Bs += go.seg;
  sc += go.src;
  sb += go.src;
  const int NI = N * I1, I = I1 - 1;
  const int m0 = rank * N / C;
  const int M = (rank + 1) * N / C - m0;     // this block's destinations
  const int Mmax = cluster_span(N, C);
  const int IM = I1 * M;                     // outputs of either stage
  const int rs = pad_stride(IM, sizeof(V));  // row stride of both slices

  V* dist = reinterpret_cast<V*>(smem_raw);              // [2][N][I1]
  V* bests = dist + 2 * NI;                              // [C] (rank 0's)
  V* wbest = bests + kMaxCluster;                        // [warps]
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(wbest + 32);  // [3]
  V* A = reinterpret_cast<V*>(mbar + 4);                 // [I1][M]
  V* VcL = A + I1 * Mmax;                                // [N][rs]
  V* VsL = VcL + static_cast<size_t>(N) * pad_stride(I1 * Mmax, sizeof(V));

  const V INF = inf_value<V>();
  const V* Vc = SUM ? Cc : Bc;
  const V* Vs = SUM ? Ss : Bs;
  const V* src = SUM ? sc : sb;
  const unsigned bytes = static_cast<unsigned>(NI * sizeof(V));
  // every load that does not depend on another goes out first: the
  // threshold, the source row of dist (thread i < I1 holds column i) and the
  // client-only path (thread 0)
  const V t = ts[s];
  const bool src_lane = threadIdx.x < I1;
  const V src_b = src_lane ? __ldg(sb + threadIdx.x) : INF;
  const V src_v = src_lane ? __ldg(src + threadIdx.x) : INF;
  const V end_b = __ldg(sb + I), end_v = __ldg(src + I);

  // this lane's output of either stage, fixed for all layers: one output
  // per group of kParts lanes (the wrapper gives every output a group)
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane / kOutsPerWarp;
  const int o = warp * kOutsPerWarp + lane % kOutsPerWarp;
  const bool valid = o < IM;
  const int i1 = valid ? o / M : 0;          // stage 1: A[i1][o % M]
  const int ml2 = valid ? o / I1 : 0;        // stage 2: dist'[m0 + ml2][j2]
  const int j2 = o - ml2 * I1;
  const int row2 = (m0 + ml2) * I1 + j2;
  const bool terminal = valid && part == 0 && j2 == I && m0 + ml2 >= 1;
  const V* v1 = VcL + o;                     // Vc[n][i1][ml] at v1[n rs]
  const V* v2 = VsL + o;                     // Vs[i][ml2][j2] at v2[i rs]
  const V* a2 = A + ml2;                     // A[i][ml2] at a2[i M]

  if (CLUSTER) {
    if (threadIdx.x == 0) {
      for (int q = 0; q < 3; ++q) mbar_init(smem_addr(mbar + q));
      if (2 < K) mbar_expect(smem_addr(mbar + 1), bytes);    // layer 2's rows
      if (3 < K) mbar_expect(smem_addr(mbar + 0), bytes);    // layer 3's rows
      if (rank == 0) mbar_expect(smem_addr(mbar + 2),
                                 static_cast<unsigned>((C - 1) * sizeof(V)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every block's mbarriers exist before anyone stores into it; the wait
    // comes after the slices are loaded
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  // fold the threshold's mask into this block's slices, once: both slices
  // as one index range (Vc's N I1 M elements, then Vs's I1 M I1), eight
  // elements a thread in flight
  constexpr int U = 8;
  const int nc = N * IM, total = nc + I1 * IM;
  const FastDiv by_m(M), by_im(IM);
  const int vs_at = static_cast<int>(VsL - VcL);
  for (int x0 = threadIdx.x; x0 < total; x0 += U * blockDim.x) {
    V b[U], v[U];
    int dst[U];                               // offsets from VcL
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = x0 + u * blockDim.x;
      const int y = x < nc ? x : x - nc;
      const int q = by_im(y);                 // n (Vc) or i (Vs)
      dst[u] = (x < nc ? 0 : vs_at) + y + q * (rs - IM);
      size_t e;
      if (x < nc) {                           // x = n IM + i M + ml
        const int row = by_m(x);              // n I1 + i
        e = static_cast<size_t>(row) * N + m0 + (x - row * M);
      } else {                                // y = i IM + ml I1 + j
        e = (static_cast<size_t>(q) * N + m0) * I1 + (y - q * IM);
      }
      if (x < nc) {
        b[u] = __ldg(Bc + e);
        v[u] = SUM ? __ldg(Vc + e) : b[u];
      } else if (x < total) {
        b[u] = __ldg(Bs + e);
        v[u] = SUM ? __ldg(Vs + e) : b[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (x0 + u * blockDim.x < total) VcL[dst[u]] = (b[u] <= t) ? v[u] : INF;
  }
  for (int x = threadIdx.x; x < NI; x += blockDim.x) dist[x] = INF;
  if (src_lane && src_b <= t) dist[threadIdx.x] = src_v;   // dist[0][i]
  if (CLUSTER) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  __syncthreads();

  V tbest = INF;        // best dist[m >= 1][I] among this lane's outputs
  int cur = 0;
  unsigned phase = 0;   // parity bits of mbar[0], mbar[1]
  for (int k = 2; k <= K; ++k) {
    if (CLUSTER && k > 2) {
      mbar_wait(smem_addr(mbar + cur), (phase >> cur) & 1);
      phase ^= 1u << cur;
      // re-arm for layer k + 1's rows, which no block sends before it has
      // this block's rows of layer k
      if (threadIdx.x == 0 && k + 1 < K) mbar_expect(smem_addr(mbar + cur),
                                                     bytes);
    }
    // stage 1: communication hop (n, i) -> m across cut i, own m only
    const V* d1 = dist + cur * NI + i1;      // dist[n][i1] at d1[n I1]
    V acc = INF, acc2 = INF;                 // two chains of minima
    int any = 0;
    if (valid) {
      int n = part;
      for (; n + kParts < N; n += 2 * kParts) {
        const V d = d1[n * I1], e = d1[(n + kParts) * I1];
        any |= (d < INF) | (e < INF);
        acc = vmin(acc, combine<V, SUM>(d, v1[n * rs]));
        acc2 = vmin(acc2, combine<V, SUM>(e, v1[(n + kParts) * rs]));
      }
      if (n < N) {
        const V d = d1[n * I1];
        any |= d < INF;
        acc = vmin(acc, combine<V, SUM>(d, v1[n * rs]));
      }
    }
    acc = vmin(acc, acc2);
    acc = vmin(acc, __shfl_xor_sync(full, acc, kOutsPerWarp));
    acc = vmin(acc, __shfl_xor_sync(full, acc, 2 * kOutsPerWarp));
    if (valid && part == 0) A[o] = acc;
    // the vote: stage 1 read every entry of dist, which all blocks hold
    // alike; once no state is reachable every later layer is all-inf, so
    // stop (the numpy reference's break; it does not change the result)
    if (!__syncthreads_or(any)) break;
    // stage 2: extend with segment (i, j] on node m
    acc = INF;
    acc2 = INF;
    if (valid) {
      int i = part;
      for (; i + kParts < I1; i += 2 * kParts) {
        acc = vmin(acc, combine<V, SUM>(a2[i * M], v2[i * rs]));
        acc2 = vmin(acc2, combine<V, SUM>(a2[(i + kParts) * M],
                                          v2[(i + kParts) * rs]));
      }
      if (i < I1) acc = vmin(acc, combine<V, SUM>(a2[i * M], v2[i * rs]));
    }
    acc = vmin(acc, acc2);
    acc = vmin(acc, __shfl_xor_sync(full, acc, kOutsPerWarp));
    acc = vmin(acc, __shfl_xor_sync(full, acc, 2 * kOutsPerWarp));
    if (terminal) tbest = vmin(tbest, acc);
    if (k == K) break;
    if (CLUSTER) {
      if (valid) {
        const unsigned dst = smem_addr(dist + (1 - cur) * NI + row2);
        const unsigned mb = smem_addr(mbar + (1 - cur));
        for (int r = part; r < C; r += kParts)
          store_remote(remote_addr(dst, r), acc, remote_addr(mb, r));
      }
    } else {
      if (valid && part == 0) dist[(1 - cur) * NI + row2] = acc;
      __syncthreads();
    }
    cur = 1 - cur;
  }

  // the best terminal value: lanes -> warps -> block -> rank 0
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tbest = vmin(tbest, __shfl_xor_sync(full, tbest, off));
  if (lane == 0) wbest[warp] = tbest;
  __syncthreads();
  if (warp == 0) {
    V b = lane < nwarps ? wbest[lane] : INF;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      b = vmin(b, __shfl_xor_sync(full, b, off));
    if (end_b <= t) b = vmin(b, end_v);                // client-only path
    if (lane == 0 && rank == 0) {
      if (CLUSTER && C > 1) {
        mbar_wait(smem_addr(mbar + 2), 0);
        for (int r = 1; r < C; ++r) b = vmin(b, bests[r]);
      }
      out[s] = b;
    } else if (lane == 0 && CLUSTER) {
      store_remote(remote_addr(smem_addr(bests + rank), 0), b,
                   remote_addr(smem_addr(mbar + 2), 0));
    }
  }
  // no block leaves while another may still store into its shared memory
  if (CLUSTER) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
}

// ------------------------------------------------------------------ tiled --

template <int T>
__device__ __forceinline__ void load_tile(const double* p, double (&d)[T]) {
  if constexpr (T % 2 == 0) {
#pragma unroll
    for (int q = 0; q < T / 2; ++q) {
      const double2 w = reinterpret_cast<const double2*>(p)[q];
      d[2 * q] = w.x;
      d[2 * q + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < T; ++q) d[q] = p[q];
  }
}

template <int T>
__device__ __forceinline__ void load_tile(const float* p, float (&d)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      d[4 * q] = w.x;
      d[4 * q + 1] = w.y;
      d[4 * q + 2] = w.z;
      d[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < T; ++q) d[q] = p[q];
  }
}

// One candidate of the tiled route: acc = min(acc, d (+) v) over the edges
// with beta b <= t.  In "sum" mode the mask is a compare per threshold.  In
// "max" mode v is b, and every finite d is <= t (it is the bottleneck of a
// path of edges with beta <= t), so max(d, b) <= t exactly when b <= t:
// the minimum over all edges is the masked one whenever it is <= t, and
// otherwise no masked edge gave a finite value.  So max mode takes the
// minimum unmasked and masks it once per output (unmask).
template <typename V, bool SUM>
__device__ __forceinline__ void relax(V& acc, V d, V v, V b, V t) {
  const V c = combine<V, SUM>(d, v);
  if (SUM)
    acc = (b <= t && c < acc) ? c : acc;
  else
    acc = c < acc ? c : acc;
}

template <typename V, bool SUM>
__device__ __forceinline__ V unmask(V acc, V t) {
  if (SUM) return acc;
  return acc <= t ? acc : inf_value<V>();
}

template <typename V, bool SUM, int T>
__global__ void __launch_bounds__(kTiledThreads, 1)
sweep_tiled_kernel(const V* __restrict__ ts,
                   const V* __restrict__ Cc,   // [n][i][m]
                   const V* __restrict__ Bc,
                   const V* __restrict__ Ss,   // [i][m][j]
                   const V* __restrict__ Bs,
                   const V* __restrict__ sc,   // [i]
                   const V* __restrict__ sb,
                   const int* __restrict__ graph,  // [S] or null
                   V* __restrict__ out, int S, int N, int I1, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NI = N * I1, I = I1 - 1;
  V* dist = reinterpret_cast<V*>(smem_raw);  // [n][i][T]
  V* A = dist + static_cast<size_t>(NI) * T; // [i][m][T]

  const V INF = inf_value<V>();
  const int s0 = blockIdx.x * T;
  // the block's T slots share one graph (the wrapper pads to whole tiles)
  const GraphOffsets go = graph_offsets(graph, s0, N, I1);
  Cc += go.com;
  Bc += go.com;
  Ss += go.seg;
  Bs += go.seg;
  sc += go.src;
  sb += go.src;
  const V* Vc = SUM ? Cc : Bc;
  const V* Vs = SUM ? Ss : Bs;
  const V* src = SUM ? sc : sb;
  V t[T];
#pragma unroll
  for (int q = 0; q < T; ++q) t[q] = s0 + q < S ? ts[s0 + q] : -INF;

  for (int x = threadIdx.x; x < NI; x += blockDim.x) {
    const int n = x / I1, i = x - n * I1;
#pragma unroll
    for (int q = 0; q < T; ++q)
      dist[x * T + q] = (n == 0 && sb[i] <= t[q]) ? src[i] : INF;
  }
  V tbest[T];
#pragma unroll
  for (int q = 0; q < T; ++q) tbest[q] = INF;
  __syncthreads();

  for (int k = 2; k <= K; ++k) {
    // stage 1: each (Vc, Bc) pair read once from L2 serves all T thresholds
    for (int x = threadIdx.x; x < NI; x += blockDim.x) {   // x = i N + m
      const V* d = dist + (x / N) * T;       // dist[n][i][:] at d + n I1 T
      V acc[T];
#pragma unroll
      for (int q = 0; q < T; ++q) acc[q] = INF;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const size_t e = static_cast<size_t>(n) * NI + x;
        const V b = __ldg(Bc + e);
        const V v = SUM ? __ldg(Vc + e) : b;
        V dv[T];
        load_tile(d + static_cast<size_t>(n) * I1 * T, dv);
#pragma unroll
        for (int q = 0; q < T; ++q) relax<V, SUM>(acc[q], dv[q], v, b, t[q]);
      }
#pragma unroll
      for (int q = 0; q < T; ++q) A[x * T + q] = unmask<V, SUM>(acc[q], t[q]);
    }
    __syncthreads();
    // stage 2: dist is free to overwrite, every thread has passed stage 1
    int any = 0;
    for (int x = threadIdx.x; x < NI; x += blockDim.x) {   // x = m I1 + j
      const int m = x / I1, j = x - m * I1;
      const V* a = A + m * T;                // A[i][m][:] at a + i N T
      V acc[T];
#pragma unroll
      for (int q = 0; q < T; ++q) acc[q] = INF;
#pragma unroll 4
      for (int i = 0; i < I1; ++i) {
        const size_t e = static_cast<size_t>(i) * NI + x;
        const V b = __ldg(Bs + e);
        const V v = SUM ? __ldg(Vs + e) : b;
        V av[T];
        load_tile(a + static_cast<size_t>(i) * N * T, av);
#pragma unroll
        for (int q = 0; q < T; ++q) relax<V, SUM>(acc[q], av[q], v, b, t[q]);
      }
#pragma unroll
      for (int q = 0; q < T; ++q) {
        acc[q] = unmask<V, SUM>(acc[q], t[q]);
        dist[x * T + q] = acc[q];
        any |= acc[q] < INF;
        if (j == I && m >= 1) tbest[q] = vmin(tbest[q], acc[q]);
      }
    }
    // the next stage 1 writes A, which stage 2 is done reading, and reads
    // dist, which every thread has written: one barrier, which also votes
    if (!__syncthreads_or(any)) break;
  }

  // per threshold: lanes -> warps (scratch over dist, which is dead) -> out
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  V* red = dist;                               // [warps][T]; warps <= N I1
#pragma unroll
  for (int q = 0; q < T; ++q) {
    V b = tbest[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      b = vmin(b, __shfl_xor_sync(full, b, off));
    if (lane == 0) red[warp * T + q] = b;
  }
  __syncthreads();
  if (threadIdx.x < T && s0 + threadIdx.x < S) {
    const V tq = ts[s0 + threadIdx.x];
    V b = (sb[I] <= tq) ? src[I] : INF;      // client-only path (k = 1)
    for (int w = 0; w < nwarps; ++w) b = vmin(b, red[w * T + threadIdx.x]);
    out[s0 + threadIdx.x] = b;
  }
}

// ------------------------------------------------------------------ host --

struct ClusterCheck {
  const void* fn;
  int C, threads;
  size_t smem;
  int clusters;
};

// cudaOccupancyMaxActiveClusters per (kernel, C, threads, smem), once
ClusterCheck g_checked[64];
int g_num_checked = 0;

struct Allowed {
  const void* fn;
  int device;
};
Allowed g_allowed[64];
int g_num_allowed = 0;

// Lets `kernel` take all of a block's dynamic shared memory (and, for a
// cluster kernel, clusters of more than 8 blocks), once per kernel and
// device: each launch then asks for what it needs with no driver call.
cudaError_t allow_kernel(const void* kernel, bool cluster) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (int q = 0; q < g_num_allowed; ++q)
    if (g_allowed[q].fn == kernel && g_allowed[q].device == device)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && g_num_allowed < 64)
    g_allowed[g_num_allowed++] = {kernel, device};
  return err;
}

template <typename V, bool SUM>
int launch_cluster(const V* ts, const V* Cc, const V* Bc, const V* Ss,
                   const V* Bs, const V* sc, const V* sb, const int* graph,
                   V* out, int S, int N, int I1, int K, int C,
                   cudaStream_t stream) {
  // every output needs its group of lanes, and every block destinations
  if (C < 1 || C > kMaxCluster || C > N ||
      I1 * cluster_span(N, C) * kParts > kClusterThreads)
    return cudaErrorInvalidValue;
  const size_t smem = cluster_smem_bytes(N, I1, C, sizeof(V));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int threads = cluster_threads(N, I1, C);
  if (C == 1) {
    auto kernel = sweep_cluster_kernel<V, SUM, false>;
    cudaError_t err = allow_kernel(reinterpret_cast<const void*>(kernel),
                                   false);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<S, threads, smem, stream>>>(ts, Cc, Bc, Ss, Bs, sc, sb, graph,
                                         out, N, I1, K);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = sweep_cluster_kernel<V, SUM, true>;
  cudaError_t err = allow_kernel(reinterpret_cast<const void*>(kernel), true);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = -1;
  for (int q = 0; q < g_num_checked; ++q) {
    const ClusterCheck& c = g_checked[q];
    if (c.fn == reinterpret_cast<const void*>(kernel) && c.C == C &&
        c.threads == threads && c.smem == smem)
      clusters = c.clusters;
  }
  if (clusters < 0) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (g_num_checked < 64)
      g_checked[g_num_checked++] = {reinterpret_cast<const void*>(kernel), C,
                                    threads, smem, clusters};
  }
  if (clusters < 1) return -1;
  err = cudaLaunchKernelEx(&cfg, kernel, ts, Cc, Bc, Ss, Bs, sc, sb, graph,
                           out, N, I1, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, bool SUM, int T>
int launch_tiled_t(const V* ts, const V* Cc, const V* Bc, const V* Ss,
                   const V* Bs, const V* sc, const V* sb, const int* graph,
                   V* out, int S, int N, int I1, int K,
                   cudaStream_t stream) {
  const size_t smem = tiled_smem_bytes(N, I1, T, sizeof(V));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = sweep_tiled_kernel<V, SUM, T>;
  cudaError_t err = allow_kernel(reinterpret_cast<const void*>(kernel),
                                 false);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(S + T - 1) / T, tiled_threads(N, I1), smem, stream>>>(
      ts, Cc, Bc, Ss, Bs, sc, sb, graph, out, S, N, I1, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, bool SUM>
int launch_tiled(const V* ts, const V* Cc, const V* Bc, const V* Ss,
                 const V* Bs, const V* sc, const V* sb, const int* graph,
                 V* out, int S, int N, int I1, int K, int T,
                 cudaStream_t stream) {
  switch (T) {
    case 1: return launch_tiled_t<V, SUM, 1>(ts, Cc, Bc, Ss, Bs, sc, sb,
                                             graph, out, S, N, I1, K, stream);
    case 2: return launch_tiled_t<V, SUM, 2>(ts, Cc, Bc, Ss, Bs, sc, sb,
                                             graph, out, S, N, I1, K, stream);
    case 4: return launch_tiled_t<V, SUM, 4>(ts, Cc, Bc, Ss, Bs, sc, sb,
                                             graph, out, S, N, I1, K, stream);
    case 8: return launch_tiled_t<V, SUM, 8>(ts, Cc, Bc, Ss, Bs, sc, sb,
                                             graph, out, S, N, I1, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename V>
int launch(const void* ts, const void* Cc, const void* Bc, const void* Ss,
           const void* Bs, const void* sc, const void* sb, const void* graph,
           void* out, int S, int N, int I1, int K, int mode_sum, int cluster,
           int tile, void* stream_ptr) {
  const V* a[7] = {static_cast<const V*>(ts), static_cast<const V*>(Cc),
                   static_cast<const V*>(Bc), static_cast<const V*>(Ss),
                   static_cast<const V*>(Bs), static_cast<const V*>(sc),
                   static_cast<const V*>(sb)};
  const int* g = static_cast<const int*>(graph);
  V* o = static_cast<V*>(out);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (cluster > 0)
    return mode_sum
        ? launch_cluster<V, true>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], g,
                                  o, S, N, I1, K, cluster, stream)
        : launch_cluster<V, false>(a[0], a[1], a[2], a[3], a[4], a[5], a[6],
                                   g, o, S, N, I1, K, cluster, stream);
  return mode_sum
      ? launch_tiled<V, true>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], g, o,
                              S, N, I1, K, tile, stream)
      : launch_tiled<V, false>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], g, o,
                               S, N, I1, K, tile, stream);
}

}  // namespace

extern "C" {

// cluster > 0: the cluster route with that many blocks per threshold;
// otherwise the tiled route with `tile` thresholds per block (1, 2, 4, 8).
// graph: null for one graph, else the int32 graph of each of the S slots
// (S a multiple of `tile` on the tiled route, each tile of one graph).
int minplus_sweep_f64(const void* ts, const void* Cc, const void* Bc,
                      const void* Ss, const void* Bs, const void* sc,
                      const void* sb, const void* graph, void* out, int S,
                      int N, int I1, int K, int mode_sum, int cluster,
                      int tile, void* stream) {
  return launch<double>(ts, Cc, Bc, Ss, Bs, sc, sb, graph, out, S, N, I1, K,
                        mode_sum, cluster, tile, stream);
}

int minplus_sweep_f32(const void* ts, const void* Cc, const void* Bc,
                      const void* Ss, const void* Bs, const void* sc,
                      const void* sb, const void* graph, void* out, int S,
                      int N, int I1, int K, int mode_sum, int cluster,
                      int tile, void* stream) {
  return launch<float>(ts, Cc, Bc, Ss, Bs, sc, sb, graph, out, S, N, I1, K,
                       mode_sum, cluster, tile, stream);
}

}  // extern "C"
