// Gram matrices G = X X^T of node-stacked parameters, every leaf of a
// parameter dict in one launch, for Eq. 3's per-layer cosine similarity
// (the epilogue g / (|x_i| |x_j|) and the mean over leaves are done by the
// caller, repro_torch.kernels.ops).
//
// Replaces the TPU kernel repro/kernels/pairwise_cosine.py `gram_matrix`
// (:40, pl.pallas_call at :50, body `_gram_kernel` at :30), which walks D
// as a sequential grid and carries the [n, n] sum in VMEM from step to
// step.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without tensor
// cores), n = 50: the largest main-path leaf (conv2, D = 51,200) reads
// 10.25 MB (3.06 us) and, X X^T being symmetric, needs n (n + 1) D =
// 130.6 MFLOP (1.95 us); the whole GN-LeNet tree (10 leaves, 94,858
// columns) reads 19.0 MB (5.7 us) for 242 MFLOP (3.6 us).  Both are bound
// by memory.
//
// What the first design lost (H100 80GB HBM3 at 700 W: 0.051 ms at conv2,
// 1.5x `x @ x.T`): it computed every 64 x 64 tile, both triangles and, at
// n = 50, 64 rows for 50 (3.3x the needed FMAs), loading the diagonal
// tile's one row panel twice; each block ran 7 stages of load, sync,
// compute, sync with nothing in flight while it computed; its 229 split
// partials (2.3 MB) were summed by a second launch of 2,500 threads on 10
// SMs, each walking the partials one after another; and a parameter dict
// took two launches per leaf.
//
// Design.  Blocks cannot carry a sum from one to the next as the TPU grid
// does, so D is split ("split-K").  A leaf's plan depends only on its n,
// its D and the SM count (repro_torch.kernels.pairwise_cosine.plan_gram):
// only tiles i <= j of the 64 x 64 output tiling are computed (one at
// n <= 64) and mirrored; each tile gets C clusters of 8 blocks (C up to
// about one block per SM), and block (cluster c, rank q) sums the split
// 8 c + q, a whole number of 64-column stages.  The leaves' clusters are
// numbered leaf after leaf through a table in the kernel's parameters, so
// one launch takes every leaf.  A block streams its split through a ring
// of three stages filled with cp.async (16-byte copies where the leaf's
// rows are 16-byte aligned, plain loads elsewhere; zero past D), stored
// row-major with the 16-byte chunks XOR-swizzled by row so that the
// compute's vector reads hit distinct banks.  A diagonal tile holds one
// row panel for both operands, and its 128 threads take only the 4 x 4
// micro-tiles on or above the diagonal and inside n (91 at n = 50; an
// off-diagonal tile's 256 take two a thread): per 4 columns of D a thread
// reads 8 vectors for 64 FMAs.  With few micro-tiles, groups of threads
// split each stage's columns and add their sums in group order.  Blocks
// of 128 threads let four share an SM, so the tree's clusters run in one
// wave.  The reduction across blocks is fixed in order, so two calls give
// the same bits (Morph multiplies the similarity by beta = 500 before its
// Gumbel top-k; run-to-run noise there could change the chosen peers),
// and uses no float atomics: the 8 blocks of a cluster add their partial
// tiles through distributed shared memory in rank order, block q taking
// rows 8 q .. 8 q + 7 of the tile; with C = 1 that is the result,
// otherwise each block writes its rows of the cluster's sum to scratch and
// takes an integer ticket (atomicAdd after __threadfence()), and the block
// that draws the last ticket for those rows adds the C cluster sums in
// cluster order, eight loads in flight at a time, writes them and resets
// the ticket to 0 for the next call.
//
// What holds it back (H100 80GB HBM3, 700 W, chip_smoke.py phase 3):
// 0.0234 ms at conv2 against x @ x.T's 0.0327, both as device time in a
// CUDA graph, 13% of the bound; 0.0335 ms for the whole tree in one launch
// against 0.1126 for a loop of x @ x.T over its leaves.  A block's 91
// active threads are three warps: at one block per SM (conv2's 16
// clusters) the FMA chains and shared-memory reads of a stage are not
// hidden, and the cluster and final sums wait for the slowest block.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

using async_copy::load4;

constexpr int kTile = 64;      // output rows/cols per tile
constexpr int kDepth = 64;     // D columns per stage
constexpr int kStages = 3;     // stages in the ring
constexpr int kThreads = 128;  // one or two 4 x 4 micro-tiles each
constexpr int kCluster = 8;    // blocks per cluster
constexpr int kMaxLeaves = 32;
constexpr int kSlice = kTile * kTile / kCluster;   // outputs per rank
constexpr int kPerThread = kSlice / kThreads;

// One leaf of a grouped call: X [n, d]; its tiles' clusters are numbered
// from cluster0, its cluster sums start at scratch0 (floats) and its
// tickets at ticket0.
struct GramLeaf {
  const void* x;
  long long d;
  long long split_len;
  long long cluster0;
  long long scratch0;
  int clusters;
  int ticket0;
  int aligned;
};

struct GramTable {
  GramLeaf leaf[kMaxLeaves];
  int count;
  int tiles;   // 64-row tiles along n
};

// Element offset of (row r, column k) in a swizzled [kTile][kDepth] panel:
// the 16-byte chunk index is XORed with (r / 4) mod 8.
template <typename T>
__device__ __forceinline__ int swizzle(int r, int k) {
  constexpr int kPer = 16 / (int)sizeof(T);
  return r * kDepth + (((k / kPer) ^ ((r >> 2) & 7)) * kPer) + k % kPer;
}

// Stage X[row0 : row0 + rows, k0 : k0 + kDepth] (zero at or past k_end).
template <typename T>
__device__ __forceinline__ void load_panel(const T* x, long long d,
                                           int row0, int rows, long long k0,
                                           long long k_end, bool aligned,
                                           T* dst) {
  constexpr int kPer = 16 / (int)sizeof(T);
  if (aligned) {
    constexpr int kChunks = kDepth / kPer;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int ch = idx % kChunks;
      const long long col = k0 + ch * kPer;
      const long long left = k_end - col;
      const int valid = left <= 0 ? 0
                        : (left >= kPer ? 16 : (int)left * (int)sizeof(T));
      async_copy::copy16(dst + swizzle<T>(r, ch * kPer),
                         valid ? x + (long long)(row0 + r) * d + col : x,
                         valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kDepth; idx += kThreads) {
      const int r = idx / kDepth;
      const int k = idx % kDepth;
      const long long col = k0 + k;
      T* at = dst + swizzle<T>(r, k);
      if (col < k_end) *at = x[(long long)(row0 + r) * d + col];
      else async_copy::set_zero(at);
    }
  }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 4)
    gram_kernel(const __grid_constant__ GramTable table, int n, int panels,
                float* __restrict__ out, float* __restrict__ scratch,
                int* __restrict__ tickets) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  T* ring = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem);  // [kTile][kTile] at the end
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();

  // This cluster's (leaf, tile i <= j, cluster c) and this block's split.
  const long long cid = blockIdx.x / kCluster;
  int l = 0;
  while (l + 1 < table.count && table.leaf[l + 1].cluster0 <= cid) ++l;
  const GramLeaf& lf = table.leaf[l];
  const long long local = cid - lf.cluster0;
  const int tile = (int)(local / lf.clusters);
  const int c = (int)(local % lf.clusters);
  int ti = 0, rest = tile;
  while (rest >= table.tiles - ti) {
    rest -= table.tiles - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const bool diag = ti == tj;
  const int row0 = ti * kTile;
  const int col0 = tj * kTile;
  const int rows_a = n - row0 < kTile ? n - row0 : kTile;
  const int rows_b = n - col0 < kTile ? n - col0 : kTile;
  const long long split = (long long)c * kCluster + rank;
  const long long k_begin =
      split * lf.split_len < lf.d ? split * lf.split_len : lf.d;
  const long long k_end =
      k_begin + lf.split_len < lf.d ? k_begin + lf.split_len : lf.d;
  const int stages = (int)((k_end - k_begin + kDepth - 1) / kDepth);
  const T* x = static_cast<const T*>(lf.x);
  const size_t panel = (size_t)kTile * kDepth;
  const size_t stage_size = panel * panels;

  // The tile's 4 x 4 micro-tiles (rows 4 ty .., columns 4 tx ..; a
  // diagonal tile takes only ty <= tx, both inside n), numbered row by
  // row.  Thread t takes micro-tiles t and t + kThreads.  With fewer
  // micro-tiles than threads, G groups of threads (a power of two, at most
  // 8) split each stage's columns and add their partials in group order.
  const int qa = (rows_a + 3) / 4;
  const int qb = (rows_b + 3) / 4;
  const int tiles4 = diag ? qa * (qa + 1) / 2 : kTile / 4 * qb;
  int groups = 1;
  while (groups < 8 && 2 * groups * tiles4 <= kThreads) groups *= 2;
  const int group = groups > 1 ? threadIdx.x / tiles4 : 0;
  auto micro = [&](int t, int& ty, int& tx) {
    ty = 0;
    if (diag) {
      while (t >= qa - ty) {
        t -= qa - ty;
        ++ty;
      }
      tx = ty + t;
    } else {
      ty = t / qb;
      tx = t % qb;
    }
  };
  const int t0 = groups > 1 ? threadIdx.x % tiles4 : threadIdx.x;
  const bool has0 = group < groups && t0 < tiles4;
  const bool has1 = groups == 1 && t0 + kThreads < tiles4;
  int ty0 = 0, tx0 = 0, ty1 = 0, tx1 = 0;
  if (has0) micro(t0, ty0, tx0);
  if (has1) micro(t0 + kThreads, ty1, tx1);
  const int k_lo = group * (kDepth / groups);
  const int k_hi = k_lo + kDepth / groups;

  // Rows past n are never loaded: zero them once in every stage.
  for (int s = 0; s < kStages; ++s) {
    T* a = ring + s * stage_size;
    for (int idx = threadIdx.x; idx < (kTile - rows_a) * kDepth;
         idx += kThreads)
      async_copy::set_zero(a + rows_a * kDepth + idx);
    if (!diag)
      for (int idx = threadIdx.x; idx < (kTile - rows_b) * kDepth;
           idx += kThreads)
        async_copy::set_zero(a + panel + rows_b * kDepth + idx);
  }
  auto issue = [&](int s) {
    const long long k0 = k_begin + (long long)s * kDepth;
    T* dst = ring + (s % kStages) * stage_size;
    load_panel<T>(x, lf.d, row0, rows_a, k0, k_end, lf.aligned != 0, dst);
    if (!diag)
      load_panel<T>(x, lf.d, col0, rows_b, k0, k_end, lf.aligned != 0,
                    dst + panel);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) issue(s);
    async_copy::commit();
  }

  // acc[u] sums the thread's micro-tile u over its columns of each stage,
  // in column order.
  float acc[2][4][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][i][j] = 0.f;
  auto accumulate = [&](const T* a_s, const T* b_s, int ty, int tx,
                        float (&sum)[4][4]) {
#pragma unroll 4
    for (int k = k_lo; k < k_hi; k += 4) {
      float av[4][4], bv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 va = load4(a_s + swizzle<T>(4 * ty + i, k));
        const float4 vb = load4(b_s + swizzle<T>(4 * tx + i, k));
        av[i][0] = va.x; av[i][1] = va.y; av[i][2] = va.z; av[i][3] = va.w;
        bv[i][0] = vb.x; bv[i][1] = vb.y; bv[i][2] = vb.z; bv[i][3] = vb.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum[i][j] = fmaf(av[i][kk], bv[j][kk], sum[i][j]);
    }
  };
  for (int s = 0; s < stages; ++s) {
    async_copy::wait<kStages - 2>();
    __syncthreads();   // stage s has landed; stage s - 1 is consumed
    if (s + kStages - 1 < stages) issue(s + kStages - 1);
    async_copy::commit();
    const T* a_s = ring + (s % kStages) * stage_size;
    const T* b_s = diag ? a_s : a_s + panel;
    if (has0) accumulate(a_s, b_s, ty0, tx0, acc[0]);
    if (has1) accumulate(a_s, b_s, ty1, tx1, acc[1]);
  }
  async_copy::wait<0>();
  __syncthreads();     // the ring is consumed: reuse it for the partial
  for (int g = 0; g < groups; ++g) {
    if (has0 && group == g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* at = part + (4 * ty0 + i) * kTile + 4 * tx0 + j;
          *at = g == 0 ? acc[0][i][j] : *at + acc[0][i][j];
        }
    __syncthreads();
  }
  if (has1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[(4 * ty1 + i) * kTile + 4 * tx1 + j] = acc[1][i][j];

  // The cluster's sum of rows 8 rank .. 8 rank + 7, in rank order.
  cluster.sync();
  float v[kPerThread];
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    const int e = rank * kSlice + h * kThreads + threadIdx.x;
    float s = *cluster.map_shared_rank(part + e, 0);
#pragma unroll
    for (int q = 1; q < kCluster; ++q)
      s += *cluster.map_shared_rank(part + e, q);
    v[h] = s;
  }
  cluster.sync();      // no block leaves while another reads its part

  float* o = out + (long long)l * n * n;
  auto emit = [&](int e, float s) {
    const int r = e / kTile;
    const int cc = e % kTile;
    const int gr = row0 + r;
    const int gc = col0 + cc;
    if (gr < n && gc < n && (!diag || r <= cc)) {
      o[(long long)gr * n + gc] = s;
      o[(long long)gc * n + gr] = s;
    }
  };
  if (lf.clusters == 1) {
#pragma unroll
    for (int h = 0; h < kPerThread; ++h)
      emit(rank * kSlice + h * kThreads + threadIdx.x, v[h]);
    return;
  }
  float* sums = scratch + lf.scratch0
                + (long long)tile * lf.clusters * kTile * kTile;
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    const int e = rank * kSlice + h * kThreads + threadIdx.x;
    sums[(long long)c * kTile * kTile + e] = v[h];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = tickets + lf.ticket0 + tile * kCluster + rank;
    last = atomicAdd(ticket, 1) == lf.clusters - 1;
    if (last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The cluster sums in cluster order, eight loads in flight at a time.
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    const int e = rank * kSlice + h * kThreads + threadIdx.x;
    float s = 0.f;
    for (int q0 = 0; q0 < lf.clusters; q0 += 8) {
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        t[u] = q0 + u < lf.clusters
                   ? __ldcg(sums + (long long)(q0 + u) * kTile * kTile + e)
                   : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u < lf.clusters) s = q0 + u == 0 ? t[u] : s + t[u];
    }
    emit(e, s);
  }
}

// leaves: `count` rows of int64 (X pointer, d, clusters, split_len,
// cluster0, scratch0, ticket0).
template <typename T>
int launch_gram(const long long* leaves, int count, int n, float* out,
                float* scratch, int* tickets, cudaStream_t stream) {
  if (count < 1 || count > kMaxLeaves || n < 1)
    return (int)cudaErrorInvalidValue;
  GramTable table;
  table.count = count;
  table.tiles = (n + kTile - 1) / kTile;
  for (int l = 0; l < count; ++l) {
    const long long* row = leaves + 7 * l;
    GramLeaf& lf = table.leaf[l];
    lf.x = reinterpret_cast<const void*>(row[0]);
    lf.d = row[1];
    lf.clusters = (int)row[2];
    lf.split_len = row[3];
    lf.cluster0 = row[4];
    lf.scratch0 = row[5];
    lf.ticket0 = (int)row[6];
    lf.aligned = (row[0] % 16 == 0)
                 && ((row[1] * (long long)sizeof(T)) % 16 == 0);
    if (lf.clusters < 1 || lf.split_len < 1 || lf.split_len % kDepth)
      return (int)cudaErrorInvalidValue;
  }
  const GramLeaf& lf = table.leaf[count - 1];
  const long long pairs = (long long)table.tiles * (table.tiles + 1) / 2;
  const long long blocks = (lf.cluster0 + pairs * lf.clusters) * kCluster;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int panels = table.tiles > 1 ? 2 : 1;
  const size_t smem = sizeof(T) * (size_t)kStages * panels * kTile * kDepth;
  auto kernel = gram_kernel<T>;
  static async_copy::KernelSetup setup;
  const cudaError_t err = async_copy::prepare(kernel, setup, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(table, n, panels, out,
                                                       scratch, tickets);
  return (int)cudaGetLastError();
}

}  // namespace

// leaves: `count` rows of int64 as launch_gram takes them (the plan of
// repro_torch.kernels.pairwise_cosine.plan_gram); out: [count, n, n] f32;
// scratch: the plan's cluster sums (f32); tickets: the plan's int32
// tickets, all 0 (the kernel leaves them 0).
extern "C" int gram_f32(const long long* leaves, int count, int n, void* out,
                        void* scratch, void* tickets, void* stream) {
  return launch_gram<float>(leaves, count, n, static_cast<float*>(out),
                            static_cast<float*>(scratch),
                            static_cast<int*>(tickets),
                            static_cast<cudaStream_t>(stream));
}

extern "C" int gram_bf16(const long long* leaves, int count, int n,
                         void* out, void* scratch, void* tickets,
                         void* stream) {
  return launch_gram<__nv_bfloat16>(leaves, count, n,
                                    static_cast<float*>(out),
                                    static_cast<float*>(scratch),
                                    static_cast<int*>(tickets),
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* pairwise_cosine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
