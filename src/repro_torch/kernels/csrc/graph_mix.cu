// Node-axis graph mixing Y = W X over node-stacked flattened parameters
// (Alg. 2 line 12 for every node at once), for every leaf of a parameter
// dict in one launch.
//
// Replaces the TPU kernels in repro/kernels/graph_mix.py:
//   * `graph_mix`        (:29, pl.pallas_call at :44, body `_mix_kernel`
//     :22): W [m, n] given as f32, m != n allowed;
//   * `graph_mix_masked` (:66, pl.pallas_call at :77, body `_masked_kernel`
//     :55): W = (E + I) / rowsum built inside the kernel from the bool
//     in-edge matrix E [n, n], the uniform averaging of Morph and Epidemic
//     Learning; a row with no in-edges keeps its own model.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without tensor
// cores), n = m = 50: the largest main-path leaf (conv2, D = 51,200) moves
// 20.5 MB (X read once, Y written once: 6.1 us) for 256 MFLOP (3.8 us);
// the whole GN-LeNet tree (10 leaves, 94,858 columns) moves 37.9 MB
// (11.3 us) for 474 MFLOP (7.1 us).  Both are bound by memory.
//
// What the first design lost (one block per 64-column tile of one leaf,
// H100 80GB HBM3 at 700 W: 0.046 ms at conv2, 2.2x torch.matmul): its
// inner loop did two shared-memory loads per FMA (about 30 us of
// shared-memory issue at conv2 alone), every block ran load, sync,
// compute, store in turn with nothing in flight while it computed, every
// one of the 800 blocks re-read (and in the masked variant rebuilt) W, and
// a parameter dict took one launch per leaf: ten launches a round, six of
// them on leaves of at most 64 columns.
//
// Design (n, m <= 128, the paper's populations).  One launch covers every
// leaf: a table in the kernel's parameters gives each leaf's X, Y, D and
// the index of its first 64-column tile, the tiles numbered leaf after
// leaf.  Persistent blocks of 128 threads (256 past 64 rows), four to an
// SM, each copy W (or E) into shared memory with cp.async, ahead of their
// first tile, and build W transposed from it while that tile loads (the
// masked variant scales E + I by each row's reciprocal sum: one division a
// row, the same bits as the quotient).  Each block runs a two-tile ring
// filled with cp.async (16-byte copies where the leaf's rows are 16-byte
// aligned, zero-filled past D; plain loads elsewhere, as for D = 10),
// loading the next tile while it computes, and takes tiles from an atomic
// counter once its first two are done, so an SM that finishes early takes
// the next tile.  A thread owns 8 output rows (7 where that covers m: 56
// for m = 50, not 64) x 4 columns: per node it reads one vector of X and
// two of W for up to 32 FMAs.  Each output is the fmaf chain over
// j = 0 .. n - 1 from 0, as before, so the bits did not change; stores are
// 16 (f32) or 8 (bf16) bytes a thread where aligned, bf16 rounded to
// nearest even.
//
// What holds it back (H100 80GB HBM3, 700 W, chip_smoke.py phase 3, as
// device time in a CUDA graph): at conv2 it is level with torch.matmul,
// at about 40% of the bound; PERF.md has the numbers.  At n = 50 a
// 64-column tile is 0.4 MFLOP and an SM has about six of them: the first
// copies of X and W must land before any FMA, each thread reads 48 bytes
// of shared memory for its 28 FMAs a node, and the 10 MB of Y leave at
// the end with little left to overlap them.
//
// The tiled route (n or m past 128, where W no longer fits in shared
// memory): fig12's dense engine at n = 1000, and the rectangular products
// (a shard's [n_local, n] row block, the [n, n S] staleness contraction).
// Bound at n = m = 1000, conv2 (D = 51,200), f32: 102.4 GFLOP (1.53 ms at
// 67 TFLOP/s) against 413.6 MB (0.12 ms), so it is bound by operations;
// the whole GN-LeNet tree is 189.7 GFLOP (2.83 ms).
//
// What held its first design back (11.25 ms at that shape, masked 12.45,
// 5.1x and 5.6x torch.matmul, H100 80GB HBM3 at 700 W): a block of 256
// threads owned 32 rows x 64 columns, one column and 8 rows a thread, so
// every FMA took two shared-memory loads in a loop that was not unrolled;
// staging was load, barrier, compute with nothing in flight; X was read
// once per 32-row tile (32 times at m = 1000), and each leaf took a launch
// of its own.
//
// Design.  One launch covers every leaf through the same table, an item
// being 128 output rows x 128 columns of one leaf, numbered leaf after
// leaf and, inside a leaf, column stripe after column stripe with the
// ceil(m / 128) row tiles of a stripe next to each other
// (graph_mix.py's plan_tiled), so the blocks working at one time share X's
// stripe and read it from L2: X comes from device memory about once.
// Persistent blocks of 256 threads, two to an SM (a multiple of the row
// tiles, so a block keeps its row tile), take every gridDim.x-th item.  A
// thread holds 8 x 8 sums in registers (rows 4 ty .. + 3 and 64 + 4 ty ..
// + 3, the same for columns): per node it reads two vectors of W and two
// of X from shared memory for 64 FMAs.  The node axis goes in chunks of
// 16 through two stages filled by cp.async one chunk ahead: X by 16-byte
// copies (zero-filled past n and D; plain loads where rows are not
// aligned), W transposed by 4-byte copies; the masked variant loads its 8
// entries of E a chunk into registers, keeps them raw until the current
// chunk's products are done, and stores (E + I) times the row's
// reciprocal sum (computed once per block, exact as on the small route).
// Each output is still the fmaf chain over j = 0 .. n - 1 from 0 (a
// partial last chunk stops at n), so this route gives its first design's
// bits and the small route's; no split of the node axis and no tensor
// cores, which would change them.
//
// What holds it back (chip_smoke.py phase 3, device time in a CUDA graph,
// H100 80GB HBM3 at 700 W; PERF.md has the numbers): about 2.5 ms at
// n = 1000, conv2, 62% of its bound and some 12% slower than
// torch.matmul; masked about 2.9 ms.  3,200 items on 264 block slots run
// as 13 rounds where 12.1 would do, and inside a round the FMAs reach
// about two thirds of the peak rate (the barrier a chunk and the copies'
// address work are the likely losses); the masked variant adds E's loads,
// the conversion and a few register spills.
// One W a row (a sweep's experiments in one launch).  Each table row names
// its leaf's own W (or E); a solo call names the same one on every row.
// The small route builds w_t from its first tile's W and builds it again,
// from device memory, when a tile belongs to another W; the tiled route
// reads each item's W where it reads W anyway.  The arithmetic of every
// output is unchanged, so each leaf keeps the bits of a call of its own.
// What it costs (chip_smoke.py phase 14(b), PERF.md): at n = 50 a block
// changes W about every third tile, and the rebuilds make one launch over
// 8 experiments' GN-LeNet leaves some 25% slower than 8 one-W launches;
// past 128 nodes it is within 5% of them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using async_copy::load4;
using async_copy::to_f32;

constexpr int kItemCols = 64;   // small route: D columns per tile
constexpr int kWarpsPerSm = 16;   // small route: resident warps per SM
constexpr int kMaxLeaves = 64;
constexpr int kSmallNodes = 128;            // W whole in shared memory

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Four adjacent outputs: one vector store where the row is aligned and
// the four columns lie inside D, else one store per column inside D.
__device__ __forceinline__ void store4(float* p, const float (&v)[4],
                                       long long left, bool aligned) {
  if (aligned && left >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int c = 0; c < 4 && c < left; ++c) p[c] = v[c];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4],
                                       long long left, bool aligned) {
  if (aligned && left >= 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
    return;
  }
  for (int c = 0; c < 4 && c < left; ++c) store(p + c, v[c]);
}

// One leaf of a grouped call: its W [m, n] f32 (or E [n, n] bool), X
// [n, d], Y [m, d], the number of its first item among all the call's
// items (64-column tiles on the small route, 128 x 128 tiles on the tiled
// one), and whether X's and Y's rows all start 16-byte aligned.  Each leaf
// names its own W, so one launch mixes the leaves of several experiments,
// each with its experiment's W; a solo call names the same W on every row.
struct MixLeaf {
  const void* w;
  const void* x;
  void* y;
  long long d;
  long long item0;
  int aligned;
};

struct MixTable {
  MixLeaf leaf[kMaxLeaves];
  int count;
  long long items;
};

// Stage X[:, c0 : c0 + kItemCols] of one leaf as [n][kItemCols] in X's
// type.
template <typename T, int kGroup>
__device__ __forceinline__ void load_tile(const MixLeaf& lf, long long c0,
                                          int n, int tid, T* dst) {
  const T* x = static_cast<const T*>(lf.x);
  const long long d = lf.d;
  if (lf.aligned) {
    constexpr int kPer = 16 / (int)sizeof(T);   // elements per copy
    constexpr int kChunks = kItemCols / kPer;   // copies per row
    for (int idx = tid; idx < n * kChunks; idx += kGroup) {
      const int r = idx / kChunks;
      const int ch = idx % kChunks;
      const long long col = c0 + ch * kPer;
      const long long left = d - col;
      const int valid = left <= 0 ? 0
                        : (left >= kPer ? 16 : (int)left * (int)sizeof(T));
      async_copy::copy16(dst + r * kItemCols + ch * kPer,
                         valid ? x + (long long)r * d + col : x, valid);
    }
  } else {
    for (int idx = tid; idx < n * kItemCols; idx += kGroup) {
      const int r = idx / kItemCols;
      const long long col = c0 + idx % kItemCols;
      if (col < d) dst[idx] = x[(long long)r * d + col];
      else async_copy::set_zero(dst + idx);
    }
  }
}

// The leaf of a grouped call that item `item` belongs to.
__device__ __forceinline__ int leaf_of(const MixTable& table, long long item) {
  int l = 0;
  while (l + 1 < table.count && table.leaf[l + 1].item0 <= item) ++l;
  return l;
}

// The small route.  A block of 16 kTy threads owns 8 kTy output rows x 64
// columns of a tile: thread (ty, tx) the rows kUsed ty .. kUsed ty +
// kUsed - 1 (kUsed is 8, or 7 where 7 rows a thread cover m) and the
// columns 4 tx .. 4 tx + 3, so per node it reads one vector of X and two
// of W for up to 32 FMAs, and its vector reads and stores are contiguous
// across the warp.  Shared memory: w_t [n][8 kTy + 4] f32 (W transposed,
// 8 rows a thread, unused rows zero), then two X tiles [n][kItemCols] in
// X's type.  About 16 warps of blocks share an SM.  A block starts on two
// tiles of its own and then takes tiles in turn from sched[0] (one
// atomicAdd each, two tiles ahead), so no SM idles while another has
// tiles queued; the last block to finish sets sched[0] and sched[1] back
// to 0.  A tile's outputs do not depend on which block takes it.  A block
// builds w_t from its first tile's W (staged in shared memory where
// `w_fits` and that W is 16-byte aligned) and builds it again, from device
// memory, whenever a tile's leaf names another W; the build is the same
// arithmetic either way, so each leaf gets the bits of a call of its own.
template <typename T, bool kMasked, int kTy, int kUsed>
__global__ void __launch_bounds__(16 * kTy, kWarpsPerSm * 32 / (16 * kTy))
    mix_kernel(int w_fits, const __grid_constant__ MixTable table, int m,
               int n, int* __restrict__ sched) {
  constexpr int kBlock = 16 * kTy;
  constexpr int kTx = kItemCols / 4;  // threads along a tile's columns
  constexpr int kR = 8;              // rows per thread in w_t
  static_assert(kUsed <= kR && kR % 4 == 0, "rows per thread");
  // Output row i is row (i / kUsed) kR + i % kUsed of w_t, so each
  // thread's rows start 16-byte aligned; w_t's row stride is 8 kTy rows and
  // 4 of padding, so a warp writing one row of W into w_t's columns meets
  // at most 4-way bank conflicts.
  constexpr int kLd = 8 * kTy + 4;
  auto at_row = [](int i) { return i / kUsed * kR + i % kUsed; };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long tiles[3];     // the tiles of steps k, k + 1, k + 2
  __shared__ float inv_sum[kSmallNodes];
  unsigned char* const smem = async_copy::aligned_smem(smem_raw);
  float* w_t = reinterpret_cast<float*>(smem);
  const size_t slot = (size_t)n * kItemCols;
  // Every tile row starts on a 128-byte line.
  T* const ring = reinterpret_cast<T*>(
      smem + (sizeof(float) * n * kLd + 127) / 128 * 128);
  const long long total = table.items;

  if (threadIdx.x == 0) {
    tiles[0] = blockIdx.x;
    tiles[1] = blockIdx.x + gridDim.x;
  }
  // The first tile's W (or E) is copied whole into the second slot when it
  // fits there and is aligned, ahead of the first tile, which then loads
  // while W is built; it is read from device memory otherwise.  (A launch
  // never has more blocks than tiles.)
  const void* w_cur = table.leaf[leaf_of(table, blockIdx.x)].w;
  const unsigned char* wbytes = static_cast<const unsigned char*>(w_cur);
  if (w_fits && reinterpret_cast<uintptr_t>(w_cur) % 16 == 0) {
    const int bytes = m * n * (kMasked ? 1 : 4);
    unsigned char* stage = reinterpret_cast<unsigned char*>(ring + slot);
    for (int c = threadIdx.x; c * 16 < bytes; c += kBlock) {
      const int valid = bytes - c * 16 < 16 ? bytes - c * 16 : 16;
      async_copy::copy16(stage + c * 16, wbytes + c * 16, valid);
    }
    wbytes = stage;
  }
  async_copy::commit();
  auto issue = [&](long long item, int k) {
    const MixLeaf& lf = table.leaf[leaf_of(table, item)];
    load_tile<T, kBlock>(lf, (item - lf.item0) * kItemCols, n, threadIdx.x,
                         ring + (k % 2) * slot);
  };
  if (blockIdx.x < total) issue(blockIdx.x, 0);
  async_copy::commit();
  async_copy::wait<1>();
  __syncthreads();

  // W into w_t[j][i] (rows past m zero).  The masked variant stores
  // (E + I) times the reciprocal of each row's sum: for entries 0, 1 and 2
  // that is the IEEE quotient (E + I) / rowsum exactly, with one division
  // per row; the row sums are small integers, exact in any order (m == n).
  auto build = [&](const unsigned char* wb) {
    auto w_at = [&](int i, int j) {
      return kMasked ? (wb[i * n + j] ? 1.f : 0.f) + (i == j ? 1.f : 0.f)
                     : reinterpret_cast<const float*>(wb)[i * n + j];
    };
    if (kMasked) {
      if ((int)threadIdx.x < m) {
        const int i = threadIdx.x;
        float s = 0.f;
#pragma unroll 8
        for (int j = 0; j < n; ++j) s += w_at(i, j);
        inv_sum[i] = 1.f / s;
      }
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < n * kLd; idx += kBlock) w_t[idx] = 0.f;
    __syncthreads();
    for (int idx = threadIdx.x; idx < m * n; idx += kBlock) {
      const int i = idx / n;
      const int j = idx % n;
      w_t[j * kLd + at_row(i)] = kMasked ? w_at(i, j) * inv_sum[i]
                                         : w_at(i, j);
    }
  };
  build(wbytes);

  const int tx = threadIdx.x % kTx;  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / kTx;  // rows kUsed ty .. kUsed ty + kUsed - 1
  const int i0 = ty * kUsed;
  for (int k = 0;; ++k) {
    const long long item = tiles[k % 3];
    if (item >= total) break;
    async_copy::wait<0>();
    __syncthreads();   // tile k (and W) is ready; tile k - 1 is consumed
    const long long next = tiles[(k + 1) % 3];
    if (next < total) issue(next, k + 1);
    async_copy::commit();
    if (threadIdx.x == 0)
      tiles[(k + 2) % 3] = 2LL * gridDim.x + atomicAdd(sched, 1);
    const MixLeaf& lf = table.leaf[leaf_of(table, item)];
    if (lf.w != w_cur) {
      // Every thread is past tile k - 1's products (the barrier above).
      w_cur = lf.w;
      build(static_cast<const unsigned char*>(w_cur));
      __syncthreads();
    }
    if (i0 >= m) continue;

    const T* xs = ring + (k % 2) * slot + 4 * tx;
    const float* ws = w_t + ty * kR;
    float acc[kUsed][4];
#pragma unroll
    for (int r = 0; r < kUsed; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    // Ten nodes a step keep the loads of later nodes in flight while the
    // products of earlier ones issue (two and four were slower on the card).
#pragma unroll 10
    for (int j = 0; j < n; ++j) {
      const float4 xv = load4(xs + j * kItemCols);
      float wv[kR];
#pragma unroll
      for (int q = 0; q < kR; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(ws + j * kLd + q);
        wv[q] = t.x; wv[q + 1] = t.y; wv[q + 2] = t.z; wv[q + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < kUsed; ++r) {
        acc[r][0] = fmaf(wv[r], xv.x, acc[r][0]);
        acc[r][1] = fmaf(wv[r], xv.y, acc[r][1]);
        acc[r][2] = fmaf(wv[r], xv.z, acc[r][2]);
        acc[r][3] = fmaf(wv[r], xv.w, acc[r][3]);
      }
    }
    const long long col = (item - lf.item0) * kItemCols + 4 * tx;
    const long long left = lf.d - col;
    if (left <= 0) continue;
    T* y = static_cast<T*>(lf.y);
#pragma unroll
    for (int r = 0; r < kUsed; ++r)
      if (i0 + r < m)
        store4(y + (long long)(i0 + r) * lf.d + col, acc[r], left,
               lf.aligned != 0);
  }
  async_copy::wait<0>();
  // Every block has taken its last tile: the last one out resets the
  // counters for the next launch.
  if (threadIdx.x == 0 && atomicAdd(sched + 1, 1) == (int)gridDim.x - 1) {
    sched[0] = 0;
    sched[1] = 0;
  }
}

// The tiled route (m or n past 128).  A tile is 128 output rows x 128
// columns of one leaf; the items are numbered leaf after leaf and, inside
// a leaf, column stripe after column stripe with the row tiles of a stripe
// next to each other, so the blocks working at one time share X's stripe
// and read it from L2.  Persistent blocks of 256 threads, two to an SM,
// take the items in turn (item blockIdx.x, then every gridDim.x-th).
constexpr int kTileRows = 128;   // output rows per tile
constexpr int kTileCols = 128;   // D columns per tile
constexpr int kDepth = 16;       // nodes per staged chunk
constexpr int kTiledThreads = 256;
constexpr int kTiledPerSm = 2;   // resident blocks per SM
constexpr int kWLd = kTileRows + 4;   // w_s row stride: 16-byte rows
constexpr int kWRows = kTiledThreads / kDepth;   // W staging: row step
constexpr int kWPer = kTileRows / kWRows;          // W values a thread

// One chunk of the node axis for the thread's 8 x 8 outputs: rows
// 4 ty .. 4 ty + 3 and 64 + 4 ty .. 64 + 4 ty + 3, columns 4 tx .. 4 tx + 3
// and 64 + 4 tx .. 64 + 4 tx + 3.  Per node two vectors of W (transposed)
// and two of X for 64 FMAs, in node order; a partial last chunk
// (!kFull) stops at `depth`, so every output is the fmaf chain over
// j = 0 .. n - 1 and nothing else.
template <typename T, bool kFull>
__device__ __forceinline__ void tiled_chunk(const float (*ws)[kWLd],
                                            const T (*xs)[kTileCols],
                                            int depth, int tx, int ty,
                                            float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    if (!kFull && kk >= depth) break;
    const float4 a0 = *reinterpret_cast<const float4*>(&ws[kk][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&ws[kk][64 + 4 * ty]);
    const float4 b0 = load4(&xs[kk][4 * tx]);
    const float4 b1 = load4(&xs[kk][64 + 4 * tx]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// Shared memory (static, 34 KB in f32): two stages of W's chunk
// transposed (w_s[stage][node][row]) and of X's chunk (x_s[stage][node]
// [column], in X's type), and the masked variant's reciprocal row sums.
// X's chunk arrives by cp.async (16-byte copies where the leaf's rows are
// aligned, zero-filled past n and D; plain loads elsewhere), and so does
// W's, transposed by 4-byte copies; the masked variant loads E's chunk
// into registers, 8 entries a thread, and stores (E + I) / rowsum
// transposed once the current chunk's products are done.  Both stages
// are one chunk ahead of the products.  kOneW: every leaf names the same
// W, passed as `wsrc` (a solo call); otherwise each item reads its
// leaf's W from the table (a sweep; the per-item pointer added 16 bytes of
// spills to the f32 kernel and some 5% at n = 1000, so a solo call keeps
// this instantiation).
template <typename T, bool kMasked, bool kOneW>
__global__ void __launch_bounds__(kTiledThreads, kTiledPerSm)
    mix_tiled_kernel(const void* __restrict__ wsrc,
                     const __grid_constant__ MixTable table, int m, int n) {
  constexpr int kPer = 16 / (int)sizeof(T);          // X elements a copy
  constexpr int kCopies = kTileCols / kPer;          // copies a node
  constexpr int kXPer = kDepth * kCopies / kTiledThreads;   // a thread
  static_assert(kXPer * kTiledThreads == kDepth * kCopies, "X copies");
  __shared__ __align__(16) float w_s[2][kDepth][kWLd];
  __shared__ __align__(16) unsigned char x_raw[2 * kDepth * kTileCols
                                              * sizeof(T)];
  auto x_s = reinterpret_cast<T (*)[kDepth][kTileCols]>(x_raw);
  __shared__ float inv_s[kTileRows];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int wk = tid % kDepth;    // W staging: node j0 + wk,
  const int wr = tid / kDepth;    // rows wr + kWRows q for q < kWPer
  const long long row_tiles = (m + kTileRows - 1) / kTileRows;
  const int chunks = (n + kDepth - 1) / kDepth;

  int inv_i0 = -1;             // the row tile whose reciprocals inv_s holds,
  const void* inv_w = nullptr;  // of this E
  for (long long item = blockIdx.x; item < table.items; item += gridDim.x) {
    const MixLeaf& lf = table.leaf[leaf_of(table, item)];
    const void* const wp = kOneW ? wsrc : lf.w;
    const unsigned char* e = static_cast<const unsigned char*>(wp);
    const float* w = static_cast<const float*>(wp);
    const long long local = item - lf.item0;
    const int i0 = (int)(local % row_tiles) * kTileRows;
    const long long c0 = local / row_tiles * kTileCols;
    const T* x = static_cast<const T*>(lf.x);
    const long long d = lf.d;

    if (kMasked && (i0 != inv_i0 || (!kOneW && wp != inv_w))) {
      // 1 / rowsum(E + I) for the tile's rows: the sums are small
      // integers, exact in any order, and (E + I) times the reciprocal is
      // the quotient (E + I) / rowsum exactly for entries 0, 1 and 2.
      // Every leaf's first item is a multiple of the row tiles, and the
      // grid is too where it can be, so a block keeps its row tile.
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int r = warp; r < kTileRows; r += kTiledThreads / 32) {
        const int i = i0 + r;
        float s = 0.f;
        if (i < m)
          for (int j = lane; j < n; j += 32)
            s += e[(long long)i * n + j] ? 1.f : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) inv_s[r] = i < m ? 1.f / (s + 1.f) : 0.f;
      }
      __syncthreads();
      inv_i0 = i0;
      inv_w = wp;
    }

    // W (or E) staging: this thread's entries are rows i0 + wr + kWRows q
    // (those below m: bit q of w_rows) of node j0 + wk.
    const long long w_at = (long long)(i0 + wr) * n + wk;
    const long long w_step = (long long)kWRows * n;
    unsigned w_rows = 0;
#pragma unroll
    for (int q = 0; q < kWPer; ++q)
      w_rows |= (i0 + wr + kWRows * q < m ? 1u : 0u) << q;
    // The masked variant loads E's entries raw and uses them only after
    // the current chunk's products, so the products never wait for them.
    unsigned char eb[kMasked ? kWPer : 1];
    auto stage_w = [&](int j0, int stage) {
      const bool in_n = j0 + wk < n;
#pragma unroll
      for (int q = 0; q < kWPer; ++q) {
        const bool live = in_n && (w_rows >> q & 1u);
        if constexpr (kMasked)
          eb[q] = live ? e[w_at + q * w_step + j0] : 0;
        else
          async_copy::copy4(&w_s[stage][wk][wr + kWRows * q],
                            live ? w + w_at + q * w_step + j0 : w,
                            live ? 4 : 0);
      }
    };
    auto store_w = [&](int j0, int stage) {
      if constexpr (kMasked) {
        // i == j for entry q where j0 + wk - (i0 + wr) == kWRows q.
        const int diag = j0 + wk - (i0 + wr);
        const bool in_n = j0 + wk < n;
#pragma unroll
        for (int q = 0; q < kWPer; ++q)
          w_s[stage][wk][wr + kWRows * q] =
              in_n && (w_rows >> q & 1u)
                  ? ((eb[q] ? 1.f : 0.f) + (diag == kWRows * q ? 1.f : 0.f))
                        * inv_s[wr + kWRows * q]
                  : 0.f;
      }
    };
    // X's copies of this thread (aligned leaves): node r_p of the chunk,
    // columns from x_col[p], x_bytes[p] of them inside D.
    int x_node[kXPer], x_bytes[kXPer];
    long long x_at[kXPer];
#pragma unroll
    for (int p = 0; p < kXPer; ++p) {
      const int c = tid + p * kTiledThreads;
      const long long col = c0 + (c % kCopies) * kPer;
      const long long left = d - col;
      x_node[p] = c / kCopies;
      x_at[p] = (long long)x_node[p] * d + col;
      x_bytes[p] = left <= 0 ? 0
                   : (left >= kPer ? 16 : (int)left * (int)sizeof(T));
    }
    auto issue_x = [&](int j0, int stage) {
      if (lf.aligned) {
        const T* base = x + (long long)j0 * d;
#pragma unroll
        for (int p = 0; p < kXPer; ++p) {
          const int c = tid + p * kTiledThreads;
          const int valid = j0 + x_node[p] < n ? x_bytes[p] : 0;
          async_copy::copy16(&x_s[stage][x_node[p]][(c % kCopies) * kPer],
                             valid ? base + x_at[p] : x, valid);
        }
      } else {
        for (int c = tid; c < kDepth * kTileCols; c += kTiledThreads) {
          const int r = c / kTileCols;
          const int j = j0 + r;
          const long long col = c0 + c % kTileCols;
          if (j < n && col < d)
            x_s[stage][r][c % kTileCols] = x[(long long)j * d + col];
          else
            async_copy::set_zero(&x_s[stage][r][c % kTileCols]);
        }
      }
    };

    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    // Stage 0 holds chunk 0 before the loop; each step then starts the
    // next chunk's copies (and E loads), runs this chunk's products, and
    // stores the next W transposed (masked).  The one barrier a step also
    // tells the next tile that both stages are free.
    stage_w(0, 0);
    store_w(0, 0);
    issue_x(0, 0);
    async_copy::commit();
    async_copy::wait<0>();
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const int stage = c & 1;
      const bool more = c + 1 < chunks;
      if (more) {
        issue_x((c + 1) * kDepth, stage ^ 1);
        stage_w((c + 1) * kDepth, stage ^ 1);
      }
      async_copy::commit();
      const int depth = n - c * kDepth;
      if (depth >= kDepth)
        tiled_chunk<T, true>(w_s[stage], x_s[stage], kDepth, tx, ty, acc);
      else
        tiled_chunk<T, false>(w_s[stage], x_s[stage], depth, tx, ty, acc);
      if (more) store_w((c + 1) * kDepth, stage ^ 1);
      async_copy::wait<0>();
      __syncthreads();
    }

    T* y = static_cast<T*>(lf.y);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
      if (i >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long col = c0 + 64 * h + 4 * tx;
        const float v[4] = {acc[r][4 * h], acc[r][4 * h + 1],
                            acc[r][4 * h + 2], acc[r][4 * h + 3]};
        if (d - col > 0)
          store4(y + (long long)i * d + col, v, d - col, lf.aligned != 0);
      }
    }
  }
}

// The small route's launch: persistent blocks, about kWarpsPerSm warps of
// them per SM (fewer where shared memory holds fewer), never more than the
// tiles.
template <typename T, bool kMasked, int kTy, int kUsed>
int launch_small(const MixTable& table, int m, int n, int sms, int* sched,
                 cudaStream_t stream) {
  if (table.items == 0) return (int)cudaSuccess;
  constexpr int kBlock = 16 * kTy;
  constexpr size_t kSharedMax = 227 * 1024;   // an SM's shared memory
  const size_t slot_bytes = sizeof(T) * (size_t)n * kItemCols;
  const size_t smem = async_copy::kSmemAlign
                      + (sizeof(float) * (size_t)n * (8 * kTy + 4) + 127)
                            / 128 * 128
                      + 2 * slot_bytes;
  const size_t w_bytes = (size_t)m * n * (kMasked ? 1 : 4);
  const int w_fits = w_bytes <= slot_bytes;
  auto kernel = mix_kernel<T, kMasked, kTy, kUsed>;
  static async_copy::KernelSetup setup;
  const cudaError_t err = async_copy::prepare(kernel, setup, smem);
  if (err != cudaSuccess) return (int)err;
  long long per_sm = kWarpsPerSm * 32 / kBlock;
  while (per_sm > 1 && per_sm * (smem + 1024) > kSharedMax) --per_sm;
  const long long slots = per_sm * sms;
  const long long blocks = table.items < slots ? table.items : slots;
  kernel<<<(unsigned)blocks, kBlock, smem, stream>>>(w_fits, table, m, n,
                                                     sched);
  return (int)cudaGetLastError();
}

// The tiled route's launch: kTiledPerSm blocks per SM, rounded down to a
// multiple of the row tiles where there are more slots than row tiles (so
// each block keeps one row tile), never more than the items.
template <typename T, bool kMasked>
int launch_tiled(const MixTable& table, int m, int n, int sms,
                 cudaStream_t stream) {
  if (table.items == 0) return (int)cudaSuccess;
  const long long row_tiles = (m + kTileRows - 1) / kTileRows;
  long long slots = (long long)kTiledPerSm * sms;
  if (slots >= row_tiles) slots -= slots % row_tiles;
  const long long blocks = table.items < slots ? table.items : slots;
  bool one_w = true;
  for (int l = 1; l < table.count; ++l)
    one_w = one_w && table.leaf[l].w == table.leaf[0].w;
  if (one_w)
    mix_tiled_kernel<T, kMasked, true>
        <<<(unsigned)blocks, kTiledThreads, 0, stream>>>(table.leaf[0].w,
                                                         table, m, n);
  else
    mix_tiled_kernel<T, kMasked, false>
        <<<(unsigned)blocks, kTiledThreads, 0, stream>>>(nullptr, table, m,
                                                         n);
  return (int)cudaGetLastError();
}

// leaves: `count` rows of (W pointer, X pointer, Y pointer, D, first item)
// as int64.
template <typename T, bool kMasked>
int launch_mix(const long long* leaves, int count, int m, int n, int sms,
               int* sched, cudaStream_t stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  MixTable table;
  table.count = count;
  for (int l = 0; l < count; ++l) {
    const long long* row = leaves + 5 * l;
    MixLeaf& lf = table.leaf[l];
    lf.w = reinterpret_cast<const void*>(row[0]);
    lf.x = reinterpret_cast<const void*>(row[1]);
    lf.y = reinterpret_cast<void*>(row[2]);
    lf.d = row[3];
    lf.item0 = row[4];
    lf.aligned = (row[1] % 16 == 0) && (row[2] % 16 == 0)
                 && ((row[3] * (long long)sizeof(T)) % 16 == 0);
  }
  const MixLeaf& last = table.leaf[count - 1];
  if (m > kSmallNodes || n > kSmallNodes) {
    // The tiled route: ceil(m / 128) items per 128-column stripe.
    table.items = last.item0 + (m + kTileRows - 1) / kTileRows
                                   * ((last.d + kTileCols - 1) / kTileCols);
    return launch_tiled<T, kMasked>(table, m, n, sms, stream);
  }
  table.items = last.item0 + (last.d + kItemCols - 1) / kItemCols;
  // Rows per thread: 8, or 7 where that covers m (m = 50 takes 8 x 7 rows,
  // not 8 x 8).
  if (m <= 56)
    return launch_small<T, kMasked, 8, 7>(table, m, n, sms, sched,
                                          stream);
  if (m <= 64)
    return launch_small<T, kMasked, 8, 8>(table, m, n, sms, sched,
                                          stream);
  if (m <= 112)
    return launch_small<T, kMasked, 16, 7>(table, m, n, sms, sched,
                                          stream);
  return launch_small<T, kMasked, 16, 8>(table, m, n, sms, sched,
                                          stream);
}

}  // namespace

// leaves: `count` rows of int64 (W [m, n] f32 pointer, X [n, d] pointer,
// Y [m, d] pointer in X's type, d, index of the leaf's first item among the
// call's items: graph_mix.py's plan_mix up to 128 nodes and rows,
// plan_tiled past); sms: the device's SM count; sched: two int32 counters,
// 0 before the call and left 0 by it (the small route's tile scheduler).
extern "C" int graph_mix_f32(const long long* leaves, int count, int m, int n,
                             int sms, void* sched, void* stream) {
  return launch_mix<float, false>(leaves, count, m, n, sms,
                                  static_cast<int*>(sched),
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int graph_mix_bf16(const long long* leaves, int count, int m,
                              int n, int sms, void* sched, void* stream) {
  return launch_mix<__nv_bfloat16, false>(leaves, count, m, n, sms,
                                          static_cast<int*>(sched),
                                          static_cast<cudaStream_t>(stream));
}

// leaves as above with an E [n, n] bool (one byte each) pointer in place
// of W, and m == n.
extern "C" int graph_mix_masked_f32(const long long* leaves, int count, int n,
                                    int sms, void* sched, void* stream) {
  return launch_mix<float, true>(leaves, count, n, n, sms,
                                 static_cast<int*>(sched),
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int graph_mix_masked_bf16(const long long* leaves, int count,
                                     int n, int sms, void* sched,
                                     void* stream) {
  return launch_mix<__nv_bfloat16, true>(leaves, count, n, n, sms,
                                         static_cast<int*>(sched),
                                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* graph_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
