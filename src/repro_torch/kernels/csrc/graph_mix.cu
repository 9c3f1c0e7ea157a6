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
// Past 128 nodes or rows W no longer fits, and a second route tiles both
// axes, one launch per leaf: each block owns 32 output rows x 64 columns
// and walks the node axis in chunks of 32, staging W[rows, chunk] and
// X[chunk, cols] in shared memory and keeping its 8 sums per thread in
// registers.  Each sum takes the same fmaf sequence over j = 0 .. n - 1 as
// the first route, so the two routes give the same bits; the masked rows
// are divided by the same exact integer row sums (the first route's
// reciprocals give the same quotients).  X is read once per
// 32-row tile (ceil(m / 32) times in all); at n = 1000 the route is bound
// by its 102 GFLOP (1.5 ms at 67 TFLOP/s) and is not redesigned yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using async_copy::load4;
using async_copy::to_f32;

constexpr int kItemCols = 64;   // small route: D columns per tile
constexpr int kCols = 64;       // tiled route: D columns per tile
constexpr int kThreads = 256;   // tiled route: threads per block
constexpr int kGroups = kThreads / kCols;   // tiled route: row groups
constexpr int kWarpsPerSm = 16;   // small route: resident warps per SM
constexpr int kMaxLeaves = 64;
constexpr int kSmallNodes = 128;            // W whole in shared memory

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
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

// One leaf of a grouped call: X [n, d], Y [m, d], the number of its first
// 64-column tile among all the call's tiles, and whether X's and Y's rows
// all start 16-byte aligned.
struct MixLeaf {
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
// to 0.  A tile's outputs do not depend on which block takes it.
template <typename T, bool kMasked, int kTy, int kUsed>
__global__ void __launch_bounds__(16 * kTy, kWarpsPerSm * 32 / (16 * kTy))
    mix_kernel(const void* __restrict__ wsrc, int w_staged,
               const __grid_constant__ MixTable table, int m, int n,
               int* __restrict__ sched) {
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
  // W (or E) is copied whole into the second slot when it fits there
  // (w_staged), ahead of the first tile, which then loads while W is
  // built; it is read from device memory otherwise.
  const unsigned char* wbytes = static_cast<const unsigned char*>(wsrc);
  if (w_staged) {
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
    int l = 0;
    while (l + 1 < table.count && table.leaf[l + 1].item0 <= item) ++l;
    const MixLeaf& lf = table.leaf[l];
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
  auto w_at = [&](int i, int j) {
    return kMasked ? (wbytes[i * n + j] ? 1.f : 0.f) + (i == j ? 1.f : 0.f)
                   : reinterpret_cast<const float*>(wbytes)[i * n + j];
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
    if (i0 >= m) continue;

    int l = 0;
    while (l + 1 < table.count && table.leaf[l + 1].item0 <= item) ++l;
    const MixLeaf& lf = table.leaf[l];
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

constexpr int kTileRows = 32;                  // output rows per tiled block
constexpr int kChunk = 32;                     // node-axis chunk
constexpr int kRowsPerThread = kTileRows / kGroups;

template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    mix_tiled_kernel(const void* __restrict__ wsrc, const T* __restrict__ x,
                     T* __restrict__ y, int m, int n, long long d,
                     long long col_tiles) {
  __shared__ float w_s[kTileRows][kChunk];
  __shared__ float x_s[kChunk][kCols];
  __shared__ float rowsum[kTileRows];
  const long long tile = blockIdx.x;
  const int i0 = (int)(tile / col_tiles) * kTileRows;
  const long long c0 = (tile % col_tiles) * kCols;
  const int c = threadIdx.x % kCols;
  const int g = threadIdx.x / kCols;  // a warp shares g: w_s reads broadcast
  const unsigned char* e = static_cast<const unsigned char*>(wsrc);
  const float* w = static_cast<const float*>(wsrc);

  if (kMasked) {
    // Row sums of E + I: small integers, exact in any order.
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int r = warp; r < kTileRows; r += kThreads / 32) {
      const int i = i0 + r;
      float s = 0.f;
      if (i < m)
        for (int j = lane; j < n; j += 32)
          s += (e[(long long)i * n + j] ? 1.f : 0.f) + (i == j ? 1.f : 0.f);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) rowsum[r] = s;
    }
  }

  float acc[kRowsPerThread];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) acc[t] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kChunk) {
    __syncthreads();  // the last chunk is consumed (and rowsum is ready)
    for (int idx = threadIdx.x; idx < kTileRows * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int jj = idx % kChunk;
      const int i = i0 + r;
      const int j = j0 + jj;
      float v = 0.f;
      if (i < m && j < n) {
        const long long at = (long long)i * n + j;
        v = kMasked ? ((e[at] ? 1.f : 0.f) + (i == j ? 1.f : 0.f)) / rowsum[r]
                    : w[at];
      }
      w_s[r][jj] = v;
    }
    for (int idx = threadIdx.x; idx < kChunk * kCols; idx += kThreads) {
      const int jj = idx / kCols;
      const int cc = idx % kCols;
      const int j = j0 + jj;
      const long long col = c0 + cc;
      x_s[jj][cc] =
          (j < n && col < d) ? to_f32(x[(long long)j * d + col]) : 0.f;
    }
    __syncthreads();
    const int jn = min(kChunk, n - j0);
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = g + t * kGroups;
      for (int jj = 0; jj < jn; ++jj)
        acc[t] = fmaf(w_s[r][jj], x_s[jj][c], acc[t]);
    }
  }
  const long long col = c0 + c;
  if (col >= d) return;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int i = i0 + g + t * kGroups;
    if (i < m) store(&y[(long long)i * d + col], acc[t]);
  }
}

// The small route's launch: persistent blocks, about kWarpsPerSm warps of
// them per SM (fewer where shared memory holds fewer), never more than the
// tiles.
template <typename T, bool kMasked, int kTy, int kUsed>
int launch_small(const void* w, const MixTable& table, int m, int n, int sms,
                 int* sched, cudaStream_t stream) {
  if (table.items == 0) return (int)cudaSuccess;
  constexpr int kBlock = 16 * kTy;
  constexpr size_t kSharedMax = 227 * 1024;   // an SM's shared memory
  const size_t slot_bytes = sizeof(T) * (size_t)n * kItemCols;
  const size_t smem = async_copy::kSmemAlign
                      + (sizeof(float) * (size_t)n * (8 * kTy + 4) + 127)
                            / 128 * 128
                      + 2 * slot_bytes;
  const size_t w_bytes = (size_t)m * n * (kMasked ? 1 : 4);
  const int w_staged = w_bytes <= slot_bytes
                       && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = mix_kernel<T, kMasked, kTy, kUsed>;
  static async_copy::KernelSetup setup;
  const cudaError_t err = async_copy::prepare(kernel, setup, smem);
  if (err != cudaSuccess) return (int)err;
  long long per_sm = kWarpsPerSm * 32 / kBlock;
  while (per_sm > 1 && per_sm * (smem + 1024) > kSharedMax) --per_sm;
  const long long slots = per_sm * sms;
  const long long blocks = table.items < slots ? table.items : slots;
  kernel<<<(unsigned)blocks, kBlock, smem, stream>>>(w, w_staged, table, m,
                                                     n, sched);
  return (int)cudaGetLastError();
}

// leaves: `count` rows of (X pointer, Y pointer, D, first tile) as int64.
template <typename T, bool kMasked>
int launch_mix(const void* w, const long long* leaves, int count, int m,
               int n, int sms, int* sched, cudaStream_t stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  if (m > kSmallNodes || n > kSmallNodes) {
    // The tiled route: one launch per leaf.
    for (int l = 0; l < count; ++l) {
      const long long* row = leaves + 4 * l;
      const long long d = row[2];
      const long long col_tiles = (d + kCols - 1) / kCols;
      const long long blocks = (long long)((m + kTileRows - 1) / kTileRows)
                               * col_tiles;
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
      if (blocks == 0) continue;
      mix_tiled_kernel<T, kMasked><<<(unsigned)blocks, kThreads, 0, stream>>>(
          w, reinterpret_cast<const T*>(row[0]), reinterpret_cast<T*>(row[1]),
          m, n, d, col_tiles);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  MixTable table;
  table.count = count;
  for (int l = 0; l < count; ++l) {
    const long long* row = leaves + 4 * l;
    MixLeaf& lf = table.leaf[l];
    lf.x = reinterpret_cast<const void*>(row[0]);
    lf.y = reinterpret_cast<void*>(row[1]);
    lf.d = row[2];
    lf.item0 = row[3];
    lf.aligned = (row[0] % 16 == 0) && (row[1] % 16 == 0)
                 && ((row[2] * (long long)sizeof(T)) % 16 == 0);
  }
  const MixLeaf& last = table.leaf[count - 1];
  table.items = last.item0 + (last.d + kItemCols - 1) / kItemCols;
  // Rows per thread: 8, or 7 where that covers m (m = 50 takes 8 x 7 rows,
  // not 8 x 8).
  if (m <= 56)
    return launch_small<T, kMasked, 8, 7>(w, table, m, n, sms, sched,
                                          stream);
  if (m <= 64)
    return launch_small<T, kMasked, 8, 8>(w, table, m, n, sms, sched,
                                          stream);
  if (m <= 112)
    return launch_small<T, kMasked, 16, 7>(w, table, m, n, sms, sched,
                                           stream);
  return launch_small<T, kMasked, 16, 8>(w, table, m, n, sms, sched,
                                         stream);
}

}  // namespace

// w: [m, n] f32; leaves: `count` rows of int64 (X [n, d] pointer, Y [m, d]
// pointer in X's type, d, index of the leaf's first 64-column tile among
// the call's tiles); sms: the device's SM count; sched: two int32 counters,
// 0 before the call and left 0 by it (the small route's tile scheduler).
extern "C" int graph_mix_f32(const void* w, const long long* leaves,
                             int count, int m, int n, int sms, void* sched,
                             void* stream) {
  return launch_mix<float, false>(w, leaves, count, m, n, sms,
                                  static_cast<int*>(sched),
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int graph_mix_bf16(const void* w, const long long* leaves,
                              int count, int m, int n, int sms, void* sched,
                              void* stream) {
  return launch_mix<__nv_bfloat16, false>(w, leaves, count, m, n, sms,
                                          static_cast<int*>(sched),
                                          static_cast<cudaStream_t>(stream));
}

// e: [n, n] bool (one byte each); leaves as above with m == n.
extern "C" int graph_mix_masked_f32(const void* e, const long long* leaves,
                                    int count, int n, int sms, void* sched,
                                    void* stream) {
  return launch_mix<float, true>(e, leaves, count, n, n, sms,
                                 static_cast<int*>(sched),
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int graph_mix_masked_bf16(const void* e, const long long* leaves,
                                     int count, int n, int sms, void* sched,
                                     void* stream) {
  return launch_mix<__nv_bfloat16, true>(e, leaves, count, n, n, sms,
                                         static_cast<int*>(sched),
                                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* graph_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
