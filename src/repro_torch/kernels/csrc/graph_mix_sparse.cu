// k-sparse graph mixing from CSR slots (DESIGN.md §11):
//   out[i] = sum_s w[i, s] x[idx[i, s]] + w_self[i] x[self0 + i]
// over node-stacked flattened parameters X [m, D] for n receivers, Y [n, D],
// O(n k D) instead of the dense mix's O(n^2 D), for every leaf of a
// parameter dict in one launch.  One device's layout is self0 = 0 and
// m = n; a sharded engine's receiver block over the gathered population
// takes self0 = its first row, and its push partials (every receiver's sum
// over one rank's senders) take no self term (self0 < 0).
//
// Replaces the TPU kernel `graph_mix_sparse` in
// repro/kernels/graph_mix_sparse.py (:60, pl.pallas_call at :78, body
// `_make_kernel` :33).  That kernel DMAs each of a block's block_n (k + 1)
// gathered row tiles into VMEM one copy at a time and reduces them there.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32): at n = 1000, k = 3
// and D = 51,200 (conv2, the largest GN-LeNet leaf) the least the card must
// move is X once and Y once, 409.6 MB (0.122 ms); the 2 (k + 1) n D =
// 409.6 MFLOP take 0.006 ms, so the call is bound by memory.
//
// What held the first design back (one block per 4 receivers x 256
// columns of one leaf, H100 80GB HBM3 at 700 W: 0.440 ms at that shape,
// 1.35x torch.sparse.mm): its blocks were numbered receiver-group-major,
// so every column tile of receivers 0-3 ran before those of receivers 4-7,
// and a gathered row segment had left L2 by the time the next receiver
// that named it ran: the kernel moved (k + 2) n D elements against the
// bound's 2 n D.  Its loads were 4-byte scalars, one column a thread, and
// it launched once per leaf: ten launches a round.
//
// Design.  A work item is one warp's: 4 receivers x one stripe of 512
// bytes of columns (128 f32 or 256 bf16), each lane 16 bytes of it.  The
// items are numbered leaf after leaf and, inside a leaf, stripe after
// stripe, every receiver group of a stripe before the next stripe; a
// table in the kernel's parameters gives each leaf's X, Y, D and first
// item.  Persistent blocks, two of 256 threads to an SM, take the items
// warp by warp in turn (every 16 x 132-th), so the warps working at one
// time cover a few stripes of n x 512 bytes, which stay in the 50 MB L2
// while every receiver that names one of their rows reads it: X comes from
// device memory about once.  A warp holds the slots of its 4 receivers 32
// at a time, one per lane, and passes each slot's index and weight round
// by shuffle (any k: compat mode runs k = n - 1), then issues the 16-byte
// loads of two slots of all 4 receivers at once before it adds them up.
// Where a leaf's rows are not 16-byte aligned (D = 10 in f32) a lane loads
// its columns one by one.  Each output element is summed by one thread in
// a fixed order, slots in slot order and then the self term, as
// `wfull = [w, w_self]` orders them in the Pallas body, with a separately
// rounded multiply and add (no FMA contraction), so the result is the bits
// of the plain PyTorch version whatever the other leaves of the call, and
// the same on every run: no atomics, no cross-thread reduction.  The
// ragged D tail is masked; nothing is padded.  Four receivers a warp, two
// blocks an SM and two slots a step were the fastest of the twelve
// combinations of 2, 4 or 8 receivers, 2 or 4 blocks and 2 or 4 slots
// timed on the card; more blocks or slots spill registers.
//
// What holds it back (chip_smoke.py phase 3, device time in a CUDA graph,
// H100 80GB HBM3 at 700 W; PERF.md has the numbers): about 0.19 ms at
// n = 1000, k = 3, conv2, some 65% of its bound and 1.8x faster than
// torch.sparse.mm.  Every gathered row still crosses from L2 to the SM
// once per receiver that names it, (k + 1) n D elements (820 MB here), so
// L2's bandwidth, not device memory's, is what it meets first; keeping a
// stripe's rows in shared memory would take that away where n x a stripe
// fits there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 8 warps a block
constexpr int kBlocksPerSm = 2;    // persistent blocks per SM
constexpr int kRecv = 4;           // receivers per item
constexpr int kUnroll = 2;         // slots whose loads are issued together
constexpr int kLanes = 32;
constexpr int kMaxLeaves = 64;
constexpr unsigned kFull = 0xffffffffu;

// One leaf of a grouped call: X [m, d], Y [n, d], the number of its first
// item among all the call's items, and whether X's and Y's rows all start
// 16-byte aligned.
struct SparseLeaf {
  const void* x;
  void* y;
  long long d;
  long long item0;
  int aligned;
};

struct SparseTable {
  SparseLeaf leaf[kMaxLeaves];
  int count;
  long long items;
};

// 16 bytes of T as f32: 4 f32 or 8 bf16.
template <typename T>
struct Lane {
  static constexpr int kWidth = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // Round to nearest even, as torch's .to().
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    words[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc += w * v element by element, the product rounded before the add.
template <int kW>
__device__ __forceinline__ void add_product(float (&acc)[kW], float w,
                                            const float (&v)[kW]) {
#pragma unroll
  for (int c = 0; c < kW; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v[c]));
}

// The lane's columns col .. col + kW - 1 of row `row`, one load of 16
// bytes (aligned leaves), or one by one inside D (zero past it).
template <typename T, int kW>
__device__ __forceinline__ void load_row(const T* x, long long d, int row,
                                         long long col, bool aligned,
                                         float (&v)[kW]) {
  const T* p = x + (long long)row * d + col;
  if (aligned) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
    return;
  }
#pragma unroll
  for (int c = 0; c < kW; ++c) v[c] = col + c < d ? to_f32(p[c]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    sparse_mix_kernel(const int* __restrict__ idx,
                      const float* __restrict__ w,
                      const float* __restrict__ w_self,
                      const __grid_constant__ SparseTable table, int n,
                      int k, int self0) {
  constexpr int kW = Lane<T>::kWidth;
  constexpr int kStripe = kLanes * kW;
  const int lane = threadIdx.x % kLanes;
  const long long warps = (long long)gridDim.x * (kThreads / kLanes);
  const long long groups = (n + kRecv - 1) / kRecv;
  for (long long item = (long long)blockIdx.x * (kThreads / kLanes)
                        + threadIdx.x / kLanes;
       item < table.items; item += warps) {
    int l = 0;
    while (l + 1 < table.count && table.leaf[l + 1].item0 <= item) ++l;
    const SparseLeaf& lf = table.leaf[l];
    const T* x = static_cast<const T*>(lf.x);
    const long long d = lf.d;
    const long long local = item - lf.item0;
    const long long col = local / groups * kStripe + lane * kW;
    const int r0 = (int)(local % groups) * kRecv;
    const bool live = col < d;              // the lane has columns in D
    const bool aligned = lf.aligned != 0;   // the same for the whole warp
    int rows[kRecv];                        // past n: repeats, not stored
#pragma unroll
    for (int q = 0; q < kRecv; ++q) rows[q] = min(r0 + q, n - 1);

    float acc[kRecv][kW];
#pragma unroll
    for (int q = 0; q < kRecv; ++q)
#pragma unroll
      for (int c = 0; c < kW; ++c) acc[q][c] = 0.f;

    for (int s0 = 0; s0 < k; s0 += kLanes) {
      // Lane t holds slot s0 + t of each receiver.
      const bool has = s0 + lane < k;
      int slot_idx[kRecv];
      float slot_w[kRecv];
#pragma unroll
      for (int q = 0; q < kRecv; ++q) {
        const long long at = (long long)rows[q] * k + s0 + lane;
        slot_idx[q] = has ? __ldg(idx + at) : 0;
        slot_w[q] = has ? __ldg(w + at) : 0.f;
      }
      const int span = min(kLanes, k - s0);
      if (aligned) {
        for (int s = 0; s < span; s += kUnroll) {
          // The 16-byte loads of kUnroll slots of every receiver first,
          // then their products and sums in slot order.
          uint4 raw[kUnroll][kRecv];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int q = 0; q < kRecv; ++q) {
              const int j = __shfl_sync(kFull, slot_idx[q], (s + u) % kLanes);
              if (live && s + u < span)
                raw[u][q] = __ldg(reinterpret_cast<const uint4*>(
                    x + (long long)j * d + col));
            }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int q = 0; q < kRecv; ++q) {
              const float ws = __shfl_sync(kFull, slot_w[q],
                                           (s + u) % kLanes);
              if (s + u < span) {
                float v[kW];
                unpack(raw[u][q], v);
                add_product<kW>(acc[q], ws, v);
              }
            }
        }
      } else {
        for (int s = 0; s < span; ++s)
#pragma unroll
          for (int q = 0; q < kRecv; ++q) {
            const int j = __shfl_sync(kFull, slot_idx[q], s);
            const float ws = __shfl_sync(kFull, slot_w[q], s);
            float v[kW];
            load_row<T, kW>(x, d, j, col, false, v);
            add_product<kW>(acc[q], ws, v);
          }
      }
    }
    // The self term last (receiver r's own row is self0 + r; none for
    // self0 < 0), then the stores.
    if (self0 >= 0) {
#pragma unroll
      for (int q = 0; q < kRecv; ++q) {
        float own[kW];
        if (live) load_row<T, kW>(x, d, self0 + rows[q], col, aligned, own);
        add_product<kW>(acc[q], __ldg(w_self + rows[q]), own);
      }
    }
    if (!live) continue;
    T* y = static_cast<T*>(lf.y);
#pragma unroll
    for (int q = 0; q < kRecv; ++q) {
      if (r0 + q >= n) break;
      T* p = y + (long long)(r0 + q) * d + col;
      if (aligned) {
        *reinterpret_cast<uint4*>(p) = pack(acc[q]);
      } else {
#pragma unroll
        for (int c = 0; c < kW; ++c)
          if (col + c < d) store(p + c, acc[q][c]);
      }
    }
  }
}

// leaves: `count` rows of (X pointer, Y pointer, D, first item) as int64.
template <typename T>
int launch(const void* idx, const void* w, const void* w_self,
           const long long* leaves, int count, int n, int k, int self0,
           int sms, cudaStream_t stream) {
  if (count < 1 || count > kMaxLeaves || n < 1 || k < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int kStripe = kLanes * Lane<T>::kWidth;
  SparseTable table;
  table.count = count;
  for (int l = 0; l < count; ++l) {
    const long long* row = leaves + 4 * l;
    SparseLeaf& lf = table.leaf[l];
    lf.x = reinterpret_cast<const void*>(row[0]);
    lf.y = reinterpret_cast<void*>(row[1]);
    lf.d = row[2];
    lf.item0 = row[3];
    lf.aligned = (row[0] % 16 == 0) && (row[1] % 16 == 0)
                 && ((row[2] * (long long)sizeof(T)) % 16 == 0);
  }
  const SparseLeaf& last = table.leaf[count - 1];
  table.items = last.item0 + (n + kRecv - 1) / kRecv
                                 * ((last.d + kStripe - 1) / kStripe);
  if (table.items == 0) return (int)cudaSuccess;
  const long long slots = (long long)kBlocksPerSm * sms;
  const long long needed = (table.items + kThreads / kLanes - 1)
                           / (kThreads / kLanes);
  const long long blocks = needed < slots ? needed : slots;
  sparse_mix_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(w_self), table, n, k, self0);
  return (int)cudaGetLastError();
}

}  // namespace

// idx: [n, k] int32 in [0, m); w: [n, k] f32; w_self: [n] f32 (not read
// for self0 < 0); leaves: `count` rows of int64 (X [m, d] pointer, Y [n, d]
// pointer in X's type, d, index of the leaf's first item among the call's
// items, from graph_mix_sparse.py's plan_sparse); self0: receiver 0's own
// row of X, with self0 + n <= m (negative: no self term); sms: the
// device's SM count.  Invalid slots must already point at a row of X with
// weight 0 (the wrapper in ops.mix_sparse parks them on the own row).
extern "C" int graph_mix_sparse_f32(const void* idx, const void* w,
                                    const void* w_self,
                                    const long long* leaves, int count, int n,
                                    int k, int self0, int sms, void* stream) {
  return launch<float>(idx, w, w_self, leaves, count, n, k, self0, sms,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int graph_mix_sparse_bf16(const void* idx, const void* w,
                                     const void* w_self,
                                     const long long* leaves, int count,
                                     int n, int k, int self0, int sms,
                                     void* stream) {
  return launch<__nv_bfloat16>(idx, w, w_self, leaves, count, n, k, self0,
                               sms, static_cast<cudaStream_t>(stream));
}

extern "C" const char* graph_mix_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
