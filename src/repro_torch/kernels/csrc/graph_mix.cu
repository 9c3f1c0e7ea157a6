// Node-axis graph mixing Y = W X over node-stacked flattened parameters
// (Alg. 2 line 12 for every node at once).
//
// Replaces the TPU kernels in repro/kernels/graph_mix.py:
//   * `graph_mix`        (pl.pallas_call at :44, body `_mix_kernel` :22):
//     W [m, n] given as f32, m != n allowed;
//   * `graph_mix_masked` (pl.pallas_call at :77, body `_masked_kernel` :55):
//     W = (E + I) / rowsum built inside the kernel from the bool in-edge
//     matrix E [n, n], the uniform averaging of Morph and Epidemic
//     Learning; a row with no in-edges keeps its own model.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without tensor
// cores): at n = m = 50 and D = 51,200 (conv2, the largest main-path leaf)
// the call moves 20.5 MB (X read once, Y written once: 6.1 us) and does
// 2 m n D = 256 MFLOP (3.8 us), so it is bound by memory.
//
// Design.  W is tiny and every output column needs all of it.  Up to 128
// nodes (the paper's n = 50 and 100) each block keeps the whole of W in
// shared memory (at most 64 KB) and owns one 64-column tile of D: it
// stages X[:, tile] in shared memory once (neighbouring threads read
// neighbouring columns, so every row is one coalesced 256-byte read), and
// each thread then forms the dot products of its column with a quarter of
// W's rows in f32.  X is read from device memory exactly once and Y
// written exactly once, which is all the bound asks.  The masked variant
// loads E instead of W and normalises the rows in shared memory, so W
// never exists in device memory.  The ragged D tail is masked; nothing is
// padded.
//
// Past 128 nodes or rows W no longer fits, and a second route tiles both
// axes: each block owns 32 output rows x 64 columns and walks the node
// axis in chunks of 32, staging W[rows, chunk] and X[chunk, cols] in
// shared memory and keeping its 8 sums per thread in registers.  Each sum
// takes the same fmaf sequence over j = 0 .. n - 1 as the first route, so
// the two routes give the same bits; the masked rows are divided by the
// same exact integer row sums.  X is read once per 32-row tile (ceil(m /
// 32) times in all), which is the price of any n; a faster kernel for
// large n is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;      // D columns per block
constexpr int kThreads = 256;  // kCols columns x 4 row groups
constexpr int kGroups = kThreads / kCols;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Shared memory: w_s [m][n] f32, then x_s [n][kCols] f32.
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const void* __restrict__ wsrc, const T* __restrict__ x,
               T* __restrict__ y, int m, int n, long long d) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* x_s = smem + m * n;
  const long long c0 = (long long)blockIdx.x * kCols;

  if (kMasked) {
    // W = E + I, then each row divided by its sum (m == n).
    const unsigned char* e = static_cast<const unsigned char*>(wsrc);
    for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
      const int i = idx / n;
      const int j = idx % n;
      w_s[idx] = (e[idx] ? 1.f : 0.f) + (i == j ? 1.f : 0.f);
    }
    __syncthreads();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int i = warp; i < n; i += kThreads / 32) {
      float s = 0.f;
      for (int j = lane; j < n; j += 32) s += w_s[i * n + j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      for (int j = lane; j < n; j += 32) w_s[i * n + j] = w_s[i * n + j] / s;
    }
  } else {
    const float* w = static_cast<const float*>(wsrc);
    for (int idx = threadIdx.x; idx < m * n; idx += kThreads) w_s[idx] = w[idx];
  }
  for (int idx = threadIdx.x; idx < n * kCols; idx += kThreads) {
    const int r = idx / kCols;
    const int c = idx % kCols;
    const long long col = c0 + c;
    x_s[idx] = col < d ? to_f32(x[(long long)r * d + col]) : 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x % kCols;
  const long long col = c0 + c;
  if (col >= d) return;
  // All threads of a warp share the row i, so w_s reads are broadcasts.
  for (int i = threadIdx.x / kCols; i < m; i += kGroups) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(w_s[i * n + j], x_s[j * kCols + c], acc);
    store(&y[(long long)i * d + col], acc);
  }
}

constexpr int kTileRows = 32;                  // output rows per tiled block
constexpr int kChunk = 32;                     // node-axis chunk
constexpr int kRowsPerThread = kTileRows / kGroups;
constexpr int kSmallNodes = 128;               // W whole in shared memory

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

template <typename T, bool kMasked>
int launch_mix(const void* w, const void* x, void* y, int m, int n,
               long long d, cudaStream_t stream) {
  const long long col_tiles = (d + kCols - 1) / kCols;
  if (m > kSmallNodes || n > kSmallNodes) {
    const long long blocks = (long long)((m + kTileRows - 1) / kTileRows)
                             * col_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    mix_tiled_kernel<T, kMasked><<<(unsigned)blocks, kThreads, 0, stream>>>(
        w, static_cast<const T*>(x), static_cast<T*>(y), m, n, d, col_tiles);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * ((size_t)m * n + (size_t)n * kCols);
  auto kernel = mix_kernel<T, kMasked>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)col_tiles, kThreads, smem, stream>>>(
      w, static_cast<const T*>(x), static_cast<T*>(y), m, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// w: [m, n] f32; x: [n, d]; y: [m, d] in x's type.
extern "C" int graph_mix_f32(const void* w, const void* x, void* y, int m,
                             int n, long long d, void* stream) {
  return launch_mix<float, false>(w, x, y, m, n, d,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int graph_mix_bf16(const void* w, const void* x, void* y, int m,
                              int n, long long d, void* stream) {
  return launch_mix<__nv_bfloat16, false>(w, x, y, m, n, d,
                                          static_cast<cudaStream_t>(stream));
}

// e: [n, n] bool (one byte each); x: [n, d]; y: [n, d] in x's type.
extern "C" int graph_mix_masked_f32(const void* e, const void* x, void* y,
                                    int n, long long d, void* stream) {
  return launch_mix<float, true>(e, x, y, n, n, d,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int graph_mix_masked_bf16(const void* e, const void* x, void* y,
                                     int n, long long d, void* stream) {
  return launch_mix<__nv_bfloat16, true>(e, x, y, n, n, d,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* graph_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
