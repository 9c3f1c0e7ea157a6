// Gram matrix G = X X^T of node-stacked parameters, for Eq. 3's per-layer
// cosine similarity (the epilogue g / (|x_i| |x_j|) is done by the caller,
// repro_torch.kernels.ops.pairwise_cosine).
//
// Replaces the TPU kernel repro/kernels/pairwise_cosine.py `gram_matrix`
// (pl.pallas_call at :50, body `_gram_kernel` at :30), which walks D as a
// sequential grid and carries the [n, n] sum in VMEM from step to step.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without tensor
// cores): at the main path's largest leaf, n = 50 and D = 51,200 (conv2),
// the call reads 10.25 MB (3.06 us), and since X X^T is symmetric the
// function needs only n (n + 1) D = 130.6 MFLOP (1.95 us), so it is bound
// by memory.  This kernel computes every tile, both triangles (2 n^2 D =
// 256 MFLOP, 3.8 us at full rate); every other leaf is a few KB and is
// launch-bound.
//
// Design.  Blocks cannot carry a sum from one to the next as the TPU grid
// does, so D is split ("split-K"): block (tx, ty, s) computes the 64 x 64
// output tile (ty, tx) over the s-th slice of D, staging 32-deep slices of
// the two row panels in shared memory and accumulating a 4 x 4 micro-tile
// per thread in f32 registers.  Each split writes its partial [n, n] sum to
// scratch, and a second kernel adds the partials in split order.  There are
// no float atomics, so the result is the same bits on every run: Morph
// multiplies the similarity by beta = 500 before its Gumbel top-k, and
// run-to-run noise there could change the chosen peers.  Inputs are read as
// f32 or bf16 and converted on the way into shared memory; the ragged
// tails of n and D are masked to zero, with no padding of the inputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output rows/cols per block
constexpr int kDepth = 32;     // D elements per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_partial(const T* __restrict__ x, float* __restrict__ part, int n,
                 long long d, long long split_len) {
  // a_s[k][r] = x[row0 + r, k0 + k]; the +1 keeps the transposed stores
  // free of bank conflicts.
  __shared__ float a_s[kDepth][kTile + 1];
  __shared__ float b_s[kDepth][kTile + 1];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const long long k_begin = (long long)blockIdx.z * split_len;
  const long long k_end = min(d, k_begin + split_len);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = k_begin; k0 < k_end; k0 += kDepth) {
    // Neighbouring threads read neighbouring D elements of one row.
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth;
      const int k = e % kDepth;
      const long long kk = k0 + k;
      const bool in_d = kk < k_end;
      const int ra = row0 + r;
      const int rb = col0 + r;
      a_s[k][r] = (in_d && ra < n) ? to_f32(x[(long long)ra * d + kk]) : 0.f;
      b_s[k][r] = (in_d && rb < n) ? to_f32(x[(long long)rb * d + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.z * n * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < n && c < n) out[(long long)r * n + c] = acc[i][j];
    }
  }
}

// out[i] = sum over splits of part[s][i], always in split order.
__global__ void gram_reduce(const float* __restrict__ part,
                            float* __restrict__ out, int nn, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[(long long)p * nn + i];
  out[i] = s;
}

template <typename T>
int launch_gram(const void* x, float* out, float* scratch, int n, long long d,
                long long split_len, int splits, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  float* part = splits == 1 ? out : scratch;
  gram_partial<T><<<dim3(tiles, tiles, splits), kThreads, 0, stream>>>(
      static_cast<const T*>(x), part, n, d, split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int nn = n * n;
  gram_reduce<<<(nn + 255) / 256, 256, 0, stream>>>(scratch, out, nn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, d] row-major; out: [n, n] f32; scratch: [splits, n, n] f32 (unused
// when splits == 1).  Returns the cudaError_t of the launches.
extern "C" int gram_f32(const void* x, void* out, void* scratch, int n,
                        long long d, long long split_len, int splits,
                        void* stream) {
  return launch_gram<float>(x, static_cast<float*>(out),
                            static_cast<float*>(scratch), n, d, split_len,
                            splits, static_cast<cudaStream_t>(stream));
}

extern "C" int gram_bf16(const void* x, void* out, void* scratch, int n,
                         long long d, long long split_len, int splits,
                         void* stream) {
  return launch_gram<__nv_bfloat16>(x, static_cast<float*>(out),
                                    static_cast<float*>(scratch), n, d,
                                    split_len, splits,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* pairwise_cosine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
