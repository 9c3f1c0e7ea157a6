// Fused Mamba (S6) selective scan, the recurrence of every Mamba layer of a
// prefill (models/mamba.py apply_mamba):
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t,   y_t = sum_s h_t[s] c_t[s]
// per (batch, channel), with h [d_state] carried across all L steps.  The
// D x skip term is added by the caller.
//
// Replaces the TPU kernel `selective_scan` in
// repro/kernels/selective_scan.py (pl.pallas_call at :75, body
// `_scan_kernel` :32).  That kernel runs one program per (batch, d_inner
// block), keeps h [blk, d_state] in VMEM and walks L with a fori_loop;
// the reference model itself takes lax.associative_scan in 64-step chunks
// (models/mamba.py `_chunk_scan`) instead, which computes the same y.
//
// Bound on an H100 SXM at the served shape (batch 2, L 2048, d_inner
// 16,384, d_state 16; x bf16, dt f32): the least the card must move is x,
// dt, b, c, a and h0 once and y and h once, about 0.68 GB (0.20 ms at 3.35
// TB/s); the batch L d_inner d_state = 1.07 G exponentials take 0.26 ms at
// 16 special-function results per clock per SM (132 SMs, 1.98 GHz); the
// about 6 f32 operations per (t, channel, state) 0.10 ms at 67 TFLOP/s.
// The exponentials set the bound.
//
// Design.  One thread owns one (batch, channel) and keeps h [DS] and
// a [DS] in registers.  A block of kThreads channels of one batch row
// stages kSteps time steps of x and dt ([kSteps][kThreads], each thread
// loading its own column, so every step's load is one coalesced row) and
// of b and c ([kSteps][DS], shared by the whole block) in shared memory,
// converted to f32, then walks them; y is stored per step, again one
// coalesced row.  The ragged d_inner tail is masked, nothing is padded,
// and any L >= 1 is taken.  Each product is rounded before its add
// (__fmul_rn / __fadd_rn, so nvcc cannot contract them into FMAs) and y
// sums the states in state order, as the plain PyTorch version
// (kernels/ref.py selective_scan) does; `expf` is the accurate one.  Only
// batch x d_inner threads exist (32,768 at the served shape, about eight
// warps per SM), so the kernel is latency-bound, not at its bound; giving
// each channel several threads is later work.
//
// Types.  x, dt, b and c are each f32 or bf16, as the Pallas kernel takes
// them.  apply_mamba passes dt in f32 (after the softplus); the bf16 dt
// instantiations are kept on purpose, for callers that hold dt in bf16 (the
// training slice may), and the all-bf16 cases of chip_smoke.py phase 3 and
// tests/test_torch_cuda.py hold them to the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per block, one per thread
constexpr int kSteps = 32;      // time steps staged per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int DS, typename TX, typename TDT, typename TBC>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const TX* __restrict__ x, const TDT* __restrict__ dt,
                const TBC* __restrict__ b, const TBC* __restrict__ c,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int L,
                int di, int chan_tiles) {
  __shared__ float xs[kSteps][kThreads];
  __shared__ float dts[kSteps][kThreads];
  __shared__ float bs[kSteps][DS];
  __shared__ float cs[kSteps][DS];

  const int batch = blockIdx.x / chan_tiles;
  const int tid = threadIdx.x;
  const int ch = (blockIdx.x % chan_tiles) * kThreads + tid;
  const bool active = ch < di;
  const long long row0 = (long long)batch * L;      // first row of x, dt, y

  float av[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    av[s] = active ? a[(long long)ch * DS + s] : 0.f;
    h[s] = active ? h0[((long long)batch * di + ch) * DS + s] : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kSteps) {
    const int n = min(kSteps, L - t0);
    if (active) {
      for (int i = 0; i < n; ++i) {
        const long long at = (row0 + t0 + i) * di + ch;
        xs[i][tid] = to_f32(x[at]);
        dts[i][tid] = to_f32(dt[at]);
      }
    }
    for (int j = tid; j < n * DS; j += kThreads) {
      const long long at = (row0 + t0) * DS + j;
      bs[j / DS][j % DS] = to_f32(b[at]);
      cs[j / DS][j % DS] = to_f32(c[at]);
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < n; ++i) {
        const float dv = dts[i][tid];
        const float dbx = __fmul_rn(dv, xs[i][tid]);
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          const float da = expf(__fmul_rn(dv, av[s]));
          h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(dbx, bs[i][s]));
          const float hc = __fmul_rn(h[s], cs[i][s]);
          acc = s == 0 ? hc : __fadd_rn(acc, hc);
        }
        y[(row0 + t0 + i) * di + ch] = acc;
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < DS; ++s)
      h_out[((long long)batch * di + ch) * DS + s] = h[s];
  }
}

template <int DS, typename TX, typename TDT, typename TBC>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* h0, void* y, void* h_out, int batch,
           int L, int di, cudaStream_t stream) {
  const int chan_tiles = (di + kThreads - 1) / kThreads;
  const long long blocks = (long long)batch * chan_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  scan_kernel<DS, TX, TDT, TBC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TDT*>(dt),
      static_cast<const TBC*>(b), static_cast<const TBC*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), L, di, chan_tiles);
  return (int)cudaGetLastError();
}

template <int DS, typename TX, typename TDT>
int by_bc(bool bc_bf16, const void* x, const void* dt, const void* b,
          const void* c, const void* a, const void* h0, void* y, void* h_out,
          int batch, int L, int di, cudaStream_t stream) {
  return bc_bf16 ? launch<DS, TX, TDT, __nv_bfloat16>(x, dt, b, c, a, h0, y,
                                                      h_out, batch, L, di,
                                                      stream)
                 : launch<DS, TX, TDT, float>(x, dt, b, c, a, h0, y, h_out,
                                              batch, L, di, stream);
}

template <int DS, typename TX>
int by_dt(bool dt_bf16, bool bc_bf16, const void* x, const void* dt,
          const void* b, const void* c, const void* a, const void* h0,
          void* y, void* h_out, int batch, int L, int di,
          cudaStream_t stream) {
  return dt_bf16 ? by_bc<DS, TX, __nv_bfloat16>(bc_bf16, x, dt, b, c, a, h0,
                                                y, h_out, batch, L, di,
                                                stream)
                 : by_bc<DS, TX, float>(bc_bf16, x, dt, b, c, a, h0, y, h_out,
                                        batch, L, di, stream);
}

template <int DS>
int by_x(bool x_bf16, bool dt_bf16, bool bc_bf16, const void* x,
         const void* dt, const void* b, const void* c, const void* a,
         const void* h0, void* y, void* h_out, int batch, int L, int di,
         cudaStream_t stream) {
  return x_bf16 ? by_dt<DS, __nv_bfloat16>(dt_bf16, bc_bf16, x, dt, b, c, a,
                                           h0, y, h_out, batch, L, di, stream)
                : by_dt<DS, float>(dt_bf16, bc_bf16, x, dt, b, c, a, h0, y,
                                   h_out, batch, L, di, stream);
}

}  // namespace

// x, dt: [batch, L, di]; b, c: [batch, L, ds] (each f32, or bf16 where its
// flag is set; b and c share a type); a: [di, ds] f32; h0: [batch, di, ds]
// f32 -> y: [batch, L, di] f32, h_out: [batch, di, ds] f32.  ds is 4, 8 or
// 16; L >= 1.  Returns a cudaError_t.
extern "C" int selective_scan(const void* x, const void* dt, const void* b,
                              const void* c, const void* a, const void* h0,
                              void* y, void* h_out, int batch, int L, int di,
                              int ds, int x_bf16, int dt_bf16, int bc_bf16,
                              void* stream) {
  if (batch < 1 || L < 1 || di < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 4:
      return by_x<4>(x_bf16, dt_bf16, bc_bf16, x, dt, b, c, a, h0, y, h_out,
                     batch, L, di, st);
    case 8:
      return by_x<8>(x_bf16, dt_bf16, bc_bf16, x, dt, b, c, a, h0, y, h_out,
                     batch, L, di, st);
    case 16:
      return by_x<16>(x_bf16, dt_bf16, bc_bf16, x, dt, b, c, a, h0, y, h_out,
                      batch, L, di, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* selective_scan_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
