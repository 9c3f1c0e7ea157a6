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
// 16,384, d_state 16; x, b, c bf16, dt f32), with E = batch L d_inner
// d_state = 1.07 G (t, channel, state) elements, 132 SMs at 1.98 GHz,
// counted from what the function needs with its bits, not from this
// kernel's code:
// - bytes: x, dt, b, c, a and h0 read once, y and h written once, about
//   0.68 GB: 0.20 ms at 3.35 TB/s;
// - the special-function unit: one MUFU.EX2 per element (the accurate
//   `expf`) at 16 a clock per SM: 0.26 ms;
// - the FP32 pipe: the products and sums are deliberately unfused
//   (__fmul_rn / __fadd_rn), so each takes a whole lane slot, 128 a clock
//   per SM (33.5 T a second; the 67 T of the data sheet counts an FMA as
//   two operations).  Per element: dt a, da h, (dt x) b, their sum, h c and
//   its add into y are 6 (dt x once a channel and the sum over the states
//   one add short cancel), and `expf` issues 6 more around its MUFU.EX2 (4
//   FFMA, an FADD, an FMUL): 12, 0.385 ms;
// - issue: every instruction takes a warp-issue slot, one a clock per
//   scheduler, 4 per SM; the 12 FP32 instructions and the MUFU.EX2 are 13
//   an element: 0.417 ms, the bound.
// The inner step of the served instantiation (nvcc 12.8, sm_90a) issues
// 15.77 instructions an element, 12.125 of them FFMA, FADD or FMUL (dt x
// once a lane, not once a channel), the rest the exponent shift, the
// shared-memory loads, bf16 conversion, address work, the shuffle and the
// store.  chip_smoke.py prices the four parts above from the function's
// counts (SCAN_FP32_PER_ELEMENT, SCAN_MUFU_PER_ELEMENT) and reports the
// kernel's own instructions (`scan_sass`, read from the built library) as
// `kernel_issue_ms`, beside the bound and not in it.
//
// Design.
// - Several lanes per channel.  A channel's states are split over G lanes
//   of 8 states each (G = 2 at d_state 16; one lane of 8 or 4 states at 8
//   and 4), h and a in registers, h0 and h moved as 16-byte vectors.  The
//   served shape runs 65,536 threads: 256 blocks of 128 channels x 2
//   lanes, two blocks an SM, one wave, up to 128 registers a thread.  Four
//   lanes of 4 states would double the threads, but one wave of them
//   allows 64 registers a thread, where ptxas spilled; with the extra
//   shuffle and loads per state it was slower on the card.
// - Loads overlapped with compute.  A block walks L in tiles of kSteps
//   steps through a ring of kStages tiles in shared memory.  x and dt
//   ([kSteps][channels]) and b and c ([kSteps][d_state], shared by every
//   channel of the block) are filled by cp.async, 16 bytes a copy where
//   the rows are 16-byte aligned, else 4 bytes (f32) or a plain load
//   (bf16); the ragged d_inner tail is zero-filled and nothing is padded
//   in device memory.  While tile t computes, tile t + 1 has landed and
//   tile t + 2 is in flight: one barrier a tile.  x and dt stay in their
//   own type and are converted when a step reads them; b and c in bf16
//   are converted once per tile into an f32 copy (every channel of the
//   block reads the same values), one tile ahead.  The full tiles' step
//   loop is unrolled 8 steps deep (all 32, 64 KB of code a block, ran
//   slower: instruction fetch); a last partial tile runs apart.
// - One summation order for y, shared with the plain version
//   (kernels/ref.py selective_scan): each group of 4 consecutive states
//   sums its h c in state order (p_q), then the groups combine pairwise,
//   (p0 + p1) + (p2 + p3) at d_state 16, p0 + p1 at 8, p0 at 4: inside a
//   lane for the groups it holds, then by __shfl_xor_sync across the
//   channel's lanes.  Float addition is commutative, so both lanes end
//   with the same bits; the first stores y with one predicated store, so
//   a warp's stores of a step are one row of consecutive channels.
// - Bits.  Each product is rounded before its add (__fmul_rn /
//   __fadd_rn, so nvcc cannot contract them into FMAs) and `expf` is the
//   accurate one, so h does not depend on how the states are split over
//   lanes, and y differs from the plain version only where their `exp`
//   does.
//
// - States kept for the backward.  Given h_tiles, the kernel also stores h
//   as each 8-step window starts ([batch, ceil(L / 8), di, ds] f32: 537 MB
//   at the served shape), one 16-byte store per lane every 8 steps, which
//   the full tiles' 8-step unrolled bodies start with; the backward
//   (selective_scan_bwd.cu) recomputes each window from it once.  Serving
//   passes null and stores nothing.
//
// Types.  x, dt, b and c are each f32 or bf16, as the Pallas kernel takes
// them.  apply_mamba passes dt in f32 (after the softplus); the bf16 dt
// instantiations are kept on purpose, for callers that hold dt in bf16 (the
// training slice may), and the all-bf16 cases of chip_smoke.py phase 3 and
// tests/test_torch_cuda.py hold them to the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using async_copy::to_f32;

constexpr int kThreads = 256;   // threads per block
constexpr int kSteps = 32;      // time steps per tile
constexpr int kStages = 3;      // tiles in the shared-memory ring
static_assert(kStages >= 3, "tile t + 1 lands while tile t computes");
constexpr int kKeep = 8;        // steps unrolled in a full tile; h_tiles
                                // keeps h every kKeep steps
static_assert(kSteps % kKeep == 0, "whole windows in a full tile");

// Lanes per channel at d_state DS: 8 states each where DS allows.
template <int DS>
constexpr int lanes() { return DS >= 16 ? DS / 8 : 1; }
// Blocks an SM must hold: 512 threads, so up to 128 registers a thread.
constexpr int kMinBlocks = 512 / kThreads;

struct Args {
  const void* x;      // [batch, L, di]
  const void* dt;     // [batch, L, di]
  const void* b;      // [batch, L, ds]
  const void* c;      // [batch, L, ds]
  const float* a;     // [di, ds]
  const float* h0;    // [batch, di, ds]
  float* y;           // [batch, L, di]
  float* h_out;       // [batch, di, ds]
  float* h_tiles;     // [batch, ceil(L / kKeep), di, ds] or null
  int L, di, chan_tiles;
  int x_vec, dt_vec;  // rows of x / dt are 16-byte aligned
};

// Shared-memory layout of one block: kStages raw tiles of x, dt, b and c,
// then (b and c in bf16) two f32 copies of b and c.
template <int DS, int G, typename TX, typename TDT, typename TBC>
struct Layout {
  static constexpr int kChannels = kThreads / G;
  static constexpr size_t kX = sizeof(TX) * kSteps * kChannels;
  static constexpr size_t kDt = sizeof(TDT) * kSteps * kChannels;
  static constexpr size_t kBc = sizeof(TBC) * kSteps * DS;
  static constexpr size_t kStage = kX + kDt + 2 * kBc;
  static constexpr bool kConvert = sizeof(TBC) != sizeof(float);
  static constexpr size_t kBcF32 = sizeof(float) * kSteps * DS;
  static constexpr size_t kBytes =
      kStages * kStage + (kConvert ? 2 * 2 * kBcF32 : 0);
  static_assert(kX % 16 == 0 && kDt % 16 == 0 && kBc % 16 == 0,
                "16-byte aligned arrays");
};

__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         const float* base, bool valid) {
  async_copy::copy4(dst, valid ? src : base, valid ? 4 : 0);
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         const __nv_bfloat16*, bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}

// Rows [0, n) of a [*, di] slab from `src` (its row 0 at the block's first
// channel) into dst [kSteps][CH]: `width` channels are real, the rest of
// each row is zero.
template <int CH, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int di,
                                           int n, int width, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);
    constexpr int kChunks = CH / kPer;
    for (int j = threadIdx.x; j < n * kChunks; j += kThreads) {
      const int r = j / kChunks, col = (j % kChunks) * kPer;
      const int valid = max(0, min(kPer, width - col)) * (int)sizeof(T);
      async_copy::copy16(dst + r * CH + col,
                         valid ? src + (long long)r * di + col : src, valid);
    }
  } else {
    for (int j = threadIdx.x; j < n * CH; j += kThreads) {
      const int r = j / CH, col = j % CH;
      copy_one(dst + j, src + (long long)r * di + col, src, col < width);
    }
  }
}

// `count` consecutive elements from `src` into dst.
template <typename T>
__device__ __forceinline__ void stage_flat(T* dst, const T* src,
                                           int count) {
  constexpr int kPer = 16 / (int)sizeof(T);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int j = threadIdx.x * kPer; j < count; j += kThreads * kPer)
      async_copy::copy16(dst + j, src + j,
                         min(kPer, count - j) * (int)sizeof(T));
  } else {
    for (int j = threadIdx.x; j < count; j += kThreads)
      copy_one(dst + j, src + j, src, true);
  }
}

// *p = v where `pred` holds, as one predicated store (a branch around a
// plain store would cost a convergence barrier a step).
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p st.global.f32 [%0], %1;\n\t}" :: "l"(p), "f"(v), "r"((int)pred));
}

// SPL consecutive floats, 16-byte vectors where `p` is aligned.
template <int SPL>
__device__ __forceinline__ void load_states(float* v, const float* p) {
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < SPL; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SPL; ++k) v[k] = p[k];
  }
}

template <int SPL>
__device__ __forceinline__ void store_states(float* p, const float* v) {
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < SPL; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < SPL; ++k) p[k] = v[k];
  }
}

template <int DS, int G, typename TX, typename TDT, typename TBC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_kernel(const Args args) {
  using Lay = Layout<DS, G, TX, TDT, TBC>;
  constexpr int CH = Lay::kChannels;   // channels per block
  constexpr int SPL = DS / G;          // states per lane
  constexpr int NG = SPL / 4;          // groups of 4 states per lane
  static_assert(SPL % 4 == 0 && (G & (G - 1)) == 0, "lanes per channel");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = async_copy::aligned_smem(smem_raw);
  auto stage = [&](int t) { return smem + (t % kStages) * Lay::kStage; };
  float* const bc_f32 = reinterpret_cast<float*>(smem + kStages *
                                                 Lay::kStage);

  const int L = args.L, di = args.di;
  const int q = threadIdx.x % G;        // the lane's place in its channel
  const int cl = threadIdx.x / G;       // the channel within the block
  const int batch = blockIdx.x / args.chan_tiles;
  const int ch0 = (blockIdx.x % args.chan_tiles) * CH;
  const int ch = ch0 + cl;
  const bool active = ch < di;
  const int width = min(CH, di - ch0);
  const long long row0 = (long long)batch * L;
  const TX* const x = static_cast<const TX*>(args.x) + row0 * di + ch0;
  const TDT* const dt = static_cast<const TDT*>(args.dt) + row0 * di + ch0;
  const TBC* const b = static_cast<const TBC*>(args.b) + row0 * DS;
  const TBC* const c = static_cast<const TBC*>(args.c) + row0 * DS;
  const long long state0 = ((long long)batch * di + ch) * DS + q * SPL;

  float av[SPL], h[SPL];
  if (active) {
    load_states<SPL>(av, args.a + (long long)ch * DS + q * SPL);
    load_states<SPL>(h, args.h0 + state0);
  } else {
#pragma unroll
    for (int k = 0; k < SPL; ++k) av[k] = h[k] = 0.f;
  }

  const int tiles = (L + kSteps - 1) / kSteps;
  const int kept = (L + kKeep - 1) / kKeep;
  // Start tile t's copies into its ring slot (an empty group past the
  // end keeps the group count uniform).
  auto fetch = [&](int t) {
    if (t < tiles) {
      unsigned char* s = stage(t);
      const int n = min(kSteps, L - t * kSteps);
      const long long off = (long long)t * kSteps;
      stage_rows<CH>(reinterpret_cast<TX*>(s), x + off * di, di, n, width,
                     args.x_vec);
      stage_rows<CH>(reinterpret_cast<TDT*>(s + Lay::kX), dt + off * di, di,
                     n, width, args.dt_vec);
      stage_flat(reinterpret_cast<TBC*>(s + Lay::kX + Lay::kDt),
                 b + off * DS, n * DS);
      stage_flat(reinterpret_cast<TBC*>(s + Lay::kX + Lay::kDt + Lay::kBc),
                 c + off * DS, n * DS);
    }
    async_copy::commit();
  };
  // b and c of tile t as f32: the raw tile itself, or (bf16) its f32
  // copy, written one tile ahead by `convert`.
  auto bc_of = [&](int t) -> const float* {
    if constexpr (Lay::kConvert)
      return bc_f32 + (t & 1) * 2 * kSteps * DS;
    else
      return reinterpret_cast<const float*>(stage(t) + Lay::kX + Lay::kDt);
  };
  auto convert = [&](int t) {
    if constexpr (Lay::kConvert) {
      if (t < tiles) {
        const TBC* raw = reinterpret_cast<const TBC*>(stage(t) + Lay::kX +
                                                      Lay::kDt);
        float* out = bc_f32 + (t & 1) * 2 * kSteps * DS;
        const int n = min(kSteps, L - t * kSteps) * DS;
        for (int j = threadIdx.x; j < n; j += kThreads) {
          out[j] = to_f32(raw[j]);
          out[kSteps * DS + j] = to_f32(raw[kSteps * DS + j]);
        }
      }
    }
  };

  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  async_copy::wait<kStages - 2>();
  __syncthreads();
  convert(0);

  for (int t = 0; t < tiles; ++t) {
    // Tile t + 1 has landed; every thread is past tile t - 1, so its ring
    // slot and f32 copy may be refilled.
    async_copy::wait<kStages - 3>();
    __syncthreads();
    fetch(t + kStages - 1);
    convert(t + 1);

    const unsigned char* s = stage(t);
    const TX* const xs = reinterpret_cast<const TX*>(s) + cl;
    const TDT* const dts = reinterpret_cast<const TDT*>(s + Lay::kX) + cl;
    const float* const bs = bc_of(t) + q * SPL;
    const float* const cs = bs + kSteps * DS;
    float* yp = args.y + (row0 + (long long)t * kSteps) * di + ch;
    auto step = [&](int i) {
      const float dv = to_f32(dts[i * CH]);
      const float dbx = __fmul_rn(dv, to_f32(xs[i * CH]));
      float part[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 bq = *reinterpret_cast<const float4*>(bs + i * DS +
                                                           4 * g);
        const float4 cq = *reinterpret_cast<const float4*>(cs + i * DS +
                                                           4 * g);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
        float acc = 0.f;
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int k = 4 * g + s4;
          const float da = expf(__fmul_rn(dv, av[k]));
          h[k] = __fadd_rn(__fmul_rn(da, h[k]), __fmul_rn(dbx, bv[s4]));
          const float hc = __fmul_rn(h[k], cv[s4]);
          acc = s4 == 0 ? hc : __fadd_rn(acc, hc);
        }
        part[g] = acc;
      }
      // Groups held by this lane, pairwise; then across the channel's
      // lanes, pairwise.
#pragma unroll
      for (int w = 1; w < NG; w *= 2)
#pragma unroll
        for (int g = 0; g < NG; g += 2 * w)
          part[g] = __fadd_rn(part[g], part[g + w]);
      float yv = part[0];
#pragma unroll
      for (int w = 1; w < G; w *= 2)
        yv = __fadd_rn(yv, __shfl_xor_sync(0xffffffffu, yv, w));
      store_if(yp, yv, q == 0 && active);
      yp += di;
    };
    // The backward (selective_scan_bwd.cu) recomputes each kKeep-step
    // window from the state it starts with.
    auto keep = [&](int i) {
      if (args.h_tiles != nullptr && active)
        store_states<SPL>(args.h_tiles + (((long long)batch * kept
                                           + (t * kSteps + i) / kKeep) * di
                                          + ch) * DS + q * SPL, h);
    };
    const int n = min(kSteps, L - t * kSteps);
    if (n == kSteps) {
#pragma unroll 1
      for (int j = 0; j < kSteps; j += kKeep) {
        keep(j);
#pragma unroll
        for (int i = 0; i < kKeep; ++i) step(j + i);
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        if (i % kKeep == 0) keep(i);
        step(i);
      }
    }
  }
  if (active) store_states<SPL>(args.h_out + state0, h);
}

template <int DS, typename TX, typename TDT, typename TBC>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* h0, void* y, void* h_out,
           void* h_tiles, int batch, int L, int di, cudaStream_t stream) {
  constexpr int G = lanes<DS>();
  using Lay = Layout<DS, G, TX, TDT, TBC>;
  const int chan_tiles = (di + Lay::kChannels - 1) / Lay::kChannels;
  const long long blocks = (long long)batch * chan_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = Lay::kBytes + async_copy::kSmemAlign;
  auto kernel = scan_kernel<DS, G, TX, TDT, TBC>;
  static async_copy::KernelSetup setup;
  const cudaError_t err = async_copy::prepare(kernel, setup, smem);
  if (err != cudaSuccess) return (int)err;
  Args args{x, dt, b, c, static_cast<const float*>(a),
            static_cast<const float*>(h0), static_cast<float*>(y),
            static_cast<float*>(h_out), static_cast<float*>(h_tiles), L, di,
            chan_tiles,
            reinterpret_cast<uintptr_t>(x) % 16 == 0
                && (size_t)di * sizeof(TX) % 16 == 0,
            reinterpret_cast<uintptr_t>(dt) % 16 == 0
                && (size_t)di * sizeof(TDT) % 16 == 0};
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int DS, typename TX, typename TDT>
int by_bc(bool bc_bf16, const void* x, const void* dt, const void* b,
          const void* c, const void* a, const void* h0, void* y, void* h_out,
          void* h_tiles, int batch, int L, int di, cudaStream_t stream) {
  return bc_bf16 ? launch<DS, TX, TDT, __nv_bfloat16>(x, dt, b, c, a, h0, y,
                                                      h_out, h_tiles, batch,
                                                      L, di, stream)
                 : launch<DS, TX, TDT, float>(x, dt, b, c, a, h0, y, h_out,
                                              h_tiles, batch, L, di, stream);
}

template <int DS, typename TX>
int by_dt(bool dt_bf16, bool bc_bf16, const void* x, const void* dt,
          const void* b, const void* c, const void* a, const void* h0,
          void* y, void* h_out, void* h_tiles, int batch, int L, int di,
          cudaStream_t stream) {
  return dt_bf16 ? by_bc<DS, TX, __nv_bfloat16>(bc_bf16, x, dt, b, c, a, h0,
                                                y, h_out, h_tiles, batch, L,
                                                di, stream)
                 : by_bc<DS, TX, float>(bc_bf16, x, dt, b, c, a, h0, y, h_out,
                                        h_tiles, batch, L, di, stream);
}

template <int DS>
int by_x(bool x_bf16, bool dt_bf16, bool bc_bf16, const void* x,
         const void* dt, const void* b, const void* c, const void* a,
         const void* h0, void* y, void* h_out, void* h_tiles, int batch,
         int L, int di, cudaStream_t stream) {
  return x_bf16 ? by_dt<DS, __nv_bfloat16>(dt_bf16, bc_bf16, x, dt, b, c, a,
                                           h0, y, h_out, h_tiles, batch, L,
                                           di, stream)
                : by_dt<DS, float>(dt_bf16, bc_bf16, x, dt, b, c, a, h0, y,
                                   h_out, h_tiles, batch, L, di, stream);
}

}  // namespace

// x, dt: [batch, L, di]; b, c: [batch, L, ds] (each f32, or bf16 where its
// flag is set; b and c share a type); a: [di, ds] f32; h0: [batch, di, ds]
// f32 -> y: [batch, L, di] f32, h_out: [batch, di, ds] f32, and, unless
// h_tiles is null, h_tiles: [batch, ceil(L / 8), di, ds] f32, the state
// each 8-step window starts from (window 0's is h0).  ds is 4, 8 or 16;
// L >= 1.  Returns a cudaError_t.
extern "C" int selective_scan(const void* x, const void* dt, const void* b,
                              const void* c, const void* a, const void* h0,
                              void* y, void* h_out, void* h_tiles, int batch,
                              int L, int di, int ds, int x_bf16, int dt_bf16,
                              int bc_bf16, void* stream) {
  if (batch < 1 || L < 1 || di < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 4:
      return by_x<4>(x_bf16, dt_bf16, bc_bf16, x, dt, b, c, a, h0, y, h_out,
                     h_tiles, batch, L, di, st);
    case 8:
      return by_x<8>(x_bf16, dt_bf16, bc_bf16, x, dt, b, c, a, h0, y, h_out,
                     h_tiles, batch, L, di, st);
    case 16:
      return by_x<16>(x_bf16, dt_bf16, bc_bf16, x, dt, b, c, a, h0, y, h_out,
                      h_tiles, batch, L, di, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* selective_scan_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
