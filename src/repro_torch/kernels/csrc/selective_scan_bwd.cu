// Backward of the fused Mamba (S6) selective scan (selective_scan.cu):
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t,   y_t = sum_s h_t[s] c_t[s]
// per (batch, channel).  Given dy [batch, L, di] and dh, the cotangent of
// the last state (none: zero), it walks time backwards with
//   g_t = dy_t c_t + exp(dt_{t+1} a) g_{t+1}      (g_{L-1} adds dh)
// and produces dx, ddt [batch, L, di], db, dc [batch, L, ds], da [di, ds]
// and dh0 [batch, di, ds]:
//   dx_t = dt_t sum_s g_t b_t,  ddt_t = x_t sum_s g_t b_t + sum_s e_t a,
//   db_t = sum_channels g_t dt_t x_t,  dc_t = sum_channels dy_t h_t,
//   da = sum_(batch, t) e_t dt_t,  dh0 = exp(dt_0 a) g_0,
// with e_t = g_t h_{t-1} exp(dt_t a), the cotangent of dt_t a.
//
// Replaces no TPU kernel: the reference trains Mamba by differentiating a
// chunked lax.associative_scan (repro/models/mamba.py:82-123), and its
// Pallas scan (repro/kernels/selective_scan.py) has no backward.  The
// port's forward on the card is the CUDA scan, so its gradient is this
// kernel (kernels/selective_scan.py _Scan); on the CPU autograd runs
// through the plain scan (kernels/ref.py selective_scan_bwd).
//
// Bound on an H100 SXM at the served shape (batch 2, L 2048, d_inner
// 16,384, d_state 16; x, b, c bf16, dt f32), E = 1.07 G (t, channel,
// state) elements, counted from what the function needs, not from this
// kernel: every element needs h_{t-1} again (the forward's recurrence: dt
// a, expf's 6, exp h and its FFMA with (dt x) b: 9 FP32-pipe instructions)
// and the backward step (g, e, the sums into dx, ddt, da, db and dc, the
// carry, each product that feeds an add one FFMA: 8), 17 FP32
// instructions and one MUFU.EX2 an element; issued one a clock per
// scheduler that is 0.58 ms at 1980 MHz, above the 0.32 ms of bytes (x,
// dt, b, c, a, h0, dy and dh read once, the gradients written once).
// chip_smoke.py prices it from SCAN_BWD_FP32_PER_ELEMENT.
//
// Design: one recompute and one exponential an element, the window in
// registers.  Against the first version's six costs (6.18 ms at
// 9.3% of the bound):
// 1. One recompute.  The forward keeps h as every 8-step window starts
//    (h_tiles [batch, ceil(L / 8), di, ds], 537 MB at the served shape,
//    was every 32 steps and 134 MB).  A block walks the windows from the
//    last: it runs the window's recurrence once from the kept state with
//    the forward's own operations (__fmul_rn, __fadd_rn, expf), so the
//    recomputed h is the forward's h, keeping each step's exp(dt a),
//    h_{t-1} and dt x in registers (the step loops are unrolled), then
//    walks the 8 steps back from those registers.
// 2. One exponential an element: the walk back reuses the recompute's.
// 3. No states in shared memory.  4 states a lane (d_state / 4 lanes a
//    channel), 256 threads a block: 64 channels at d_state 16, 128 at 8,
//    256 at 4.  The window takes 2 x 8 x 4 registers of a lane's 128, so
//    two blocks fit an SM; the served shape's 512 blocks are 1.94 waves.
//    8 states a lane would need 128 registers for the window alone.
// 4. Channel sums (db, dc) by shuffles, no serial chains.  Per step a lane
//    holds 4 products; two exchanges halve them (keep 2, then 1, adding the
//    partner's) and the rest of the warp's channels add by
//    __shfl_xor_sync, so each lane ends with one state's sum over the
//    warp's channels.  So that a lane always keeps its first registers,
//    register k of a lane holds state q 4 + (k ^ p), p from lane bits 4
//    and 3, and b and c are staged as f32 in the 4 orders p.  The warps'
//    sums are added in warp order through shared memory.
// 5. Loads in flight, one barrier a window.  A ring of 4 windows in shared
//    memory, filled by cp.async (x, dt, dy, b, c and the kept state):
//    while window w computes, w - 1 has landed (and its b and c are put in
//    the lane orders), w - 2 is in flight and w + 1 is read by its
//    epilogue.  A whole window of a whole block of channels, all rows
//    16-byte aligned, each batch's b and c too (every window but a ragged
//    last one at the served shape), is staged by straight-line code: the
//    per-window code outside the unrolled steps runs cold from the
//    instruction cache every window, and loops there cost more than their
//    work.
// 6. Partial sums in a second pass, kept: a block's db and dc per (t,
//    state) and da per batch go to device memory ([2, batch, di / 64, L,
//    ds] f32 at d_state 16: 134 MB written and read once, about 0.08 ms
//    at 3.35 TB/s) and a second kernel adds them in block order, where one
//    pass would need float atomics or an order-keeping handshake across
//    blocks.  dx and ddt: each lane leaves its 4 states' sums of g b and
//    e a in shared memory; the window's epilogue adds a channel's lanes
//    in lane order and writes dx and ddt in their inputs' types,
//    consecutive threads consecutive channels.
// No float atomics, every sum in one fixed order: two calls give the same
// bits.  A ragged last window runs on zero-filled steps, which leave h and
// the carry as they are and whose outputs are not stored.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md §6): 1.7817 ms at the
// served shape (chip_smoke.py 17(a)), 32.4% of the 0.57773 ms bound; the
// window's unrolled steps issue 29.9 instructions an element, 19.5 of them
// on the FP32 pipe and one MUFU.EX2 (chip_smoke.py scan_bwd_sass), against
// the bound's 18.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using async_copy::to_f32;

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kThreads = 256;           // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;                 // steps a window (the forward's keep)
constexpr int kSpl = 4;                 // states a lane
constexpr int kPerms = 4;               // lane orders of b and c
constexpr int kStages = 4;              // windows in the staging ring
constexpr unsigned kFull = 0xffffffffu;

// Lanes per channel at d_state DS.
template <int DS>
__host__ __device__ constexpr int lanes() { return DS / kSpl; }

template <int DS>
__host__ __device__ constexpr int channels() {
  return kThreads / lanes<DS>();
}

struct BwdArgs {
  const void* x;          // [batch, L, di]
  const void* dt;         // [batch, L, di]
  const void* b;          // [batch, L, ds]
  const void* c;          // [batch, L, ds]
  const float* a;         // [di, ds]
  const float* h_tiles;   // [batch, windows, di, ds]
  const float* dy;        // [batch, L, di]
  const float* dh;        // [batch, di, ds] or null
  void* dx;               // [batch, L, di], x's type
  void* ddt;              // [batch, L, di], dt's type
  float* dbc_part;        // [2, batch, chan_tiles, L, ds]: db, dc partials
  float* da_part;         // [batch, di, ds]
  float* dh0;             // [batch, di, ds]
  int batch, L, di, chan_tiles;
  int x_vec, dt_vec, dy_vec;   // rows of x / dt / dy are 16-byte aligned
  int vec;                     // those, b and c (each batch's rows too)
                               // and h_tiles all are
};

// Shared memory of one block: kStages ring slots (x, dt in their types, dy
// f32 [kSeg][CH]; b, c in their type [kSeg][DS]; the kept state f32
// [CH][DS]), then two windows each of b and c in f32 in the kPerms lane
// orders, of the warps' db and dc sums, and of the lanes' (du, dz).
template <int DS, typename TX, typename TDT, typename TBC>
struct Layout {
  static constexpr int kCh = channels<DS>();
  static constexpr size_t kX = sizeof(TX) * kSeg * kCh;
  static constexpr size_t kDt = sizeof(TDT) * kSeg * kCh;
  static constexpr size_t kDy = sizeof(float) * kSeg * kCh;
  static constexpr size_t kBc = sizeof(TBC) * kSeg * DS;
  static constexpr size_t kH = sizeof(float) * kCh * DS;
  static constexpr size_t kSlot = kX + kDt + kDy + 2 * kBc + kH;
  static constexpr int kPermFloats = 2 * kSeg * kPerms * DS;
  static constexpr int kOut = 2 * kSeg * DS;          // db and dc a window
  static constexpr int kRedFloats = kWarps * kOut;
  static constexpr int kDuFloats = 2 * kSeg * kThreads;
  static constexpr size_t kBytes =
      kStages * kSlot
      + 2 * sizeof(float) * (kPermFloats + kRedFloats + kDuFloats);
  static_assert(kX % 16 == 0 && kDt % 16 == 0 && kDy % 16 == 0
                    && kBc % 16 == 0 && kH % 16 == 0,
                "16-byte aligned arrays");
};

// cp.async of one element, zero-filled where !valid; cp.async moves no
// fewer than 4 bytes, so a bf16 element is loaded and stored.
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool valid) {
  async_copy::copy4(dst, src, valid ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}

// dst [kSeg][CH] <- a whole window: kSeg rows of CH elements at stride
// ld from src (its row 0 at the block's first channel), 16 bytes a copy.
// The common case's path: straight-line code, no bounds but the count.
template <int CH, typename T>
__device__ __forceinline__ void stage_full(T* dst, const T* src,
                                           long long ld) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kChunks = CH / kPer, kN = kSeg * kChunks;
#pragma unroll
  for (int j0 = 0; j0 < kN; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (kN % kThreads == 0 || j < kN) {
      const int r = j / kChunks, col = (j % kChunks) * kPer;
      async_copy::copy16(dst + r * CH + col, src + r * ld + col, 16);
    }
  }
}

// dst [COUNT] <- COUNT consecutive elements at src, 16 bytes a copy.
template <int COUNT, typename T>
__device__ __forceinline__ void stage_full_flat(T* dst, const T* src) {
  constexpr int kPer = 16 / (int)sizeof(T), kN = COUNT / kPer;
#pragma unroll
  for (int j0 = 0; j0 < kN; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (kN % kThreads == 0 || j < kN)
      async_copy::copy16(dst + j * kPer, src + j * kPer, 16);
  }
}

// dst [kSeg][CH] <- rows [0, n) and columns [0, width) of the [*, ld] slab
// at src (its row 0 at the block's first channel); the rest zero.
template <int CH, typename T>
__device__ __forceinline__ void stage_window(T* dst, const T* src,
                                             long long ld, int n, int width,
                                             bool vec) {
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);
    constexpr int kChunks = CH / kPer;
    for (int j = threadIdx.x; j < kSeg * kChunks; j += kThreads) {
      const int r = j / kChunks, col = (j % kChunks) * kPer;
      const int valid =
          r < n ? max(0, min(kPer, width - col)) * (int)sizeof(T) : 0;
      async_copy::copy16(dst + r * CH + col, valid ? src + r * ld + col : src,
                         valid);
    }
  } else {
    for (int j = threadIdx.x; j < kSeg * CH; j += kThreads) {
      const int r = j / CH, col = j % CH;
      const bool valid = r < n && col < width;
      copy_elem(dst + j, valid ? src + r * ld + col : src, valid);
    }
  }
}

// dst [count] <- the first n elements at src, the rest zero.
template <typename T>
__device__ __forceinline__ void stage_flat(T* dst, const T* src, int count,
                                           int n) {
  constexpr int kPer = 16 / (int)sizeof(T);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int j = threadIdx.x * kPer; j < count; j += kThreads * kPer) {
      const int valid = max(0, min(kPer, n - j)) * (int)sizeof(T);
      async_copy::copy16(dst + j, valid ? src + j : src, valid);
    }
  } else {
    for (int j = threadIdx.x; j < count; j += kThreads)
      copy_elem(dst + j, j < n ? src + j : src, j < n);
  }
}

// The sum over the warp's channels of v[k] f, for the lane's state
// q 4 + p: register k holds state q 4 + (k ^ p), p = (lane bit 4) 2 +
// (lane bit 3), so the partner across bit 4 holds in its registers 2, 3
// the states of this lane's 0, 1, and across bit 3 in its register 1 the
// state of this lane's 0.  The lower channel bits (from log2 G up to 2)
// add by butterfly; partners add in either order to the same bits.
template <int G>
__device__ __forceinline__ float channel_sum(const float (&v)[kSpl],
                                             float f) {
  const float k0 = fmaf(v[0], f, __shfl_xor_sync(kFull, v[2] * f, 16));
  const float k1 = fmaf(v[1], f, __shfl_xor_sync(kFull, v[3] * f, 16));
  float r = k0 + __shfl_xor_sync(kFull, k1, 8);
#pragma unroll
  for (int m = 4; m >= G; m >>= 1) r += __shfl_xor_sync(kFull, r, m);
  return r;
}

template <int DS, typename TX, typename TDT, typename TBC>
__global__ void __launch_bounds__(kThreads, 2)
    scan_bwd_kernel(const BwdArgs args) {
  using Lay = Layout<DS, TX, TDT, TBC>;
  constexpr int G = lanes<DS>();
  constexpr int CH = Lay::kCh;
  static_assert(G >= 1 && G <= 4 && DS == G * kSpl, "lanes per channel");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = async_copy::aligned_smem(smem_raw);
  float* const perm_s =                 // [2][2][kSeg][kPerms][DS]
      reinterpret_cast<float*>(smem + kStages * Lay::kSlot);
  float* const red_s = perm_s + 2 * Lay::kPermFloats;  // [2][kWarps][kOut]
  float2* const du_s =                  // [2][kSeg][kThreads]
      reinterpret_cast<float2*>(red_s + 2 * Lay::kRedFloats);
  auto slot = [&](int w) { return smem + (w % kStages) * Lay::kSlot; };
  auto x_of = [&](int w) { return reinterpret_cast<TX*>(slot(w)); };
  auto dt_of = [&](int w) {
    return reinterpret_cast<TDT*>(slot(w) + Lay::kX);
  };
  auto dy_of = [&](int w) {
    return reinterpret_cast<float*>(slot(w) + Lay::kX + Lay::kDt);
  };
  auto b_of = [&](int w) {
    return reinterpret_cast<TBC*>(slot(w) + Lay::kX + Lay::kDt + Lay::kDy);
  };
  auto h_of = [&](int w) {
    return reinterpret_cast<float*>(slot(w) + Lay::kX + Lay::kDt + Lay::kDy
                                    + 2 * Lay::kBc);
  };

  const int L = args.L, di = args.di, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int q = tid % G;               // the lane's place in its channel
  const int cl = tid / G;              // the channel within the block
  const int p = ((lane >> 4) & 1) << 1 | ((lane >> 3) & 1);
  // One lane of each group that channel_sum's butterfly leaves equal.
  const bool writer = (lane & (7 & ~(G - 1))) == 0;
  const int batch = blockIdx.x / args.chan_tiles;
  const int ct = blockIdx.x % args.chan_tiles;
  const int ch0 = ct * CH;
  const int ch = ch0 + cl;
  const bool active = ch < di;
  const int width = min(CH, di - ch0);
  const int windows = (L + kSeg - 1) / kSeg;
  const long long row0 = (long long)batch * L;
  const TX* const x = static_cast<const TX*>(args.x) + row0 * di + ch0;
  const TDT* const dt = static_cast<const TDT*>(args.dt) + row0 * di + ch0;
  const float* const dy = args.dy + row0 * di + ch0;
  const TBC* const b = static_cast<const TBC*>(args.b) + row0 * DS;
  const TBC* const c = static_cast<const TBC*>(args.c) + row0 * DS;
  const float* const kept =
      args.h_tiles + ((long long)batch * windows * di + ch0) * DS;
  TX* const dx = static_cast<TX*>(args.dx) + row0 * di + ch0;
  TDT* const ddt = static_cast<TDT*>(args.ddt) + row0 * di + ch0;
  const long long part = (long long)args.batch * args.chan_tiles * L * DS;
  float* const db_part = args.dbc_part
      + ((long long)batch * args.chan_tiles + ct) * L * DS;
  float* const dc_part = db_part + part;
  const long long state0 = ((long long)batch * di + ch) * DS + q * kSpl;

  float av[kSpl], carry[kSpl], ga[kSpl];
#pragma unroll
  for (int k = 0; k < kSpl; ++k) {
    const int s = k ^ p;
    av[k] = active ? args.a[(long long)ch * DS + q * kSpl + s] : 0.f;
    carry[k] = active && args.dh != nullptr ? args.dh[state0 + s] : 0.f;
    ga[k] = 0.f;
  }

  // Start window w's copies into its ring slot (an empty group past the
  // first window keeps the group count uniform).  A whole window of a
  // whole block of channels, everything aligned, takes the short path.
  auto fetch = [&](int w) {
    if (w >= 0) {
      const int t0 = w * kSeg, n = min(kSeg, L - t0);
      const long long at = (long long)t0 * di;
      if (args.vec && n == kSeg && width == CH) {
        stage_full<CH>(x_of(w), x + at, di);
        stage_full<CH>(dt_of(w), dt + at, di);
        stage_full<CH>(dy_of(w), dy + at, di);
        stage_full_flat<kSeg * DS>(b_of(w), b + (long long)t0 * DS);
        stage_full_flat<kSeg * DS>(b_of(w) + kSeg * DS,
                                   c + (long long)t0 * DS);
        stage_full_flat<CH * DS>(h_of(w), kept + (long long)w * di * DS);
      } else {
        stage_window<CH>(x_of(w), x + at, di, n, width, args.x_vec);
        stage_window<CH>(dt_of(w), dt + at, di, n, width, args.dt_vec);
        stage_window<CH>(dy_of(w), dy + at, di, n, width, args.dy_vec);
        stage_flat(b_of(w), b + (long long)t0 * DS, kSeg * DS, n * DS);
        stage_flat(b_of(w) + kSeg * DS, c + (long long)t0 * DS, kSeg * DS,
                   n * DS);
        stage_flat(h_of(w), kept + (long long)w * di * DS, CH * DS,
                   width * DS);
      }
    }
    async_copy::commit();
  };
  // b and c of window w (landed) as f32 in each lane order pp:
  // [b or c][i][pp][q 4 + k] = raw[i][q 4 + (k ^ pp)], a group of 4 a
  // thread.
  auto convert = [&](int w) {
    if (w < 0) return;
    const TBC* const raw = b_of(w);
    float4* const out =
        reinterpret_cast<float4*>(perm_s + (w & 1) * Lay::kPermFloats);
    constexpr int kN = Lay::kPermFloats / 4;
#pragma unroll
    for (int f0 = 0; f0 < kN; f0 += kThreads) {
      const int f = f0 + tid;
      if (kN % kThreads != 0 && f >= kN) break;
      const int g = f % (DS / 4), pp = (f / (DS / 4)) % kPerms;
      const int row = f / (DS / 4 * kPerms);
      float4 v = async_copy::load4(raw + row * DS + 4 * g);
      if (pp & 1) v = make_float4(v.y, v.x, v.w, v.z);
      if (pp & 2) v = make_float4(v.z, v.w, v.x, v.y);
      out[f] = v;
    }
  };
  // Window w's outputs, once every thread is past its compute: dx and ddt
  // from the lanes' (du, dz), and the block's db and dc partials.
  auto finish = [&](int w) {
    const int t0 = w * kSeg;
    const TX* const xs = x_of(w);
    const TDT* const dts = dt_of(w);
    const float2* const dus = du_s + (w & 1) * kSeg * kThreads;
#pragma unroll
    for (int o0 = 0; o0 < kSeg * CH; o0 += kThreads) {
      const int o = o0 + tid;
      const int i = o / CH, col = o % CH;
      if (t0 + i < L && col < width) {
        // The channel's G lanes' (du, dz), 16-byte loads, added in order.
        const float2* const lane0 = dus + i * kThreads + col * G;
        float du, dz;
        if constexpr (G == 1) {
          du = lane0->x;
          dz = lane0->y;
        } else {
          const float4 v = *reinterpret_cast<const float4*>(lane0);
          du = v.x + v.z;
          dz = v.y + v.w;
          if constexpr (G == 4) {
            const float4 u = *reinterpret_cast<const float4*>(lane0 + 2);
            du = (du + u.x) + u.z;
            dz = (dz + u.y) + u.w;
          }
        }
        const long long at = (long long)(t0 + i) * di + col;
        store_as(dx + at, du * to_f32(dts[o]));
        store_as(ddt + at, fmaf(du, to_f32(xs[o]), dz));
      }
    }
    const float* const red = red_s + (w & 1) * Lay::kRedFloats;
#pragma unroll
    for (int o0 = 0; o0 < Lay::kOut; o0 += kThreads) {
      const int o = o0 + tid;
      if (Lay::kOut % kThreads != 0 && o >= Lay::kOut) break;
      const int r = o % (kSeg * DS);
      if (t0 + r / DS < L) {
        float acc = red[o];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) acc += red[v * Lay::kOut + o];
        (o < kSeg * DS ? db_part : dc_part)[(long long)t0 * DS + r] = acc;
      }
    }
  };
  // Window w: its recurrence from the kept state, then back through it.
  auto compute = [&](int w) {
    const TX* const xs = x_of(w) + cl;
    const TDT* const dts = dt_of(w) + cl;
    const float* const dys = dy_of(w) + cl;
    const float* const hs = h_of(w) + cl * DS + q * kSpl;
    const float* const bp =
        perm_s + (w & 1) * Lay::kPermFloats + p * DS + q * kSpl;
    const float* const cp = bp + kSeg * kPerms * DS;
    float* const red = red_s + (w & 1) * Lay::kRedFloats
                       + warp * Lay::kOut + q * kSpl + p;
    float2* const dus = du_s + (w & 1) * kSeg * kThreads + tid;

    // The window in registers: each step's exp(dt a), h_{t-1} and dt x
    // (dt too took registers that the compiler found by taking some of the
    // exponentials again).
    float h[kSpl], da[kSeg][kSpl], hp[kSeg][kSpl], us[kSeg];
#pragma unroll
    for (int k = 0; k < kSpl; ++k) h[k] = hs[k ^ p];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const float dv = to_f32(dts[i * CH]);
      const float u = __fmul_rn(dv, to_f32(xs[i * CH]));
      us[i] = u;
      const float4 bq =
          *reinterpret_cast<const float4*>(bp + i * kPerms * DS);
      const float bv[kSpl] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int k = 0; k < kSpl; ++k) {
        da[i][k] = expf(__fmul_rn(dv, av[k]));
        hp[i][k] = h[k];
        h[k] = __fadd_rn(__fmul_rn(da[i][k], h[k]), __fmul_rn(u, bv[k]));
      }
      const float dc = channel_sum<G>(h, dys[i * CH]);
      if (writer) red[kSeg * DS + i * DS] = dc;
    }
#pragma unroll
    for (int i = kSeg - 1; i >= 0; --i) {
      const float dv = to_f32(dts[i * CH]), u = us[i];
      const float dyv = dys[i * CH];
      const float4 bq =
          *reinterpret_cast<const float4*>(bp + i * kPerms * DS);
      const float4 cq =
          *reinterpret_cast<const float4*>(cp + i * kPerms * DS);
      const float bv[kSpl] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[kSpl] = {cq.x, cq.y, cq.z, cq.w};
      float g[kSpl], du = 0.f, dz = 0.f;
#pragma unroll
      for (int k = 0; k < kSpl; ++k) {
        g[k] = fmaf(dyv, cv[k], carry[k]);
        const float cr = g[k] * da[i][k];
        const float e = cr * hp[i][k];
        carry[k] = cr;
        du = fmaf(g[k], bv[k], du);
        dz = fmaf(e, av[k], dz);
        ga[k] = fmaf(e, dv, ga[k]);
      }
      const float db = channel_sum<G>(g, u);
      if (writer) red[i * DS] = db;
      dus[i * kThreads] = make_float2(du, dz);
    }
  };

  fetch(windows - 1);
  fetch(windows - 2);
  async_copy::wait<0>();
  __syncthreads();
  convert(windows - 1);
  for (int w = windows - 1; w >= 0; --w) {
    // Window w - 1 has landed; every thread is past window w + 1's
    // compute and window w + 2's epilogue, whose buffers are reused.
    async_copy::wait<0>();
    __syncthreads();
    fetch(w - 2);
    convert(w - 1);
    if (w + 1 < windows) finish(w + 1);
    compute(w);
  }
  __syncthreads();
  finish(0);
  if (active) {
#pragma unroll
    for (int k = 0; k < kSpl; ++k) {
      args.dh0[state0 + (k ^ p)] = carry[k];
      args.da_part[state0 + (k ^ p)] = ga[k];
    }
  }
}

// out[o][r] = sum_k part[o][k][r], k in order from 0.
__global__ void sum_middle(const float* __restrict__ part,
                           float* __restrict__ out, long long outer, int K,
                           long long inner) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= outer * inner) return;
  const long long o = idx / inner, r = idx % inner;
  const float* p = part + o * K * inner + r;
  float acc = p[0];
  for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, p[k * inner]);
  out[idx] = acc;
}

int sum_over(const float* part, float* out, long long outer, int K,
             long long inner, cudaStream_t stream) {
  const long long total = outer * inner;
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sum_middle<<<(unsigned)blocks, 256, 0, stream>>>(part, out, outer, K,
                                                   inner);
  return (int)cudaGetLastError();
}

struct Call {
  BwdArgs args;
  float* dbc;        // [2, batch, L, ds]
  float* da;         // [di, ds]
  cudaStream_t stream;
};

bool rows_aligned(const void* p, size_t row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
}

template <int DS, typename TX, typename TDT, typename TBC>
int launch(Call call) {
  using Lay = Layout<DS, TX, TDT, TBC>;
  BwdArgs& args = call.args;
  args.chan_tiles = (args.di + Lay::kCh - 1) / Lay::kCh;
  args.x_vec = rows_aligned(args.x, (size_t)args.di * sizeof(TX));
  args.dt_vec = rows_aligned(args.dt, (size_t)args.di * sizeof(TDT));
  args.dy_vec = rows_aligned(args.dy, (size_t)args.di * sizeof(float));
  // A batch's b and c rows start 16-byte aligned only where its L rows
  // fill whole 16 bytes: at d_state 4 in bf16 a row is 8 bytes, so an odd
  // L leaves every other batch's rows 8 bytes off.
  const size_t bc_rows = (size_t)args.L * DS * sizeof(TBC);
  args.vec = args.x_vec && args.dt_vec && args.dy_vec
             && rows_aligned(args.b, bc_rows) && rows_aligned(args.c, bc_rows)
             && rows_aligned(args.h_tiles, 0);
  const long long blocks = (long long)args.batch * args.chan_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = Lay::kBytes + async_copy::kSmemAlign;
  auto kernel = scan_bwd_kernel<DS, TX, TDT, TBC>;
  static async_copy::KernelSetup setup;
  cudaError_t err = async_copy::prepare(kernel, setup, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, call.stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int status = sum_over(args.dbc_part, call.dbc, 2LL * args.batch,
                              args.chan_tiles, (long long)args.L * DS,
                              call.stream);
  if (status != 0) return status;
  return sum_over(args.da_part, call.da, 1, args.batch,
                  (long long)args.di * DS, call.stream);
}

template <int DS, typename TX, typename TDT>
int by_bc(bool bc_bf16, const Call& call) {
  return bc_bf16 ? launch<DS, TX, TDT, __nv_bfloat16>(call)
                 : launch<DS, TX, TDT, float>(call);
}

template <int DS, typename TX>
int by_dt(bool dt_bf16, bool bc_bf16, const Call& call) {
  return dt_bf16 ? by_bc<DS, TX, __nv_bfloat16>(bc_bf16, call)
                 : by_bc<DS, TX, float>(bc_bf16, call);
}

template <int DS>
int by_x(bool x_bf16, bool dt_bf16, bool bc_bf16, const Call& call) {
  return x_bf16 ? by_dt<DS, __nv_bfloat16>(dt_bf16, bc_bf16, call)
                : by_dt<DS, float>(dt_bf16, bc_bf16, call);
}

}  // namespace

// Channels a block of the backward takes at d_state ds (its partial sums
// of db and dc are [2, batch, ceil(di / channels), L, ds] floats).
extern "C" int selective_scan_bwd_channels(int ds) {
  return ds == 16 ? channels<16>() : ds == 8 ? channels<8>()
                                             : channels<4>();
}

// The forward's inputs x, dt (each [batch, L, di]), b, c ([batch, L, ds];
// each f32, or bf16 where its flag is set, b and c alike), a [di, ds] f32
// and h_tiles [batch, ceil(L / 8), di, ds] f32 (what selective_scan wrote
// there), the cotangents dy [batch, L, di] f32 and dh [batch, di, ds] f32
// (null: zero) -> dx, ddt [batch, L, di] in x's and dt's types, dbc [2,
// batch, L, ds] (db, dc), da [di, ds] and dh0 [batch, di, ds] in f32;
// dbc_part and da_part are scratch of [2, batch, ceil(di / channels), L,
// ds] and [batch, di, ds] floats.  ds is 4, 8 or 16; L >= 1.  Three
// launches on `stream`; returns a cudaError_t.
extern "C" int selective_scan_bwd(const void* x, const void* dt,
                                  const void* b, const void* c,
                                  const void* a, const void* h_tiles,
                                  const void* dy, const void* dh, void* dx,
                                  void* ddt, void* dbc, void* da, void* dh0,
                                  void* dbc_part, void* da_part, int batch,
                                  int L, int di, int ds, int x_bf16,
                                  int dt_bf16, int bc_bf16, void* stream) {
  if (batch < 1 || L < 1 || di < 1) return (int)cudaErrorInvalidValue;
  Call call{{x, dt, b, c, static_cast<const float*>(a),
             static_cast<const float*>(h_tiles),
             static_cast<const float*>(dy), static_cast<const float*>(dh),
             dx, ddt,
             static_cast<float*>(dbc_part), static_cast<float*>(da_part),
             static_cast<float*>(dh0), batch, L, di, 0, 0, 0, 0, 0},
            static_cast<float*>(dbc), static_cast<float*>(da),
            static_cast<cudaStream_t>(stream)};
  switch (ds) {
    case 4: return by_x<4>(x_bf16, dt_bf16, bc_bf16, call);
    case 8: return by_x<8>(x_bf16, dt_bf16, bc_bf16, call);
    case 16: return by_x<16>(x_bf16, dt_bf16, bc_bf16, call);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* selective_scan_bwd_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
