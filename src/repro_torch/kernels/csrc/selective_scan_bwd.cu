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
// Design: simple and right first.
// - Recompute, never store [batch, L, di, ds].  The forward writes h at
//   the start of each of its 32-step tiles (h_tiles).  A block walks the
//   tiles from the last; for each it first runs the tile's recurrence
//   from the stored state and keeps the state at the start of each
//   8-step sub-tile in shared memory, then, sub-tile by sub-tile from the
//   last, recomputes the 8 states into shared memory and walks them
//   backwards.  The recurrence is the forward's own operations
//   (__fmul_rn, __fadd_rn, expf), so the recomputed h is the forward's h.
// - Threads as in the forward: a channel's d_state states over G lanes of
//   8 (G = 2 at d_state 16), 128 threads a block, so 64 channels a block
//   at d_state 16 and 128 at 8 and 4.  A sub-tile's x, dt, dy, b and c
//   are staged in shared memory as f32.  The sums over the states (dx,
//   ddt) add a lane's states in order, then across lanes by
//   __shfl_xor_sync.
// - No float atomics.  db and dc sum over channels: a block sums its own
//   channels in channel order (dc from the recomputed h and dy, db from
//   g dt x, written over each state once the walk is past it) into a
//   per-block partial; da sums over time in each thread's registers and
//   over the batch through a per-batch partial.  A second kernel adds the
//   partials over blocks, and over the batch, in index order.  Two calls
//   give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using async_copy::to_f32;

constexpr int kThreads = 128;           // threads per block
constexpr int kSteps = 32;              // the forward's tile (h_tiles)
constexpr int kSub = 8;                 // steps kept in shared memory
constexpr int kSubs = kSteps / kSub;    // sub-tiles a tile
static_assert(kSteps % kSub == 0, "whole sub-tiles in a full tile");

// Lanes per channel at d_state DS: 8 states each where DS allows.
template <int DS>
constexpr int lanes() { return DS >= 16 ? DS / 8 : 1; }

template <int DS>
constexpr int channels() { return kThreads / lanes<DS>(); }

struct BwdArgs {
  const void* x;          // [batch, L, di]
  const void* dt;         // [batch, L, di]
  const void* b;          // [batch, L, ds]
  const void* c;          // [batch, L, ds]
  const float* a;         // [di, ds]
  const float* h_tiles;   // [batch, tiles, di, ds]
  const float* dy;        // [batch, L, di]
  const float* dh;        // [batch, di, ds] or null
  float* dx;              // [batch, L, di]
  float* ddt;             // [batch, L, di]
  float* dbc_part;        // [2, batch, chan_tiles, L, ds]: db, dc partials
  float* da_part;         // [batch, di, ds]
  float* dh0;             // [batch, di, ds]
  int batch, L, di, chan_tiles;
};

// Floats of shared memory a block uses.
template <int DS>
constexpr int smem_floats() {
  return kThreads * (DS / lanes<DS>()) * (kSub + kSubs)
         + 3 * kSub * channels<DS>() + 2 * kSub * DS;
}

template <int DS, int G, typename TX, typename TDT, typename TBC>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const BwdArgs args) {
  constexpr int CH = kThreads / G;     // channels per block
  constexpr int SPL = DS / G;          // states per lane
  constexpr int kStep = kThreads * SPL;   // floats of one step's states

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const h_s =                   // [kSub][kThreads][SPL]
      reinterpret_cast<float*>(async_copy::aligned_smem(smem_raw));
  float* const start_s = h_s + kSub * kStep;   // [kSubs][kThreads][SPL]
  float* const x_s = start_s + kSubs * kStep;  // [kSub][CH]
  float* const dt_s = x_s + kSub * CH;
  float* const dy_s = dt_s + kSub * CH;
  float* const b_s = dy_s + kSub * CH;         // [kSub][DS]
  float* const c_s = b_s + kSub * DS;

  const int L = args.L, di = args.di, tid = threadIdx.x;
  const int q = tid % G;               // the lane's place in its channel
  const int cl = tid / G;              // the channel within the block
  const int batch = blockIdx.x / args.chan_tiles;
  const int ct = blockIdx.x % args.chan_tiles;
  const int ch0 = ct * CH;
  const int ch = ch0 + cl;
  const bool active = ch < di;
  const int width = min(CH, di - ch0);
  const long long row0 = (long long)batch * L;
  const TX* const x = static_cast<const TX*>(args.x) + row0 * di;
  const TDT* const dt = static_cast<const TDT*>(args.dt) + row0 * di;
  const TBC* const b = static_cast<const TBC*>(args.b) + row0 * DS;
  const TBC* const c = static_cast<const TBC*>(args.c) + row0 * DS;
  const float* const dy = args.dy + row0 * di;
  float* const dx = args.dx + row0 * di;
  float* const ddt = args.ddt + row0 * di;
  const long long part = (long long)args.batch * args.chan_tiles * L * DS;
  float* const db_part = args.dbc_part
      + ((long long)batch * args.chan_tiles + ct) * L * DS;
  float* const dc_part = db_part + part;
  const long long state0 = ((long long)batch * di + ch) * DS + q * SPL;
  const int tiles = (L + kSteps - 1) / kSteps;
  float* const my_h = h_s + tid * SPL;
  float* const my_start = start_s + tid * SPL;

  float av[SPL], carry[SPL], ga[SPL], h[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    av[k] = active ? args.a[(long long)ch * DS + q * SPL + k] : 0.f;
    carry[k] = active && args.dh != nullptr ? args.dh[state0 + k] : 0.f;
    ga[k] = 0.f;
  }

  for (int T = tiles - 1; T >= 0; --T) {
    const int t0 = T * kSteps;
    const int subs = (min(kSteps, L - t0) + kSub - 1) / kSub;
    // The state each sub-tile starts from, by the forward's recurrence
    // from the tile's stored state.
    const long long tile_state =
        (((long long)batch * tiles + T) * di + ch) * DS + q * SPL;
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      h[k] = active ? args.h_tiles[tile_state + k] : 0.f;
    for (int j = 0; j < subs; ++j) {
#pragma unroll
      for (int k = 0; k < SPL; ++k) my_start[j * kStep + k] = h[k];
      if (j + 1 == subs) break;
      for (int i = 0; i < kSub; ++i) {
        const long long t = t0 + j * kSub + i;
        const float dv = active ? to_f32(dt[t * di + ch]) : 0.f;
        const float dbx = __fmul_rn(dv, active ? to_f32(x[t * di + ch])
                                               : 0.f);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const float da = expf(__fmul_rn(dv, av[k]));
          const float bv = to_f32(b[t * DS + q * SPL + k]);
          h[k] = __fadd_rn(__fmul_rn(da, h[k]), __fmul_rn(dbx, bv));
        }
      }
    }

    for (int j = subs - 1; j >= 0; --j) {
      const int s0 = t0 + j * kSub;
      const int m = min(kSub, L - s0);
      __syncthreads();                 // the last sub-tile's readers done
      for (int idx = tid; idx < kSub * CH; idx += kThreads) {
        const int i = idx / CH, col = idx % CH;
        const bool ok = i < m && col < width;
        const long long at = (long long)(s0 + i) * di + ch0 + col;
        x_s[idx] = ok ? to_f32(x[at]) : 0.f;
        dt_s[idx] = ok ? to_f32(dt[at]) : 0.f;
        dy_s[idx] = ok ? dy[at] : 0.f;
      }
      for (int idx = tid; idx < kSub * DS; idx += kThreads) {
        const bool ok = idx / DS < m;
        const long long at = (long long)s0 * DS + idx;
        b_s[idx] = ok ? to_f32(b[at]) : 0.f;
        c_s[idx] = ok ? to_f32(c[at]) : 0.f;
      }
      __syncthreads();

      // The sub-tile's states, into shared memory.
#pragma unroll
      for (int k = 0; k < SPL; ++k) h[k] = my_start[j * kStep + k];
      for (int i = 0; i < m; ++i) {
        const float dv = dt_s[i * CH + cl];
        const float dbx = __fmul_rn(dv, x_s[i * CH + cl]);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const float da = expf(__fmul_rn(dv, av[k]));
          h[k] = __fadd_rn(__fmul_rn(da, h[k]),
                           __fmul_rn(dbx, b_s[i * DS + q * SPL + k]));
          my_h[i * kStep + k] = h[k];
        }
      }
      __syncthreads();

      // dc over the block's channels, in channel order: state s of
      // channel cc at step i lies at h_s[i][cc G + s / SPL][s % SPL].
      for (int o = tid; o < m * DS; o += kThreads) {
        const int i = o / DS, s = o % DS;
        const float* hp = h_s + i * kStep + s;
        const float* dyp = dy_s + i * CH;
        float acc = 0.f;
        for (int cc = 0; cc < width; ++cc)
          acc = __fadd_rn(acc, __fmul_rn(dyp[cc], hp[cc * DS]));
        dc_part[(long long)(s0 + i) * DS + s] = acc;
      }
      __syncthreads();

      // Backwards through the sub-tile.  Step i reads h_{i-1} and then
      // leaves g_i dt_i x_i (db's term) in h_i's place, which no later
      // step reads.
      for (int i = m - 1; i >= 0; --i) {
        const float dv = dt_s[i * CH + cl];
        const float xv = x_s[i * CH + cl];
        const float dyv = dy_s[i * CH + cl];
        const float u = __fmul_rn(dv, xv);
        const float* hp = i > 0 ? my_h + (i - 1) * kStep
                                : my_start + j * kStep;
        float du = 0.f, dz = 0.f;
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const float bv = b_s[i * DS + q * SPL + k];
          const float cv = c_s[i * DS + q * SPL + k];
          const float da = expf(__fmul_rn(dv, av[k]));
          const float g = __fadd_rn(__fmul_rn(dyv, cv), carry[k]);
          const float e = __fmul_rn(__fmul_rn(g, hp[k]), da);
          const float gb = __fmul_rn(g, bv);
          const float ea = __fmul_rn(e, av[k]);
          du = k == 0 ? gb : __fadd_rn(du, gb);
          dz = k == 0 ? ea : __fadd_rn(dz, ea);
          ga[k] = __fadd_rn(ga[k], __fmul_rn(e, dv));
          carry[k] = __fmul_rn(g, da);
          my_h[i * kStep + k] = __fmul_rn(g, u);
        }
#pragma unroll
        for (int w = 1; w < G; w *= 2) {
          du = __fadd_rn(du, __shfl_xor_sync(0xffffffffu, du, w));
          dz = __fadd_rn(dz, __shfl_xor_sync(0xffffffffu, dz, w));
        }
        if (q == 0 && active) {
          const long long at = (long long)(s0 + i) * di + ch;
          dx[at] = __fmul_rn(du, dv);
          ddt[at] = __fadd_rn(__fmul_rn(du, xv), dz);
        }
      }
      __syncthreads();

      // db over the block's channels, in channel order.
      for (int o = tid; o < m * DS; o += kThreads) {
        const int i = o / DS, s = o % DS;
        const float* gp = h_s + i * kStep + s;
        float acc = 0.f;
        for (int cc = 0; cc < width; ++cc) acc = __fadd_rn(acc, gp[cc * DS]);
        db_part[(long long)(s0 + i) * DS + s] = acc;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      args.dh0[state0 + k] = carry[k];
      args.da_part[state0 + k] = ga[k];
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

template <int DS, typename TX, typename TDT, typename TBC>
int launch(Call call) {
  constexpr int G = lanes<DS>();
  BwdArgs& args = call.args;
  args.chan_tiles = (args.di + channels<DS>() - 1) / channels<DS>();
  const long long blocks = (long long)args.batch * args.chan_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_floats<DS>() * sizeof(float)
                      + async_copy::kSmemAlign;
  auto kernel = scan_bwd_kernel<DS, G, TX, TDT, TBC>;
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
// and h_tiles [batch, ceil(L / 32), di, ds] f32 (what selective_scan wrote
// there), the cotangents dy [batch, L, di] f32 and dh [batch, di, ds] f32
// (null: zero) -> dx, ddt [batch, L, di], dbc [2, batch, L, ds] (db, dc),
// da [di, ds] and dh0 [batch, di, ds], all f32; dbc_part and da_part are
// scratch of [2, batch, ceil(di / channels), L, ds] and [batch, di, ds]
// floats.  ds is 4, 8 or 16; L >= 1.  Three launches on `stream`; returns
// a cudaError_t.
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
             static_cast<float*>(dx), static_cast<float*>(ddt),
             static_cast<float*>(dbc_part), static_cast<float*>(da_part),
             static_cast<float*>(dh0), batch, L, di, 0},
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
