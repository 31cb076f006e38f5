// Bounded-queue fluid step, and the whole control window built on it.
//
// Replaces the Pallas TPU kernel `queue_step_pallas`
// (src/repro/kernels/queue_step/kernel.py, body `_queue_step_kernel`):
//
//     served   = min(q, cap_serve)
//     q1       = q - served
//     admitted = min(inflow, max(cap_queue - q1, 0))
//     q_next   = q1 + admitted,   dropped = inflow - admitted
//
// cap_queue = +inf encodes unbounded and block-policy lanes.
//
// queue_step_kernel is that step over M = B*N lanes, one thread per lane:
// 28 bytes per lane against ~7 float ops, so at the main path's M = 4096 *
// 7 the launch itself is the cost.  The control window used to call it
// once per simulated step (100 per tick), each step with ~25 more PyTorch
// launches around it (the routing product, the inflow, the window sums).
//
// The window kernels run all `steps` steps of a tick for every lane in one
// launch -- the JAX package's lax.scan over the window
// (src/repro/streaming/batchsim.py, window_step_fn) -- computing per step
// exactly what the plain window (kernels/queue_step/ref.py, queue_window)
// computes:
//
//     routed[j]  = sum_i served_prev[i] * routing[i, j]   (index order)
//     inflow     = ext_t + routed,   then the step above
//     adm_frac   = inflow > 0 ? (inflow - dropped) / inflow : 1
//     ext_adm_t  = sum_j ext_t[j] * adm_frac[j],  ext_off_t = sum_j ext_t[j]
//
// and the 15 window outputs: the state (q, served_prev), 7 ungated sums
// (offered, served, dropped, ext_adm, ext_off, q_int, q_max) and 6
// warm-weighted ones, acc + w * x with the product and the sum rounded
// separately.  State and accumulators stay in registers for the window.
// Built with -fmad=false and with IEEE division, and using the NaN-
// propagating min / max, every route rounds like the plain version: the
// outputs are bitwise equal.
//
// Bound on the H100: each step reads one [B, N] row of ext (the window's
// bytes are nearly all ext: 100 x 4096 x 7 x 4 B = 11.5 MB at the fleet
// shape), and each scenario's steps form a serial chain.  So the
// routes keep ext loads in flight ahead of the chain (a register ring of
// kPrefetch steps), and pick their layout by N:
//
// - segment route (queue_window_seg_kernel, N <= 32): scenarios packed in
//   warp segments of W lanes (W = 8 up to N = 8, else 32), one lane per
//   operator holding its routing column; served_prev is broadcast and the
//   two row sums formed by segmented __shfl_sync in index order.  B * W
//   threads, no block barrier.
// - wide route (queue_window_wide_kernel, N > 32): a choice by shape --
//   33 or more lanes fill more than a warp -- one block per scenario, a
//   thread per lane, served_prev and the row-sum terms in shared memory,
//   two block barriers per step.
#include "common.cuh"

namespace {

constexpr int kPrefetch = 8;  // steps of ext (and warm) loaded ahead of use

// Output planes: the lane buffer is [11, B, N], the scenario buffer [4, B].
enum LanePlane { kQ, kSp, kOff, kSrv, kDrop, kQInt, kQMax, kWOff, kWSrv, kWDrop, kWQi };
enum ScenPlane { kEa, kEo, kWEa, kWEo };

// A queue lane's state and window sums.
struct Lane {
  float q, sp, off, srv, drop, qint, qmax, woff, wsrv, wdrop, wqi;
};

// A scenario's two row sums, ungated and warm-weighted.
struct Scen {
  float ea, eo, wea, weo;
};

__device__ __forceinline__ Lane lane_init(float q, float sp) {
  return Lane{q, sp, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// One step of one lane given its ext arrivals and routed inflow; returns
// ext * adm_frac, its term of ext_adm_t.
__device__ __forceinline__ float lane_step(Lane& s, float e, float routed, float caps,
                                           float capq, float w) {
  const float inflow = e + routed;
  const float served = repro::nan_min(s.q, caps);
  const float q1 = s.q - served;
  const float adm = repro::nan_min(inflow, repro::nan_max(capq - q1, 0.0f));
  const float q_next = q1 + adm;
  const float drop = inflow - adm;
  // adm_frac = inflow > 0 ? admitted / inflow : 1, as 1 / 1 where inflow
  // is 0: a 0 / 0 (an idle or padded lane) would take the division's slow
  // path, and with it the whole warp.
  const bool flowing = inflow > 0.0f;
  const float frac = (flowing ? inflow - drop : 1.0f) / (flowing ? inflow : 1.0f);
  s.off = s.off + inflow;
  s.srv = s.srv + served;
  s.drop = s.drop + drop;
  s.qint = s.qint + q_next;
  s.qmax = repro::nan_max(s.qmax, q_next);
  s.woff = s.woff + w * inflow;
  s.wsrv = s.wsrv + w * served;
  s.wdrop = s.wdrop + w * drop;
  s.wqi = s.wqi + w * q_next;
  s.q = q_next;
  s.sp = served;
  return e * frac;
}

__device__ __forceinline__ void scen_step(Scen& g, float ea, float eo, float w) {
  g.ea = g.ea + ea;
  g.eo = g.eo + eo;
  g.wea = g.wea + w * ea;
  g.weo = g.weo + w * eo;
}

__device__ __forceinline__ void lane_store(const Lane& s, float* out, size_t lanes,
                                           size_t off) {
  const float v[11] = {s.q, s.sp, s.off, s.srv, s.drop, s.qint, s.qmax,
                       s.woff, s.wsrv, s.wdrop, s.wqi};
#pragma unroll
  for (int p = 0; p < 11; ++p) out[p * lanes + off] = v[p];
}

__device__ __forceinline__ void scen_store(const Scen& g, float* out, int b, int scen) {
  out[kEa * static_cast<size_t>(b) + scen] = g.ea;
  out[kEo * static_cast<size_t>(b) + scen] = g.eo;
  out[kWEa * static_cast<size_t>(b) + scen] = g.wea;
  out[kWEo * static_cast<size_t>(b) + scen] = g.weo;
}

// Segment route: 32 / W scenarios per warp, lane j of a segment is operator
// j.  Lanes past N (and past B) run on zeros and store nothing; every lane
// of the warp takes part in every shuffle.
template <int W>
__global__ void queue_window_seg_kernel(
    const float* __restrict__ q0, const float* __restrict__ sp0,
    const float* __restrict__ ext, const float* __restrict__ warm,
    const float* __restrict__ caps_g, const float* __restrict__ capq_g,
    const float* __restrict__ routing, float* __restrict__ lane_out,
    float* __restrict__ scen_out, int b, int n, int steps) {
  const int lane = threadIdx.x & 31;
  const int j = lane % W;
  const int scen = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (32 / W) + lane / W;
  const bool real = scen < b && j < n;
  const size_t lanes = static_cast<size_t>(b) * n;
  const size_t off = static_cast<size_t>(scen) * n + j;

  float col[W];  // routing[scen, :, j]
#pragma unroll
  for (int i = 0; i < W; ++i)
    col[i] = (real && i < n) ? routing[(static_cast<size_t>(scen) * n + i) * n + j] : 0.0f;
  Lane s = lane_init(real ? q0[off] : 0.0f, real ? sp0[off] : 0.0f);
  const float caps = real ? caps_g[off] : 0.0f;
  const float capq = real ? capq_g[off] : 0.0f;
  Scen g{0.0f, 0.0f, 0.0f, 0.0f};

  float e_cur[kPrefetch], w_cur[kPrefetch];
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) {
    e_cur[u] = (real && u < steps) ? ext[u * lanes + off] : 0.0f;
    w_cur[u] = u < steps ? warm[u] : 0.0f;
  }
  for (int t0 = 0; t0 < steps; t0 += kPrefetch) {
    float e_nxt[kPrefetch], w_nxt[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int t = t0 + kPrefetch + u;
      e_nxt[u] = (real && t < steps) ? ext[t * lanes + off] : 0.0f;
      w_nxt[u] = t < steps ? warm[t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (t0 + u >= steps) break;  // the same for every lane
      // Every lane shuffles all W lanes (no branch around a shuffle); terms
      // past N are selected away, so each sum runs over lanes 0..N-1 only.
      float routed = __shfl_sync(repro::kFullMask, s.sp, 0, W) * col[0];
#pragma unroll
      for (int i = 1; i < W; ++i) {
        const float r = routed + __shfl_sync(repro::kFullMask, s.sp, i, W) * col[i];
        routed = i < n ? r : routed;
      }
      const float x = lane_step(s, e_cur[u], routed, caps, capq, w_cur[u]);
      float ea = __shfl_sync(repro::kFullMask, x, 0, W);
      float eo = __shfl_sync(repro::kFullMask, e_cur[u], 0, W);
#pragma unroll
      for (int i = 1; i < W; ++i) {
        const float a = ea + __shfl_sync(repro::kFullMask, x, i, W);
        const float o = eo + __shfl_sync(repro::kFullMask, e_cur[u], i, W);
        ea = i < n ? a : ea;
        eo = i < n ? o : eo;
      }
      scen_step(g, ea, eo, w_cur[u]);
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      e_cur[u] = e_nxt[u];
      w_cur[u] = w_nxt[u];
    }
  }
  if (real) lane_store(s, lane_out, lanes, off);
  if (scen < b && j == 0) scen_store(g, scen_out, b, scen);
}

// Wide route: one block per scenario, thread j is operator j (blockDim.x
// is N rounded up to whole warps).  Shared memory: served_prev, the
// ext_adm terms and the ext row, blockDim.x floats each.
__global__ void queue_window_wide_kernel(
    const float* __restrict__ q0, const float* __restrict__ sp0,
    const float* __restrict__ ext, const float* __restrict__ warm,
    const float* __restrict__ caps_g, const float* __restrict__ capq_g,
    const float* __restrict__ routing, float* __restrict__ lane_out,
    float* __restrict__ scen_out, int b, int n, int steps) {
  extern __shared__ float sh[];
  float* sp_s = sh;
  float* x_s = sh + blockDim.x;
  float* e_s = sh + 2 * blockDim.x;
  const int scen = blockIdx.x;
  const int j = threadIdx.x;
  const bool real = j < n;
  const size_t lanes = static_cast<size_t>(b) * n;
  const size_t off = static_cast<size_t>(scen) * n + j;
  const float* rcol = routing + static_cast<size_t>(scen) * n * n + j;  // [i * n]

  Lane s = lane_init(real ? q0[off] : 0.0f, real ? sp0[off] : 0.0f);
  const float caps = real ? caps_g[off] : 0.0f;
  const float capq = real ? capq_g[off] : 0.0f;
  Scen g{0.0f, 0.0f, 0.0f, 0.0f};
  sp_s[j] = s.sp;
  float e_next = (real && steps > 0) ? ext[off] : 0.0f;
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const float e = e_next;
    const float w = warm[t];
    if (real && t + 1 < steps) e_next = ext[(t + 1) * lanes + off];
    float routed = 0.0f;
    if (real) {
      routed = sp_s[0] * rcol[0];
      for (int i = 1; i < n; ++i) routed = routed + sp_s[i] * rcol[static_cast<size_t>(i) * n];
    }
    __syncthreads();  // every lane has read served_prev
    const float x = lane_step(s, e, routed, caps, capq, w);
    sp_s[j] = s.sp;
    x_s[j] = x;
    e_s[j] = e;
    __syncthreads();
    if (j == 0) {  // thread 0 reads x_s / e_s before it reaches the next barrier
      float ea = x_s[0], eo = e_s[0];
      for (int i = 1; i < n; ++i) {
        ea = ea + x_s[i];
        eo = eo + e_s[i];
      }
      scen_step(g, ea, eo, w);
    }
  }
  if (real) lane_store(s, lane_out, lanes, off);
  if (j == 0) scen_store(g, scen_out, b, scen);
}

__global__ void queue_step_kernel(const float* __restrict__ q,
                                  const float* __restrict__ inflow,
                                  const float* __restrict__ cap_serve,
                                  const float* __restrict__ cap_queue,
                                  float* __restrict__ q_next,
                                  float* __restrict__ served,
                                  float* __restrict__ dropped, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float qi = q[i];
  const float in = inflow[i];
  const float s = repro::nan_min(qi, cap_serve[i]);
  const float q1 = qi - s;
  const float space = repro::nan_max(cap_queue[i] - q1, 0.0f);
  const float adm = repro::nan_min(in, space);
  q_next[i] = q1 + adm;
  served[i] = s;
  dropped[i] = in - adm;
}

}  // namespace

extern "C" int repro_queue_step(const float* q, const float* inflow,
                                const float* cap_serve, const float* cap_queue,
                                float* q_next, float* served, float* dropped,
                                int m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0) {
    const int threads = 256;
    const int blocks = (m + threads - 1) / threads;
    queue_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        q, inflow, cap_serve, cap_queue, q_next, served, dropped, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// route 0: segment route of `width` lanes (8 or 32); 1: wide route,
// `width` threads per block.
extern "C" int repro_queue_window(const float* q, const float* sp, const float* ext,
                                  const float* warm, const float* caps, const float* capq,
                                  const float* routing, float* lane_out, float* scen_out,
                                  int b, int n, int steps, int route, int width, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 32;
  if (route == 0 && n <= width && (width == 8 || width == 32)) {
    const int warps = (b + 32 / width - 1) / (32 / width);
    const int blocks = (warps * 32 + kThreads - 1) / kThreads;
    if (width == 8) {
      queue_window_seg_kernel<8><<<blocks, kThreads, 0, st>>>(
          q, sp, ext, warm, caps, capq, routing, lane_out, scen_out, b, n, steps);
    } else {
      queue_window_seg_kernel<32><<<blocks, kThreads, 0, st>>>(
          q, sp, ext, warm, caps, capq, routing, lane_out, scen_out, b, n, steps);
    }
  } else if (route == 1 && n <= width && width % 32 == 0 && width <= 1024) {
    const size_t smem = 3 * static_cast<size_t>(width) * sizeof(float);
    queue_window_wide_kernel<<<b, width, smem, st>>>(q, sp, ext, warm, caps, capq, routing,
                                                     lane_out, scen_out, b, n, steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
