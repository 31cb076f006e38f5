// The whole batch decide for one scenario in one pass.
//
// Replaces the Pallas TPU kernel `batch_decide_pallas`
// (src/repro/kernels/decide_fused/kernel.py, body `_decide_fused_kernel`):
// solved rates [B, N] -> (k4, k_start, T[k_cur], T[k4]).  Per scenario:
//
// 1. Recurrence over k = 1..k_hi: the Erlang-B row, the Erlang-C replica
//    sojourn (or the M/M/1 sojourn at mu*k*eff(k) for gang lanes) into
//    T[k], and the Algorithm-1 gain G[k-1] = lam * (T[k-1] - T[k]).
// 2. k_start = first finite T row (k_hi + 1 marks an infeasible active
//    lane), budget = max(k_max - sum k_start, 0).
// 3. Program 4 inside each lane's window [k_start, k_start + j_cap): the
//    budget-th largest positive gain by 31 bisection steps over float32
//    bit patterns (the gain_topr technique), strict + tie counts, ties
//    handed out in operator order by an exclusive scan over lanes.
// 4. The gathers T[k_cur] and T[k4].
//
// Both routes evaluate each table cell with one function, sojourn_cell;
// built with -fmad=false and with every division correctly rounded, it
// rounds exactly like the plain PyTorch version's separate elementwise
// ops.
//
// Bound on the H100: ~25 float ops per table cell plus the selection; the
// tables never reach device memory, so the kernel moves only 10 floats
// per lane and is operation-bound.  What holds it back is latency: each
// cell is a chain of dependent divisions, and the float division's slow
// path (taken where B(k) nears underflow) made the table most of the
// time; the first design (one 32-thread block per scenario) also left 25
// of 32 lanes idle at N = 7, and its 31 bisection steps each re-scanned
// the window and took two block barriers.  The cell now runs 6 divisions
// instead of 10, in double, off the slow path (`repro::div_rn`,
// common.cuh).
//
// Packed route (decide_packed_kernel, N <= 32): scenarios sit in warp
// segments of W = 8 lanes up to N = 8 (at the fleet's N = 7: four
// scenarios per warp, 7 of 8 lanes busy) and W = 32 past it, one warp per
// block.  Every reduction is a segmented __shfl_xor_sync and the
// operator-order tie scan a segmented __shfl_up_sync: no block barrier, no
// scratch.  Selection and gathers read G only in [k_start, k_start +
// j_cap) and T only at k_cur and k4 <= k_start + j_cap, so each lane keeps
// T[k_cur] (and T[k_hi]) in registers and stores only the window, from its
// first finite row, into a shared column: (2 j_cap + 1) floats per lane.
// A lane stops the recurrence once it has its window and T[k_cur].  The
// window's positive gains are sorted in place (insertion sort: gains are
// non-increasing but for rounding, so it is about linear), and each
// bisection step counts a lane's gains >= t by binary search instead of a
// scan.  The bisection's threshold is the budget-th largest positive gain
// whenever it is used (0 < budget < positives), the same value the scan
// found.
//
// Wide route (decide_fused_kernel, N > 32): one block per scenario, one
// thread per operator lane (N padded to the warp width), the whole T and
// G tables in dynamic shared memory, ((k_hi + 1) + k_hi) * N_pad * 4
// bytes, block reductions through shared scratch.
#include "common.cuh"

namespace {

// T[k] for one lane at k servers (kf = k >= 1); carries the Erlang-B value
// B(k) in b_prev (B(0) = 1).  Replica lanes take the Erlang-C sojourn,
//   bb = ab / (k + ab), c = k bb / (k - a (1 - bb)),
//   T = c / (k mu - lam) + 1 / mu   (inf unless k > a);
// gang lanes the M/M/1 sojourn at mug = mu k eff, eff = 1 / (1 + alpha (k - 1)),
//   ag = lam / mug, bg = ag / (1 + ag), cg = bg / (1 - ag (1 - bg)),
//   T = cg / (mug - lam) + 1 / mug   (inf unless ag < 1).
// The two formulas share four divisions, q1..q4, whose operands each lane
// picks by its kind: a lane performs exactly the operations of its own
// formula, in the plain version's order, and never the other's.
__device__ __forceinline__ float sojourn_cell(float kf, float lam, float mu, float a_rep,
                                              float alpha, bool grp, float& b_prev) {
  const float inf = __int_as_float(0x7f800000);
  const float ab = a_rep * b_prev;
  // q1 = eff | bb, q2 = ag | c, q3 = bg | c / (k mu - lam), q4 = cg | 1 / mu.
  const float q1 = repro::div_rn(grp ? 1.0f : ab, grp ? 1.0f + alpha * (kf - 1.0f) : kf + ab);
  const float mug = mu * kf * q1;
  const float q2 = repro::div_rn(grp ? lam : kf * q1, grp ? mug : kf - a_rep * (1.0f - q1));
  const float q3 = repro::div_rn(q2, grp ? 1.0f + q2 : kf * mu - lam);
  const float q4 = repro::div_rn(grp ? q3 : 1.0f, grp ? 1.0f - q2 * (1.0f - q3) : mu);
  b_prev = q1;
  if (!grp) return kf > a_rep ? q3 + q4 : inf;
  const float t = repro::div_rn(q4, mug - lam) + repro::div_rn(1.0f, mug);
  return q2 < 1.0f ? t : inf;
}

// G[k-1] from T[k-1] and T[k].
__device__ __forceinline__ float gain(float lam, float t_prev, float t) {
  return isfinite(t_prev) ? lam * (t_prev - t) : __int_as_float(0x7f800000);
}

__global__ void decide_fused_kernel(
    const float* __restrict__ lam_g, const float* __restrict__ mu_g,
    const unsigned char* __restrict__ grp_g, const float* __restrict__ alpha_g,
    const unsigned char* __restrict__ act_g, const int* __restrict__ kcur_g,
    const int* __restrict__ kmax_g, int* __restrict__ k4_g,
    int* __restrict__ kst_g, float* __restrict__ tcur_g,
    float* __restrict__ t4_g, int n, int k_hi, int j_cap) {
  extern __shared__ float tables[];
  __shared__ int scratch[32];
  const int n_pad = blockDim.x;
  float* T = tables;                                           // [(k_hi+1), n_pad]
  float* G = tables + static_cast<size_t>(k_hi + 1) * n_pad;   // [k_hi, n_pad]

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const bool real = lane < n;
  const size_t off = static_cast<size_t>(b) * n + lane;
  const float lam = real ? lam_g[off] : 0.0f;
  const float mu = real ? mu_g[off] : 1.0f;
  const bool grp = real && grp_g[off] != 0;
  const float alpha = real ? alpha_g[off] : 0.0f;
  const bool act = real && act_g[off] != 0;
  const int kcur = real ? kcur_g[off] : 0;
  const float inf = __int_as_float(0x7f800000);

  // 1. Table recurrence (k = 0 is never feasible: min_k = 1).
  const float a_rep = lam / mu;
  float b_prev = 1.0f;
  float t_prev = inf;
  int first = k_hi + 1;
  T[lane] = inf;
  for (int k = 1; k <= k_hi; ++k) {
    const float t = sojourn_cell(static_cast<float>(k), lam, mu, a_rep, alpha, grp, b_prev);
    T[static_cast<size_t>(k) * n_pad + lane] = t;
    G[static_cast<size_t>(k - 1) * n_pad + lane] = gain(lam, t_prev, t);
    if (first > k_hi && isfinite(t)) first = k;
    t_prev = t;
  }

  // 2. Floor and budget.
  const int kst = act ? first : 0;
  const int floor_total = repro::block_sum(kst, scratch);
  const int bud = max(kmax_g[b] - floor_total, 0);

  // 3. Program 4 over the lane's window (empty for inactive and
  //    infeasible lanes).
  const int w_lo = kst;
  const int w_hi = act ? min(kst + j_cap, k_hi) : kst;
  int pos_row = 0;
  for (int k = w_lo; k < w_hi; ++k) {
    const float g = G[static_cast<size_t>(k) * n_pad + lane];
    pos_row += (isfinite(g) && g > 0.0f) ? 1 : 0;
  }
  const int total_pos = repro::block_sum(pos_row, scratch);
  const bool use_all = total_pos <= bud;

  int lo = 1;
  int hi = 0x7F800001;
  for (int it = 0; it < 31; ++it) {
    const int mid = lo + (hi - lo) / 2;
    const float t = __int_as_float(mid);
    int c = 0;
    for (int k = w_lo; k < w_hi; ++k) {
      const float g = G[static_cast<size_t>(k) * n_pad + lane];
      c += (isfinite(g) && g > 0.0f && g >= t) ? 1 : 0;
    }
    c = repro::block_sum(c, scratch);
    if (c >= bud) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float thresh = __int_as_float(lo);
  int strict = 0;
  int ties = 0;
  for (int k = w_lo; k < w_hi; ++k) {
    const float g = G[static_cast<size_t>(k) * n_pad + lane];
    if (isfinite(g) && g > 0.0f) {
      strict += (g > thresh) ? 1 : 0;
      ties += (g == thresh) ? 1 : 0;
    }
  }
  const int rem = bud - repro::block_sum(strict, scratch);
  const int before = repro::block_exclusive_scan(ties, scratch);
  const int extra = max(min(ties, rem - before), 0);
  int take = use_all ? pos_row : strict + extra;
  if (bud <= 0) take = 0;
  const int k4 = kst + take;

  // 4. Gathers by index.
  const int k4c = min(max(k4, 0), k_hi);
  const int kcc = min(max(kcur, 0), k_hi);
  if (real) {
    k4_g[off] = k4;
    kst_g[off] = kst;
    tcur_g[off] = T[static_cast<size_t>(kcc) * n_pad + lane];
    t4_g[off] = T[static_cast<size_t>(k4c) * n_pad + lane];
  }
}

// Segmented reductions over the W lanes of one scenario (W = 8 or 32);
// every lane of the warp must call them.
template <int W>
__device__ __forceinline__ int seg_sum(int v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v += __shfl_xor_sync(repro::kFullMask, v, off, W);
  return v;
}
template <int W>
__device__ __forceinline__ int seg_exclusive_scan(int v, int l) {
  int x = v;
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    const int y = __shfl_up_sync(repro::kFullMask, x, off, W);
    if (l >= off) x += y;
  }
  return x - v;
}

// Gains >= t (or > t) in a lane's window, sorted non-increasing in a
// shared column of stride 32.
__device__ __forceinline__ int count_ge(const float* h, int len, float t) {
  int lo = 0;
  int hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (h[mid * 32] >= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}
__device__ __forceinline__ int count_gt(const float* h, int len, float t) {
  int lo = 0;
  int hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (h[mid * 32] > t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int W>
__global__ void decide_packed_kernel(
    const float* __restrict__ lam_g, const float* __restrict__ mu_g,
    const unsigned char* __restrict__ grp_g, const float* __restrict__ alpha_g,
    const unsigned char* __restrict__ act_g, const int* __restrict__ kcur_g,
    const int* __restrict__ kmax_g, int* __restrict__ k4_g,
    int* __restrict__ kst_g, float* __restrict__ tcur_g,
    float* __restrict__ t4_g, int b, int n, int k_hi, int j_cap) {
  extern __shared__ float windows[];  // per warp: G [j_cap][32], then T [j_cap + 1][32]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane % W;  // operator lane within the scenario
  const int scen = (blockIdx.x * (blockDim.x >> 5) + warp) * (32 / W) + lane / W;
  const bool real = scen < b && l < n;
  float* h = windows + static_cast<size_t>(warp) * (2 * j_cap + 1) * 32 + lane;
  float* tw = h + static_cast<size_t>(j_cap) * 32;

  const size_t off = static_cast<size_t>(scen) * n + l;
  const float lam = real ? lam_g[off] : 0.0f;
  const float mu = real ? mu_g[off] : 1.0f;
  const bool grp = real && grp_g[off] != 0;
  const float alpha = real ? alpha_g[off] : 0.0f;
  const bool act = real && act_g[off] != 0;
  const int kcc = real ? min(max(kcur_g[off], 0), k_hi) : 0;
  const float inf = __int_as_float(0x7f800000);

  // 1. The recurrence, keeping T rows [first, first + j_cap] and the
  //    window's gains (positive finite ones; 0 for the rest, which no
  //    count takes) from the first finite row on.
  const float a_rep = lam / mu;
  float b_prev = 1.0f;
  float t_prev = inf;  // T[k - 1]; T[k_hi] once the loop has run out
  float tcur = inf;    // T[k_cur]; T[0] = inf
  int first = k_hi + 1;
  if (real) {
    for (int k = 1; k <= k_hi; ++k) {
      const float t = sojourn_cell(static_cast<float>(k), lam, mu, a_rep, alpha, grp, b_prev);
      const float g = gain(lam, t_prev, t);
      if (first > k_hi && isfinite(t)) first = k;
      const int wk = k - first;  // window row of T[k]; negative before the first finite row
      if (wk >= 1 && wk <= j_cap) h[(wk - 1) * 32] = (isfinite(g) && g > 0.0f) ? g : 0.0f;
      if (wk >= 0 && wk <= j_cap) tw[wk * 32] = t;
      if (k == kcc) tcur = t;
      t_prev = t;
      if ((wk >= j_cap || !act) && k >= kcc) break;  // no later row is read
    }
  }

  // 2. Floor and budget.
  const int kst = act ? first : 0;
  const int floor_total = seg_sum<W>(kst);
  const int bud = scen < b ? max(kmax_g[scen] - floor_total, 0) : 0;

  // 3. Program 4 over the lane's window [kst, min(kst + j_cap, k_hi)).
  const int len = act ? max(min(first + j_cap, k_hi) - first, 0) : 0;
  for (int x = 1; x < len; ++x) {  // sort the window non-increasing
    const float v = h[x * 32];
    int y = x - 1;
    while (y >= 0 && h[y * 32] < v) {
      h[(y + 1) * 32] = h[y * 32];
      --y;
    }
    h[(y + 1) * 32] = v;
  }
  const int pos_row = count_gt(h, len, 0.0f);
  const bool use_all = seg_sum<W>(pos_row) <= bud;
  int lo = 1;
  if (__any_sync(repro::kFullMask, !use_all && bud > 0)) {
    int hi = 0x7F800001;
    for (int it = 0; it < 31; ++it) {
      const int mid = lo + (hi - lo) / 2;
      if (seg_sum<W>(count_ge(h, len, __int_as_float(mid))) >= bud) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
  }
  const float thresh = __int_as_float(lo);
  const int strict = count_gt(h, len, thresh);
  const int ties = count_ge(h, len, thresh) - strict;
  const int rem = bud - seg_sum<W>(strict);
  const int before = seg_exclusive_scan<W>(ties, l);
  const int extra = max(min(ties, rem - before), 0);
  int take = use_all ? pos_row : strict + extra;
  if (bud <= 0) take = 0;
  const int k4 = kst + take;

  // 4. Gathers: k4 lies in the window for an active feasible lane, is 0
  //    (T[0] = inf) for an inactive one and k_hi + 1 (clamped to k_hi)
  //    for an infeasible one.
  const int k4c = min(max(k4, 0), k_hi);
  if (real) {
    k4_g[off] = k4;
    kst_g[off] = kst;
    tcur_g[off] = tcur;
    t4_g[off] = k4c == 0 ? inf : k4c >= first ? tw[(k4c - first) * 32] : t_prev;
  }
}

// A block's shared-memory ceiling on the H100.  The limit is raised once to
// all of it: the tables' size changes from call to call with k_hi / j_cap.
constexpr int kSmemOptin = 232448;

template <int W>
cudaError_t launch_packed(const float* lam, const float* mu, const unsigned char* grp,
                          const float* alpha, const unsigned char* act, const int* kcur,
                          const int* kmax, int* k4, int* kst, float* tcur, float* t4, int b,
                          int n, int k_hi, int j_cap, int threads, int device,
                          cudaStream_t s) {
  static bool ready[16];
  const int smem = (2 * j_cap + 1) * threads * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        repro::allow_smem(decide_packed_kernel<W>, kSmemOptin, device, ready);
    if (err != cudaSuccess) return err;
  }
  const int per_block = threads / W;  // scenarios
  decide_packed_kernel<W><<<(b + per_block - 1) / per_block, threads, smem, s>>>(
      lam, mu, grp, alpha, act, kcur, kmax, k4, kst, tcur, t4, b, n, k_hi, j_cap);
  return cudaGetLastError();
}

}  // namespace

// `width` is the packed route's segment width (8 or 32), with
// `threads` (whole warps) per block; width 0 takes the wide route with
// `threads` (N padded to whole warps) per scenario.
extern "C" int repro_decide_fused(const float* lam, const float* mu,
                                  const unsigned char* grp, const float* alpha,
                                  const unsigned char* act, const int* kcur,
                                  const int* kmax, int* k4, int* kst,
                                  float* tcur, float* t4, int b, int n, int k_hi,
                                  int j_cap, int width, int threads, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PACKED(W)                                                                     \
  case W:                                                                                   \
    err = launch_packed<W>(lam, mu, grp, alpha, act, kcur, kmax, k4, kst, tcur, t4, b, n, \
                           k_hi, j_cap, threads, device, s);                                \
    break;
  switch (width) {
    REPRO_PACKED(8)
    REPRO_PACKED(32)
    case 0: {
      static bool ready[16];
      const int smem = (2 * k_hi + 1) * threads * static_cast<int>(sizeof(float));
      if (smem > 48 * 1024) {
        err = repro::allow_smem(decide_fused_kernel, kSmemOptin - 32 * 4, device, ready);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      decide_fused_kernel<<<b, threads, smem, s>>>(lam, mu, grp, alpha, act, kcur, kmax, k4,
                                                 kst, tcur, t4, n, k_hi, j_cap);
      err = cudaGetLastError();
      break;
    }
    default:
      err = cudaErrorInvalidValue;
  }
#undef REPRO_PACKED
  return static_cast<int>(err);
}
