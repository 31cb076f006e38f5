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
// 4. The gathers T[k_cur] and T[k4], by index.
//
// Design: one block per scenario, one thread per operator lane, N padded
// to the warp width (the Pallas kernel's 128-lane padding is a TPU layout
// artefact).  The T and G tables live in dynamic shared memory,
// ((k_hi + 1) + k_hi) * N_pad * 4 bytes: 12.4 KB at the main path's
// k_hi = 48, N_pad = 32, and 131 KB at k_hi = 512, N = 32, past the
// 48 KB default, so the launcher opts in through
// cudaFuncAttributeMaxDynamicSharedMemorySize.  Inf rows ride through the
// gathers intact because they read T by index, not by a one-hot sum.
// Built with -fmad=false and IEEE division, the division chain rounds
// exactly like the plain PyTorch version's separate elementwise ops.
//
// Bound on the H100: ~25 float ops per table cell (divisions counted
// once) plus 31 bisection passes over the j_cap window; the tables never
// reach device memory, so the kernel moves only 10 floats per lane and is
// operation-bound.  The bisection's 31 block reductions are latency, not
// throughput: at N = 7 three quarters of each warp idles.  Packing several
// scenarios into one block is later work.
#include "common.cuh"

namespace {

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
    const float kf = static_cast<float>(k);
    const float ab = a_rep * b_prev;
    const float bb = ab / (kf + ab);
    const float c = kf * bb / (kf - a_rep * (1.0f - bb));
    float t_rep = c / (kf * mu - lam) + 1.0f / mu;
    if (!(kf > a_rep)) t_rep = inf;
    const float eff = 1.0f / (1.0f + alpha * (kf - 1.0f));
    const float mug = mu * kf * eff;
    const float ag = lam / mug;
    const float bg = ag / (1.0f + ag);
    const float cg = bg / (1.0f - ag * (1.0f - bg));
    float t_grp = cg / (mug - lam) + 1.0f / mug;
    if (!(ag < 1.0f)) t_grp = inf;
    const float t = grp ? t_grp : t_rep;
    T[static_cast<size_t>(k) * n_pad + lane] = t;
    G[static_cast<size_t>(k - 1) * n_pad + lane] =
        isfinite(t_prev) ? lam * (t_prev - t) : inf;
    if (first > k_hi && isfinite(t)) first = k;
    b_prev = bb;
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

}  // namespace

extern "C" long long repro_decide_fused_smem_bytes(int n_pad, int k_hi) {
  return static_cast<long long>(2 * k_hi + 1) * n_pad * static_cast<long long>(sizeof(float));
}

extern "C" int repro_decide_fused(const float* lam, const float* mu,
                                  const unsigned char* grp, const float* alpha,
                                  const unsigned char* act, const int* kcur,
                                  const int* kmax, int* k4, int* kst,
                                  float* tcur, float* t4, int b, int n,
                                  int n_pad, int k_hi, int j_cap, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const long long smem = repro_decide_fused_smem_bytes(n_pad, k_hi);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decide_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decide_fused_kernel<<<b, n_pad, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      lam, mu, grp, alpha, act, kcur, kmax, k4, kst, tcur, t4, n, k_hi, j_cap);
  return static_cast<int>(cudaGetLastError());
}
