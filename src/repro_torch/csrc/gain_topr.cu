// Batched masked top-R marginal-gain selection (Program 4).
//
// Replaces the Pallas TPU kernel `gain_topr_pallas`
// (src/repro/kernels/gain_topr/kernel.py, body `_gain_topr_kernel`):
// cand [B, N, J] float32 + budget [B] int32 -> take [B, N] int32, the
// number of each operator's gains among the budget largest positive
// gains of its scenario, threshold ties handed out in operator order:
//
//     thresh   = the budget-th largest positive gain
//     strict_r = #{x in row r : x > 0 && x > thresh},  ties_r likewise ==
//     take_r   = budget <= 0      ? 0
//              : positives <= budget ? pos_r            (use_all)
//              : strict_r + clamp(min(ties_r, budget - sum strict - ties before r), 0)
//
// Counts are ints (the Pallas kernel summed floats) and the tie prefix
// over operators is an exclusive scan, replacing the Pallas kernel's
// lower-triangular matmul.  Positive IEEE floats order like their int32
// bits, and +inf ranks above every finite gain as the sort-based plain
// version ranks it.  The threshold matters only where 0 < budget <
// positives; elsewhere the kernels skip the search.
//
// Warp route (gain_topr_warp_kernel, N <= 32 and N * J <= 512 = 32 lanes
// x 16 registers): one warp per scenario holds the whole tile in
// registers, 4 * ceil(N J / 128) values per lane (12 at the fleet's 7 x
// 48), loaded once, one coalesced float per lane and slot.  No block
// barrier: the threshold comes from a radix select, 4 rounds of 8 bits,
// each a 256-bin histogram per warp in shared memory (integer atomics)
// and a warp suffix scan to pick the bin holding the budget-th largest;
// the per-operator counts come from three ballots per register slot:
// lane r < N counts the bits of row r's lane range in each ballot, and
// the tie prefix is a __shfl_up_sync scan over the lanes 0..N-1.
//
// Grid route (larger tiles, any N): each scenario's tile spread over the
// grid, which a fleet planner's single scenario of thousands of rows x
// thousands of gains needs: one block per scenario would run it on one SM
// and keep per-row counts for thousands of rows in shared memory.  It is
// bound by the bytes of the tile, read four times (L2 holds a 10.6 MB
// tile between passes): on an H100 80GB HBM3 at 700 W that tile takes
// 38.7 us of device time against a 3.2 us bytes bound, [1, 5128, 2048]
// 89 us against 12.5 us (tools/kernel_plans.py gain_topr).  Five launches
// behind one call:
//  1-3. gain_topr_hist_kernel, a radix select over the positive gains'
//       bit patterns (positive floats order like their bits, bit 31 is
//       0): digits of bits 30..20, 19..9 and 8..0.  Each block builds the
//       digit histogram of its part of the tile in shared memory
//       (integer atomics) and adds it into the scenario's histogram in
//       global memory; the scenario's last block (a ticket counter after
//       a __threadfence) picks the bin holding the budget-th largest with
//       a block suffix scan, narrows the prefix, and clears the histogram
//       and the ticket for the next pass.  Pass 0's last block also counts
//       the positives and settles the scenarios that need no threshold
//       (budget <= 0: take 0; positives <= budget: take every positive),
//       which the later passes skip.
//  4.   gain_topr_rows_kernel: each warp counts a run of whole rows
//       (positives, > thresh, == thresh) as warp reductions.
//  5.   gain_topr_take_kernel: one 1024-thread block per scenario sums the
//       strict counts and hands the ties out by an exclusive block scan of
//       the per-row ties over the rows (row-major order).
// The workspace (int32, from the caller): the histograms [B, 2048] and the
// selection state [B, 4] (prefix, need, mode, ticket), cleared here with
// one cudaMemsetAsync, then the row counts [3, B, N].
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;  // warp route: scenarios per block
constexpr int kHistThreads = 256;  // grid route
constexpr int kBins = 2048;        // the widest digit (11 bits)
constexpr int kRowWarps = 8;       // grid route's row counts: warps per block
constexpr int kTakeThreads = 1024;
constexpr int kMaxRowBlocks = 1024;
constexpr int kMaxGridY = 65535;
enum Mode { kSelect = 0, kAll = 1, kNone = 2 };

// Bits a..bnd-1 of a lane mask, clipped to the warp.
__device__ __forceinline__ unsigned lane_range(int a, int bnd) {
  a = max(a, 0);
  bnd = min(bnd, 32);
  if (bnd <= a) return 0u;
  const unsigned hi = bnd == 32 ? 0xffffffffu : ((1u << bnd) - 1u);
  return hi & ~((1u << a) - 1u);
}

// The lanes whose slot-s element (index 32 s + lane) lies in [lo, hi).
__device__ __forceinline__ unsigned slot_lanes(int s, int lo, int hi) {
  return lane_range(lo - 32 * s, hi - 32 * s);
}

// The budget-th largest of the warp's positive values (v holds no NaN and
// no value <= 0: they are 0) by a 4-round 8-bit radix select over their
// bit patterns, most significant byte first; `hist` is the warp's 256
// bins.  Needs 0 < need <= positives.
template <int R>
__device__ __forceinline__ float radix_select(const float (&v)[R], int need, int* hist,
                                              int lane) {
  unsigned prefix = 0u;
  for (int round = 0; round < 4; ++round) {
    const int shift = 24 - 8 * round;
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const unsigned u = __float_as_uint(v[s]);
      const bool match =
          v[s] > 0.0f && (round == 0 || (u >> (shift + 8)) == (prefix >> (shift + 8)));
      if (match) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncwarp();
    int c[8];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[k] = hist[8 * lane + k];
      sum += c[k];
    }
    int suffix = sum;  // values in this lane's bins and every higher lane's
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(repro::kFullMask, suffix, off);
      if (lane + off < 32) suffix += y;
    }
    const int above = suffix - sum;
    const bool mine = above < need && suffix >= need;
    const int src = __ffs(__ballot_sync(repro::kFullMask, mine)) - 1;
    int bin = 0, rest = 0;
    if (mine) {
      int acc = above;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        if (acc + c[k] >= need) {
          bin = 8 * lane + k;
          rest = need - acc;
          break;
        }
        acc += c[k];
      }
    }
    bin = __shfl_sync(repro::kFullMask, bin, src);
    need = __shfl_sync(repro::kFullMask, rest, src);
    prefix |= static_cast<unsigned>(bin) << shift;
    __syncwarp();  // every lane has read the bins before the next round clears them
  }
  return __uint_as_float(prefix);
}

template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gain_topr_warp_kernel(const float* __restrict__ cand, const int* __restrict__ budget,
                      int* __restrict__ take, int b, int n, int j) {
  __shared__ int hist_all[kWarpsPerBlock][256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int scen = blockIdx.x * kWarpsPerBlock + warp;
  if (scen >= b) return;  // the whole warp
  const int e = n * j;
  const float* x = cand + static_cast<size_t>(scen) * e;

  float v[R];  // positive gains as they are, every other value as 0
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = 32 * s + lane;
    const float f = i < e ? x[i] : 0.0f;
    v[s] = f > 0.0f ? f : 0.0f;
  }
  const int bud = budget[scen];
  int my_pos = 0;
#pragma unroll
  for (int s = 0; s < R; ++s) my_pos += v[s] > 0.0f ? 1 : 0;
  const int total_pos = __reduce_add_sync(repro::kFullMask, my_pos);
  const bool use_all = total_pos <= bud;

  float thresh = __int_as_float(0x7f800000);
  if (bud > 0 && !use_all) {  // the same for the whole warp
    thresh = radix_select<R>(v, bud, hist_all[warp], lane);
  }
  int strict = 0, ties = 0, pos = 0;  // of row `lane`
  const int lo = lane * j, hi = lo + j;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const unsigned m_pos = __ballot_sync(repro::kFullMask, v[s] > 0.0f);
    const unsigned m_str = __ballot_sync(repro::kFullMask, v[s] > 0.0f && v[s] > thresh);
    const unsigned m_tie = __ballot_sync(repro::kFullMask, v[s] > 0.0f && v[s] == thresh);
    const unsigned row = lane < n ? slot_lanes(s, lo, hi) : 0u;
    pos += __popc(m_pos & row);
    strict += __popc(m_str & row);
    ties += __popc(m_tie & row);
  }
  int incl = ties;  // inclusive scan over operators 0..lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(repro::kFullMask, incl, off);
    if (lane >= off) incl += y;
  }
  const int rem = bud - __reduce_add_sync(repro::kFullMask, strict);
  const int extra = max(min(ties, rem - (incl - ties)), 0);
  const int tk = use_all ? pos : strict + extra;
  if (lane < n) take[static_cast<size_t>(scen) * n + lane] = bud > 0 ? tk : 0;
}

// Inclusive suffix sum over the block's threads (thread t gets the sum of
// threads t..blockDim-1); the block_sum contract of common.cuh.
__device__ __forceinline__ int block_suffix_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(repro::kFullMask, x, off);
    if (lane + off < 32) x += y;
  }
  __syncthreads();
  if (lane == 0) scratch[warp] = x;  // the warp's total
  __syncthreads();
  int base = 0;
  const int n_warps = blockDim.x >> 5;
  for (int w = warp + 1; w < n_warps; ++w) base += scratch[w];
  return base + x;
}

// One radix pass of the grid route over `nb` = gridDim.x blocks per
// scenario.  `state` per scenario: prefix bits, need (the rank still to
// find among the values matching the prefix), mode, ticket.
__global__ void __launch_bounds__(kHistThreads)
gain_topr_hist_kernel(const float* __restrict__ cand, const int* __restrict__ budget,
                      int* __restrict__ hist, int* __restrict__ state, int b, long long e,
                      int pass) {
  __shared__ int h[kBins];
  __shared__ int scratch[kHistThreads / 32];
  __shared__ int last;
  const int shift = pass == 0 ? 20 : (pass == 1 ? 9 : 0);
  const int bins = pass == 2 ? 512 : kBins;
  const int above_shift = pass == 1 ? 20 : 9;  // the bits the prefix fixes
  for (int scen = blockIdx.y; scen < b; scen += gridDim.y) {
    int* st = state + 4 * static_cast<size_t>(scen);
    if (pass > 0 && __ldcg(&st[2]) != kSelect) continue;  // settled: block-uniform
    const unsigned prefix = pass == 0 ? 0u : static_cast<unsigned>(__ldcg(&st[0]));
    for (int i = threadIdx.x; i < bins; i += blockDim.x) h[i] = 0;
    __syncthreads();
    const float* x = cand + static_cast<size_t>(scen) * e;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < e;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
      const float v = x[i];
      if (v > 0.0f) {
        const unsigned u = __float_as_uint(v);
        if (pass == 0 || (u >> above_shift) == (prefix >> above_shift)) {
          atomicAdd(&h[(u >> shift) & static_cast<unsigned>(bins - 1)], 1);
        }
      }
    }
    __syncthreads();
    int* gh = hist + static_cast<size_t>(scen) * kBins;
    for (int i = threadIdx.x; i < bins; i += blockDim.x) {
      if (h[i]) atomicAdd(&gh[i], h[i]);
    }
    __threadfence();  // this block's histogram before its ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&st[3], 1) == static_cast<int>(gridDim.x) - 1;
    __syncthreads();
    if (!last) continue;
    __threadfence();  // every block's histogram before the reads below
    // The scenario's last block: thread t owns bins [per t, per t + per).
    const int per = bins / kHistThreads;
    int c[kBins / kHistThreads];
    int sum = 0;
    for (int k = 0; k < per; ++k) {
      c[k] = __ldcg(&gh[per * threadIdx.x + k]);
      sum += c[k];
    }
    const int suffix = block_suffix_sum(sum, scratch);  // values in bins >= per t
    int need;
    int mode = kSelect;
    if (pass == 0) {
      const int total = repro::block_sum(sum, scratch);
      const int bud = budget[scen];
      need = bud;
      mode = bud <= 0 ? kNone : (total <= bud ? kAll : kSelect);
    } else {
      need = __ldcg(&st[1]);
    }
    const int above = suffix - sum;
    if (mode == kSelect && above < need && suffix >= need) {  // exactly one thread
      int acc = above;
      for (int k = per - 1; k >= 0; --k) {
        if (acc + c[k] >= need) {
          st[0] = static_cast<int>(prefix | (static_cast<unsigned>(per * threadIdx.x + k)
                                             << shift));
          st[1] = need - acc;
          break;
        }
        acc += c[k];
      }
    }
    for (int k = 0; k < per; ++k) gh[per * threadIdx.x + k] = 0;
    if (threadIdx.x == 0) {
      st[2] = mode;
      st[3] = 0;
    }
  }
}

// Per-row counts of the grid route: warp w of the grid takes rows [w rpw,
// w rpw + rpw), lanes striding the row's gains.
__global__ void __launch_bounds__(kRowWarps * 32)
gain_topr_rows_kernel(const float* __restrict__ cand, const int* __restrict__ state,
                      int* __restrict__ counts, int b, int n, int j) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int total_warps = gridDim.x * kRowWarps;
  const int rpw = (n + total_warps - 1) / total_warps;
  const int r0 = gw * rpw;
  const int r1 = min(n, r0 + rpw);
  const size_t bn = static_cast<size_t>(b) * n;
  for (int scen = blockIdx.y; scen < b; scen += gridDim.y) {
    const int* st = state + 4 * static_cast<size_t>(scen);
    const int mode = __ldcg(&st[2]);
    if (mode == kNone) continue;
    const float thresh = mode == kAll ? __int_as_float(0x7f800000)
                                      : __uint_as_float(static_cast<unsigned>(__ldcg(&st[0])));
    for (int r = r0; r < r1; ++r) {
      const float* x = cand + (static_cast<size_t>(scen) * n + r) * j;
      int pos = 0, strict = 0, ties = 0;
      for (int col = lane; col < j; col += 32) {
        const float v = x[col];
        if (v > 0.0f) {
          ++pos;
          strict += v > thresh ? 1 : 0;
          ties += v == thresh ? 1 : 0;
        }
      }
      pos = __reduce_add_sync(repro::kFullMask, pos);
      strict = __reduce_add_sync(repro::kFullMask, strict);
      ties = __reduce_add_sync(repro::kFullMask, ties);
      if (lane == 0) {
        const size_t at = static_cast<size_t>(scen) * n + r;
        counts[at] = strict;
        counts[bn + at] = ties;
        counts[2 * bn + at] = pos;
      }
    }
  }
}

// The takes of the grid route: thread t of a scenario's block owns a run
// of ceil(N / 1024) rows.
__global__ void __launch_bounds__(kTakeThreads)
gain_topr_take_kernel(const int* __restrict__ budget, const int* __restrict__ state,
                      const int* __restrict__ counts, int* __restrict__ take, int b, int n) {
  __shared__ int scratch[kTakeThreads / 32];
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int r0 = min(n, static_cast<int>(threadIdx.x) * chunk);
  const int r1 = min(n, r0 + chunk);
  const size_t bn = static_cast<size_t>(b) * n;
  for (int scen = blockIdx.x; scen < b; scen += gridDim.x) {
    const int mode = __ldcg(&state[4 * static_cast<size_t>(scen) + 2]);
    const size_t row0 = static_cast<size_t>(scen) * n;
    const int* strict = counts + row0;
    const int* ties = counts + bn + row0;
    const int* pos = counts + 2 * bn + row0;
    int s = 0, t = 0;
    if (mode == kSelect) {
      for (int r = r0; r < r1; ++r) {
        s += strict[r];
        t += ties[r];
      }
    }
    const int rem = budget[scen] - repro::block_sum(s, scratch);
    int before = repro::block_exclusive_scan(t, scratch);  // ties of rows < r0
    for (int r = r0; r < r1; ++r) {
      int tk = 0;
      if (mode == kAll) {
        tk = pos[r];
      } else if (mode == kSelect) {
        tk = strict[r] + max(min(ties[r], rem - before), 0);
        before += ties[r];
      }
      take[row0 + r] = tk;
    }
  }
}

cudaError_t launch_grid(const float* cand, const int* budget, int* take, int* work, int b,
                        int n, int j, int nb, cudaStream_t s) {
  int* hist = work;
  int* state = work + static_cast<size_t>(b) * kBins;
  int* counts = state + static_cast<size_t>(b) * 4;
  cudaError_t err = cudaMemsetAsync(
      work, 0, static_cast<size_t>(b) * (kBins + 4) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const long long e = static_cast<long long>(n) * j;
  const int gy = min(b, kMaxGridY);
  for (int pass = 0; pass < 3; ++pass) {
    gain_topr_hist_kernel<<<dim3(nb, gy), kHistThreads, 0, s>>>(cand, budget, hist, state, b,
                                                                 e, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int rb = min((n + kRowWarps - 1) / kRowWarps, kMaxRowBlocks);
  gain_topr_rows_kernel<<<dim3(rb, gy), kRowWarps * 32, 0, s>>>(cand, state, counts, b, n, j);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gain_topr_take_kernel<<<gy, kTakeThreads, 0, s>>>(budget, state, counts, take, b, n);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_warp(const float* cand, const int* budget, int* take, int b, int n, int j,
                        cudaStream_t s) {
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gain_topr_warp_kernel<R><<<blocks, kWarpsPerBlock * 32, 0, s>>>(cand, budget, take, b, n, j);
  return cudaGetLastError();
}

}  // namespace

// Workspace of the grid route, in int32 elements.
extern "C" long long repro_gain_topr_work_ints(int b, int n) {
  return static_cast<long long>(b) * (kBins + 4 + 3LL * n);
}

// route 1: warp route with `slots` registers per lane (4, 8, 12 or 16);
// route 2: grid route with `slots` blocks per scenario for the radix passes
// and `work` its workspace (repro_gain_topr_work_ints elements).
extern "C" int repro_gain_topr(const float* cand, const int* budget, int* take, int* work,
                               int b, int n, int j, int route, int slots, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (slots < 1 || work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_grid(cand, budget, take, work, b, n, j, slots, s));
  }
  if (route != 1 || n > 32 || n * j > 32 * slots) return static_cast<int>(cudaErrorInvalidValue);
  switch (slots) {
    case 4: err = launch_warp<4>(cand, budget, take, b, n, j, s); break;
    case 8: err = launch_warp<8>(cand, budget, take, b, n, j, s); break;
    case 12: err = launch_warp<12>(cand, budget, take, b, n, j, s); break;
    case 16: err = launch_warp<16>(cand, budget, take, b, n, j, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
