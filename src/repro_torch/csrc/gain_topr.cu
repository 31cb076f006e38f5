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
// Block route (gain_topr_kernel, larger tiles): one block of 256 threads
// per scenario, the 31 bisection steps as block-wide counts over the tile
// (re-read from L1 / L2 each pass), shared-memory atomics for the row
// counts and a serial scan over the operators.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // block route
constexpr int kWarpsPerBlock = 4;  // warp route: scenarios per block

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

__global__ void gain_topr_kernel(const float* __restrict__ cand,
                                 const int* __restrict__ budget,
                                 int* __restrict__ take, int n, int j) {
  extern __shared__ int smem[];
  int* pos_row = smem;          // [n]
  int* strict = smem + n;       // [n]
  int* ties = smem + 2 * n;     // [n]
  int* scratch = smem + 3 * n;  // [kThreads / 32]
  const int b = blockIdx.x;
  const int e = n * j;
  const float* x = cand + static_cast<size_t>(b) * e;
  const int bud = budget[b];

  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) smem[i] = 0;
  __syncthreads();

  int my_pos = 0;
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    if (x[i] > 0.0f) {
      atomicAdd(&pos_row[i / j], 1);
      ++my_pos;
    }
  }
  const int total_pos = repro::block_sum(my_pos, scratch);
  const bool use_all = total_pos <= bud;

  // Invariant: count(>= bits(lo)) >= budget > count(>= bits(hi)); the
  // span 0x7F800000 < 2^31 shrinks to 1 in 31 halvings, leaving bits(lo)
  // equal to the budget-th largest positive gain.
  int lo = 1;
  int hi = 0x7F800001;
  for (int it = 0; it < 31; ++it) {
    const int mid = lo + (hi - lo) / 2;
    const float t = __int_as_float(mid);
    int c = 0;
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      const float v = x[i];
      c += (v > 0.0f && v >= t) ? 1 : 0;
    }
    c = repro::block_sum(c, scratch);
    if (c >= bud) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float thresh = __int_as_float(lo);
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    const float v = x[i];
    if (v > 0.0f) {
      if (v > thresh) {
        atomicAdd(&strict[i / j], 1);
      } else if (v == thresh) {
        atomicAdd(&ties[i / j], 1);
      }
    }
  }
  __syncthreads();

  // Tie distribution: a serial exclusive scan over the operators.
  if (threadIdx.x == 0) {
    int strict_total = 0;
    for (int r = 0; r < n; ++r) strict_total += strict[r];
    const int rem = bud - strict_total;
    int before = 0;
    for (int r = 0; r < n; ++r) {
      const int t = ties[r];
      int extra = min(t, rem - before);
      if (extra < 0) extra = 0;
      const int tk = use_all ? pos_row[r] : strict[r] + extra;
      take[static_cast<size_t>(b) * n + r] = bud > 0 ? tk : 0;
      before += t;
    }
  }
}

template <int R>
cudaError_t launch_warp(const float* cand, const int* budget, int* take, int b, int n, int j,
                        cudaStream_t s) {
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gain_topr_warp_kernel<R><<<blocks, kWarpsPerBlock * 32, 0, s>>>(cand, budget, take, b, n, j);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gain_topr_smem_bytes(int n) {
  return static_cast<int>((3 * n + kThreads / 32) * sizeof(int));
}

// route 1: warp route with `slots` registers per lane (4, 8, 12 or 16);
// route 0: block route.
extern "C" int repro_gain_topr(const float* cand, const int* budget, int* take,
                               int b, int n, int j, int route, int slots, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const size_t smem = static_cast<size_t>(repro_gain_topr_smem_bytes(n));
    gain_topr_kernel<<<b, kThreads, smem, s>>>(cand, budget, take, n, j);
    return static_cast<int>(cudaGetLastError());
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
