// Batched masked top-R marginal-gain selection (Program 4).
//
// Replaces the Pallas TPU kernel `gain_topr_pallas`
// (src/repro/kernels/gain_topr/kernel.py, body `_gain_topr_kernel`):
// cand [B, N, J] float32 + budget [B] int32 -> take [B, N] int32, the
// number of each operator's gains among the budget largest positive
// gains of its scenario, threshold ties handed out in operator order.
//
// Design: one block per scenario.  The budget-th largest positive gain is
// pinned by 31 bisection steps over float32 bit patterns (positive IEEE
// floats order like their int32 bits), each step one block-wide integer
// count of `x > 0 && x >= t`.  Counts are ints (the Pallas kernel summed
// floats), the per-operator strict/tie counts use shared-memory integer
// atomics, and the tie prefix over operators is an exclusive scan --
// replacing the Pallas kernel's lower-triangular matmul.  The upper
// bisection bound is one past +inf's bit pattern, so an infinite gain is
// ranked like the sort-based plain version ranks it.
//
// Bound on the H100: 34 passes over the tile (total, 31 steps, final
// counts) of ~2 ops per element; at the main path's 4096 x 7 x 48 tile
// that is ~1e8 operations and 5.5 MB, so the kernel sits near the point
// where bytes and operations cost the same.  The tile is re-read from L1
// / L2 on every pass; keeping it in registers or shared memory is later
// work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

  // Tie distribution: a serial exclusive scan over the (few) operators.
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

}  // namespace

extern "C" int repro_gain_topr_smem_bytes(int n) {
  return static_cast<int>((3 * n + kThreads / 32) * sizeof(int));
}

extern "C" int repro_gain_topr(const float* cand, const int* budget, int* take,
                               int b, int n, int j, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b > 0 && n > 0) {
    const size_t smem = static_cast<size_t>(repro_gain_topr_smem_bytes(n));
    gain_topr_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        cand, budget, take, n, j);
  }
  return static_cast<int>(cudaGetLastError());
}
