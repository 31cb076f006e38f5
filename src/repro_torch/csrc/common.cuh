// Shared device helpers for the repro_torch Hopper kernels.
//
// Every source is built with `-fmad=false` (no multiply-add contraction)
// and nvcc's default IEEE-rounded float division, so each float op here
// rounds exactly like the matching single PyTorch elementwise op of the
// plain versions (kernels/*/ref.py) -- that is what lets the kernels
// match them bitwise.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// min / max that propagate NaN like torch.minimum / jnp.minimum (CUDA's
// fminf / fmaxf return the non-NaN operand instead).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

// Integer sum over the whole block; every thread gets the total.  Needs
// blockDim.x to be a multiple of 32 and `scratch` to hold one int per
// warp.  Integer addition is associative, so the result does not depend
// on the reduction order.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) total += scratch[w];
  return total;
}

// Exclusive prefix sum over the block's threads in thread order (same
// blockDim / scratch contract as block_sum).
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += scratch[w];
  return base + x - v;
}

}  // namespace repro
