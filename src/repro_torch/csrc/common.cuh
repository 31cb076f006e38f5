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

// Correctly rounded n / d, as the float division `/` gives it.  The
// double quotient of two floats rounded once more to float is the
// correctly rounded float quotient (53 >= 2 * 24 + 2 bits: the second
// rounding is innocuous for division).  The float division leaves its
// fast path for a slow one where the numerator nears underflow -- the
// tail of the Erlang-B recurrence, where B(k) falls to 0 -- and the
// double one does not, except for a zero numerator: over a positive
// denominator that quotient is the numerator itself.
__device__ __forceinline__ float div_rn(float n, float d) {
  if (n == 0.0f && d > 0.0f) return n;
  return __double2float_rn(__ddiv_rn(static_cast<double>(n), static_cast<double>(d)));
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

// Raises `kern`'s dynamic shared-memory limit to `bytes` (needed above
// 48 KB) the first time it launches on `device`; `ready` is the calling
// launcher's own flag array, one flag per device.  Two threads racing here
// both set the same value.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes, int device, bool (&ready)[16]) {
  if (device >= 0 && device < 16 && ready[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < 16) ready[device] = true;
  return err;
}

}  // namespace repro
