// Erlang-B recurrence table over S offered-load lanes.
//
// Replaces the Pallas TPU kernel `erlang_b_table_pallas`
// (src/repro/kernels/erlang_c/kernel.py, body `_erlang_b_kernel`):
//
//     B(0) = 1,   B(j) = a * B(j-1) / (j + a * B(j-1)),   j = 1..k_hi
//
// written as a [k_hi+1, S] table (row j holds B(j) for every lane).
//
// Bound on the H100: (k_hi + 2) * 4 bytes per lane of device memory
// against ~3 float ops per stored value, so bandwidth-bound; the
// recurrence is sequential in j and independent across lanes.  Design:
// one thread per lane walks j in registers and stores row j across the
// lanes, so neighbouring threads write neighbouring addresses (coalesced
// row stores, the layout the caller reads).  The Pallas kernel held the
// whole table in VMEM; here nothing needs staging -- each value is
// stored once, straight from a register.
#include "common.cuh"

namespace {

__global__ void erlang_b_kernel(const float* __restrict__ a,
                                float* __restrict__ out, int s, int k_hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  const float ai = a[i];
  float b = 1.0f;
  out[i] = 1.0f;
  for (int j = 1; j <= k_hi; ++j) {
    const float ab = ai * b;
    b = ab / (static_cast<float>(j) + ab);
    out[static_cast<size_t>(j) * s + i] = b;
  }
}

}  // namespace

extern "C" int repro_erlang_b_table(const float* a, float* out, int s, int k_hi,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0) {
    const int threads = 128;
    const int blocks = (s + threads - 1) / threads;
    erlang_b_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, out, s, k_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
