// Bounded-queue fluid step over M = B*N queue lanes.
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
// Bound on the H100: 28 bytes of device memory per lane (4 loads, 3
// stores) against ~7 float ops, so the kernel is bandwidth-bound -- and
// at the main path's M = 4096 * 7 lanes it moves under 1 MB, which the
// card does in well under a microsecond: in practice the launch itself is
// the cost (the window calls it once per simulated step).  The design is
// therefore the plainest one: one thread per lane, coalesced loads and
// stores, only min/max/add/sub so the result is bitwise the plain
// version's.  Amortising the launch (a CUDA graph over the window, or a
// kernel fusing the whole window) is later work.
#include "common.cuh"

namespace {

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
