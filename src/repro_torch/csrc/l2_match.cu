// Squared L2 distances and fused match counts between frame descriptors
// a [M, D] and a descriptor library b [N, D], float32.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/l2_match/kernel.py:
// `pairwise_sq_l2_pallas` (body `_dist_kernel`) and `match_count_pallas`
// (body `_count_kernel`):
//
//     d2[i, j] = max((|a_i|^2 + |b_j|^2) - 2 * (a_i . b_j), 0)
//     count[j] = #{ i : valid[i] and d2[i, j] <= t2 }
//
// The norms and the cross term are each accumulated over d in order, one
// rounded multiply and one rounded add per step (`-fmad=false`), exactly
// as kernels/l2_match/ref.py does with one PyTorch elementwise op per step:
// that makes both kernels equal their plain version bitwise.  `t2` is the
// squared threshold already rounded to float32 by the caller.
//
// Bound on the H100: at the VLD matcher's M = N = 1024, D = 64 the work is
// 2*M*N*D = 134 MFLOP against 0.5 MB of inputs (the count) or 4.7 MB with
// the [M, N] output (the distances), so both are bound by float32
// operations (~2.0 us at 67 TFLOP/s), not by bytes.  Design, simple first:
// one 256-thread block per 32 x 32 output tile; 32-deep slices of both
// operand tiles are staged in shared memory (padded rows, so the column
// reads are free of bank conflicts) and every thread accumulates 4 outputs
// on the CUDA cores -- no tensor cores, whose TF32/3xTF32 products would
// round differently.  The count never writes [M, N]: each block sums its
// tile's hits per column in shared memory and adds them to the int32
// output with one atomicAdd per column (integer addition, so the order of
// the atomics does not change the result).  Ragged edges are masked, so
// no padding to a block multiple is needed.
#include "common.cuh"

namespace {

constexpr int kTile = 32;   // output rows and columns per block
constexpr int kRows = 8;    // blockDim.y; each thread owns kTile / kRows rows
constexpr int kDepth = 32;  // depth slice staged in shared memory
constexpr int kPerThread = kTile / kRows;

template <bool kCount>
__global__ void __launch_bounds__(kTile * kRows)
l2_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const unsigned char* __restrict__ valid, float t2,
               float* __restrict__ dist, int* __restrict__ count,
               int m, int n, int d) {
  __shared__ float a_tile[kTile][kDepth + 1];
  __shared__ float b_tile[kTile][kDepth + 1];
  __shared__ float a2s[kTile];
  __shared__ float b2s[kTile];
  __shared__ int hits[kRows][kTile];

  const int tx = threadIdx.x;  // output column within the tile
  const int ty = threadIdx.y;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  float acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc[r] = 0.0f;
  float norm = 0.0f;  // |b_{j0+tx}|^2 for ty == 0, |a_{i0+tx}|^2 for ty == 1

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    const int kn = min(kDepth, d - k0);
    for (int r = ty; r < kTile; r += kRows) {
      const int gk = k0 + tx;
      const int gi = i0 + r;
      const int gj = j0 + r;
      a_tile[r][tx] = (gi < m && tx < kn) ? a[static_cast<long long>(gi) * d + gk] : 0.0f;
      b_tile[r][tx] = (gj < n && tx < kn) ? b[static_cast<long long>(gj) * d + gk] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      const float bv = b_tile[tx][kk];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) acc[r] = acc[r] + a_tile[ty + kRows * r][kk] * bv;
    }
    if (ty == 0) {
      for (int kk = 0; kk < kn; ++kk) norm = norm + b_tile[tx][kk] * b_tile[tx][kk];
    } else if (ty == 1) {
      for (int kk = 0; kk < kn; ++kk) norm = norm + a_tile[tx][kk] * a_tile[tx][kk];
    }
    __syncthreads();
  }
  if (ty == 0) b2s[tx] = norm;
  if (ty == 1) a2s[tx] = norm;
  __syncthreads();

  const int j = j0 + tx;
  int mine = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int li = ty + kRows * r;
    const int i = i0 + li;
    const float v = repro::nan_max((a2s[li] + b2s[tx]) - 2.0f * acc[r], 0.0f);
    if (i < m && j < n) {
      if (kCount) {
        mine += (valid[i] != 0 && v <= t2) ? 1 : 0;
      } else {
        dist[static_cast<long long>(i) * n + j] = v;
      }
    }
  }
  if (kCount) {
    hits[ty][tx] = mine;
    __syncthreads();
    if (ty == 0 && j < n) {
      int total = 0;
#pragma unroll
      for (int y = 0; y < kRows; ++y) total += hits[y][tx];
      if (total) atomicAdd(count + j, total);
    }
  }
}

cudaError_t launch_tiles(bool counting, const float* a, const float* b,
                         const unsigned char* valid, float t2, float* dist, int* count,
                         int m, int n, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m > 0 && n > 0) {
    const dim3 block(kTile, kRows);
    const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (counting) {
      l2_tile_kernel<true><<<grid, block, 0, s>>>(a, b, valid, t2, nullptr, count, m, n, d);
    } else {
      l2_tile_kernel<false><<<grid, block, 0, s>>>(a, b, nullptr, 0.0f, dist, nullptr, m, n, d);
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_pairwise_sq_l2(const float* a, const float* b, float* dist, int m,
                                    int n, int d, int device, void* stream) {
  return static_cast<int>(
      launch_tiles(false, a, b, nullptr, 0.0f, dist, nullptr, m, n, d, device, stream));
}

// `count` must hold N zeros on entry (the wrapper allocates it zeroed).
extern "C" int repro_match_count(const float* a, const float* b, const unsigned char* valid,
                                 float t2, int* count, int m, int n, int d, int device,
                                 void* stream) {
  return static_cast<int>(
      launch_tiles(true, a, b, valid, t2, nullptr, count, m, n, d, device, stream));
}
