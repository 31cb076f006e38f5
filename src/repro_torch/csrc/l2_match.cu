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
// that makes both kernels equal their plain version bitwise.  No tensor
// cores: their TF32 / 3xTF32 products would round differently.  `t2` is
// the squared threshold already rounded to float32 by the caller.
//
// Bound on the H100: at the VLD matcher's M = N = 1024, D = 64 the work is
// 2*M*N*D = 134 MFLOP against 0.5 MB of inputs (the count) or 4.7 MB with
// the [M, N] output (the distances), so both are bound by float32
// operations: ~2.0 us at 67 TFLOP/s, which counts a multiply-add as two
// operations done by one FMA.  Without contraction each multiply and each
// add is its own instruction, so the floor here is ~4.0 us.
//
// `match_count` (match_count_kernel, the VLD path's kernel): a register-
// tiled outer product.  256 threads (16 x 16) own 4 x 4 outputs each, rows
// ty + 16 r and columns tx + 16 c, of a 64 x 64 block tile.  The operand
// rows are staged in 16-deep chunks by cp.async, a ring of four in flight
// (the whole D = 64 tile at once, so the products start when the first
// quarter lands), into rows padded to 20 floats: a thread reads 4 depths
// of a row as one float4, and eight consecutive rows then hit distinct
// banks.  Per 4 depths a thread issues 8 float4 loads for 64 multiplies
// and 64 adds.  16-byte copies need D % 4 == 0 and 16-byte aligned bases;
// otherwise each float is copied alone.  The first 128 threads also
// accumulate one row's norm each from the same staged chunks (once per
// row per block).  Ragged edges and the depth tail are zero-filled: a zero
// product adds nothing (the sums are never -0).  The count never writes
// [M, N]: each block sums its tile's hits per column (a shuffle, then
// shared memory) and adds them to the int32 output with one atomicAdd per
// column -- integer addition, so the order of the atomics does not change
// the result.
//
// `pairwise_sq_l2` (l2_tile_kernel, reached by no path of the port): one
// 256-thread block per 32 x 32 output tile, 32-deep slices staged
// synchronously, 4 outputs per thread.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kTile = 32;   // output rows and columns per block
constexpr int kRows = 8;    // blockDim.y; each thread owns kTile / kRows rows
constexpr int kDepth = 32;  // depth slice staged in shared memory
constexpr int kPerThread = kTile / kRows;

__global__ void __launch_bounds__(kTile * kRows)
l2_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ dist, int m, int n, int d) {
  __shared__ float a_tile[kTile][kDepth + 1];
  __shared__ float b_tile[kTile][kDepth + 1];
  __shared__ float a2s[kTile];
  __shared__ float b2s[kTile];

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
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int li = ty + kRows * r;
    const int i = i0 + li;
    const float v = repro::nan_max((a2s[li] + b2s[tx]) - 2.0f * acc[r], 0.0f);
    if (i < m && j < n) dist[static_cast<long long>(i) * n + j] = v;
  }
}

constexpr int kThreads = 256;        // match_count_kernel: 16 x 16 threads
constexpr int kSide = 16;
constexpr int kRowsPer = 4;          // output rows per thread: 64-row tiles
constexpr int kCols = 4;             // output columns per thread: 64-column tiles
constexpr int kChunk = 16;           // depth per cp.async stage
constexpr int kStages = 4;           // stages in flight: the whole D = 64 tile
constexpr int kStride = kChunk + 4;  // padded row (floats): float4 reads conflict-free

// Waits until at most `ahead` (< kStages) of this thread's copy groups
// are still in flight.
__device__ __forceinline__ void wait_ahead(int ahead) {
  switch (ahead) {
    case 0: repro::cp_async_wait<0>(); break;
    case 1: repro::cp_async_wait<1>(); break;
    case 2: repro::cp_async_wait<2>(); break;
    default: repro::cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
match_count_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const unsigned char* __restrict__ valid, float t2,
                   int* __restrict__ count, int m, int n, int d) {
  constexpr int BM = kSide * kRowsPer;
  constexpr int BN = kSide * kCols;
  constexpr int kStage = (BM + BN) * kStride;  // floats per stage: a rows, then b rows
  extern __shared__ float4 smem4[];            // [kStages][BM + BN][kStride] floats
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float a2s[BM];
  __shared__ float b2s[BN];
  __shared__ int hits[kThreads / 32][BN];

  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int chunks = (d + kChunk - 1) / kChunk;

  // Issue chunk c's copies into buffer c % kStages as one cp.async group.
  auto stage = [&](int c) {
    float* buf = smem + (c % kStages) * kStage;
    const int k0 = c * kChunk;
    constexpr int kPer = kVec ? 4 : 1;  // floats per copy
    constexpr int kSlots = kChunk / kPer;
#pragma unroll
    for (int idx = t; idx < (BM + BN) * kSlots; idx += kThreads) {
      const int row = idx / kSlots;
      const int k = k0 + (idx % kSlots) * kPer;
      const bool is_a = row < BM;
      const int g = is_a ? i0 + row : j0 + row - BM;
      const float* src = is_a ? a : b;
      const bool ok = g < (is_a ? m : n) && k < d;
      const float* from = ok ? src + static_cast<long long>(g) * d + k : src;
      float* to = buf + row * kStride + (k - k0);
      if (kVec) {
        repro::cp_async16(to, from, ok);
      } else {
        repro::cp_async4(to, from, ok);
      }
    }
    repro::cp_async_commit();
  };

  float acc[kRowsPer][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  // Thread t < BM accumulates |a_{i0+t}|^2, BM <= t < BM + BN |b_{j0+t-BM}|^2:
  // the b rows follow the a rows in each stage, so row t of the stage.
  const bool norm_thread = t < BM + BN;
  float norm = 0.0f;

  for (int c = 0; c < min(chunks, kStages); ++c) stage(c);
  for (int c = 0; c < chunks; ++c) {
    wait_ahead(min(chunks - 1 - c, kStages - 1));
    __syncthreads();
    const float* As = smem + (c % kStages) * kStage;
    const float* Bs = As + BM * kStride;
    const int quads = (min(kChunk, d - c * kChunk) + 3) / 4;
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      if (q < quads) {
        float4 av[kRowsPer];
        float4 bv[kCols];
#pragma unroll
        for (int r = 0; r < kRowsPer; ++r)
          av[r] = *reinterpret_cast<const float4*>(As + (ty + kSide * r) * kStride + 4 * q);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          bv[cc] = *reinterpret_cast<const float4*>(Bs + (tx + kSide * cc) * kStride + 4 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc)
              acc[r][cc] = acc[r][cc] + part(av[r], e) * part(bv[cc], e);
        if (norm_thread) {
          const float4 v = *reinterpret_cast<const float4*>(As + t * kStride + 4 * q);
#pragma unroll
          for (int e = 0; e < 4; ++e) norm = norm + part(v, e) * part(v, e);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it refills
    if (c + kStages < chunks) stage(c + kStages);
  }
  if (norm_thread) {
    if (t < BM) {
      a2s[t] = norm;
    } else {
      b2s[t - BM] = norm;
    }
  }
  __syncthreads();

  bool row_ok[kRowsPer];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int i = i0 + ty + kSide * r;
    row_ok[r] = i < m && valid[i] != 0;
  }
  const int lane = t & 31;
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int lj = tx + kSide * cc;
    int mine = 0;
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      const float v =
          repro::nan_max((a2s[ty + kSide * r] + b2s[lj]) - 2.0f * acc[r][cc], 0.0f);
      mine += (row_ok[r] && v <= t2) ? 1 : 0;
    }
    mine += __shfl_xor_sync(repro::kFullMask, mine, 16);  // lanes l, l + 16 share tx
    if (lane < 16) hits[t >> 5][lj] = mine;
  }
  __syncthreads();
  if (t < BN && j0 + t < n) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += hits[w][t];
    if (total) atomicAdd(count + j0 + t, total);
  }
}

template <bool kVec>
cudaError_t launch_count(const float* a, const float* b, const unsigned char* valid,
                         float t2, int* count, int m, int n, int d, int device,
                         cudaStream_t s) {
  static bool ready[16];
  constexpr int BM = kSide * kRowsPer;
  constexpr int BN = kSide * kCols;
  constexpr int smem = kStages * (BM + BN) * kStride * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = repro::allow_smem(match_count_kernel<kVec>, smem, device, ready);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  match_count_kernel<kVec><<<grid, kThreads, smem, s>>>(a, b, valid, t2, count, m, n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_pairwise_sq_l2(const float* a, const float* b, float* dist, int m,
                                    int n, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0 && n > 0) {
    const dim3 block(kTile, kRows);
    const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
    l2_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a, b, dist, m, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// `count` must hold N zeros on entry (the wrapper allocates it zeroed).
// `vec` asks for 16-byte copies (D % 4 == 0 and 16-byte aligned a and b).
extern "C" int repro_match_count(const float* a, const float* b, const unsigned char* valid,
                                 float t2, int* count, int m, int n, int d, int vec,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = vec ? launch_count<true>(a, b, valid, t2, count, m, n, d, device, s)
              : launch_count<false>(a, b, valid, t2, count, m, n, d, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
