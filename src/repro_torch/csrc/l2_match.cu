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
// Both kernels run one register-tiled outer product (l2_register_tile).
// 256 threads (16 x 16) own 4 x 4 outputs each, rows ty + 16 r and columns
// tx + 16 c, of a 64 x 64 block tile.  The operand rows are staged in
// 16-deep chunks by cp.async, a ring of four in flight (the whole D = 64
// tile at once, so the products start when the first quarter lands), into
// rows padded to 20 floats: a thread reads 4 depths of a row as one
// float4, and eight consecutive rows then hit distinct banks.  Per 4
// depths a thread issues 8 float4 loads for 64 multiplies and 64 adds.
// 16-byte copies need D % 4 == 0 and 16-byte aligned bases; otherwise each
// float is copied alone.  The first 128 threads also accumulate one row's
// norm each from the same staged chunks (once per row per block).  Ragged
// edges and the depth tail are zero-filled: a zero product adds nothing
// (the sums are never -0).
//
// `match_count` (match_count_kernel, the VLD path's kernel) never writes
// [M, N]: each block sums its tile's hits per column (a shuffle, then
// shared memory) and adds them to the int32 output with one atomicAdd per
// column -- integer addition, so the order of the atomics does not change
// the result.
//
// `pairwise_sq_l2` (sq_l2_kernel, reached by no path of the port) stores
// the tile instead: half a warp writes 16 consecutive floats of a row per
// store, 4 MB at the VLD shape (~1.2 us of the bytes bound).  On the H100
// at M = N = 1024, D = 64 it takes 10.2 us, against 17.4 for the first
// design's 32 x 32 tiles of 4 outputs per thread.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;        // 16 x 16 threads
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

// The register tile of both kernels: the 64 x 64 block tile's cross
// terms in registers, the rows' norms in a2s / b2s.  kCount: sum each
// column's hits within t2 into `count`; otherwise store the distances to
// `dist` [m, n].
template <bool kVec, bool kCount>
__device__ __forceinline__ void l2_register_tile(
    const float* __restrict__ a, const float* __restrict__ b,
    const unsigned char* __restrict__ valid, float t2, int* __restrict__ count,
    float* __restrict__ dist, int m, int n, int d) {
  constexpr int BM = kSide * kRowsPer;
  constexpr int BN = kSide * kCols;
  constexpr int kStage = (BM + BN) * kStride;  // floats per stage: a rows, then b rows
  extern __shared__ float4 smem4[];            // [kStages][BM + BN][kStride] floats
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float a2s[BM];
  __shared__ float b2s[BN];

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

  if constexpr (!kCount) {
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      const int li = ty + kSide * r;
      if (i0 + li >= m) break;
      float* row = dist + static_cast<long long>(i0 + li) * n + j0;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int lj = tx + kSide * cc;
        const float v = repro::nan_max((a2s[li] + b2s[lj]) - 2.0f * acc[r][cc], 0.0f);
        if (j0 + lj < n) row[lj] = v;
      }
    }
    return;
  }
  __shared__ int hits[kThreads / 32][BN];
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
__global__ void __launch_bounds__(kThreads)
match_count_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const unsigned char* __restrict__ valid, float t2,
                   int* __restrict__ count, int m, int n, int d) {
  l2_register_tile<kVec, true>(a, b, valid, t2, count, nullptr, m, n, d);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sq_l2_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ dist, int m, int n, int d) {
  l2_register_tile<kVec, false>(a, b, nullptr, 0.0f, nullptr, dist, m, n, d);
}

// Launches `kern` over the output's 64 x 64 tiles.
template <typename Kernel, typename... Args>
cudaError_t launch_tile(Kernel kern, int m, int n, cudaStream_t s, Args... args) {
  constexpr int BM = kSide * kRowsPer;
  constexpr int BN = kSide * kCols;
  constexpr int smem = kStages * (BM + BN) * kStride * static_cast<int>(sizeof(float));
  static_assert(smem <= 48 * 1024, "the cp.async ring must fit without an opt-in");
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// `vec` as in repro_match_count.
extern "C" int repro_pairwise_sq_l2(const float* a, const float* b, float* dist, int m,
                                    int n, int d, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto kern = vec ? sq_l2_kernel<true> : sq_l2_kernel<false>;
    err = launch_tile(kern, m, n, s, a, b, dist, m, n, d);
    if (err != cudaSuccess) return static_cast<int>(err);
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
    const auto kern = vec ? match_count_kernel<true> : match_count_kernel<false>;
    err = launch_tile(kern, m, n, s, a, b, valid, t2, count, m, n, d);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
