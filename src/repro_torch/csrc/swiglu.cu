// SwiGLU feed-forward: out = (silu(x Wg) * (x Wu)) Wo, x [T, D],
// Wg / Wu [D, F], Wo [F, D], all row-major; bf16 or float32 operands,
// float32 accumulation.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/swiglu/kernel.py:
// `swiglu_pallas` (body `_kernel`), and computes what it computes: the
// gate and up products accumulated in float32, `silu(g) * u` in float32
// and rounded once to x's dtype (kernel.py:37), then the Wo product
// accumulated in float32 and rounded to x's dtype.
//
// Design: two launches.  Launch 1 (`up`) computes both products of one
// [128, 64] tile of the hidden at once -- the x tile is shared -- and
// writes h = silu(g) * u in x's dtype; launch 2 (`down`) is the product
// h Wo.  The TPU kernel keeps the hidden in VMEM (a (bt, D) float32
// accumulator per step); on Hopper that accumulator would be 1 MB per
// 128-row tile at D = 2048, far past a block's 227 KB, so the hidden makes
// one round trip through device memory: 2 * T * F bytes, 0.5 GB per layer
// at T = 16,384 in bf16 (0.16 ms at 3.35 TB/s) next to 1.65 TFLOP of
// products.  Full fusion is later work.
//
// Bound on the H100: at the llama3.2-1b prefill (T = 16,384, D = 2048,
// F = 8192, bf16) 6 T D F = 1.65 TFLOP per layer: the tensor cores (1.67 ms
// at 989 TFLOP/s).  At decode (T = 16) the 100 MB of weights bound it
// (30 us).  bf16 runs on the tensor cores with warp-level mma.sync
// (m16n8k16, float32 accumulate): 128 x 128 (down) or 128 x 64 x 2 (up)
// block tiles of 8 warps, 32-deep k slices double-buffered in shared
// memory by cp.async, fragments by ldmatrix.  Ragged T, D and F edges are
// masked (zero-filled loads, guarded stores); D and F must be multiples of
// 8 (16-byte rows) and the pointers 16-byte aligned -- the wrapper checks.
// float32 (the parity path) runs a 64 x 64 CUDA-core tile with explicit
// fmaf, at 67 TFLOP/s peak.  wgmma / TMA tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// ----------------------------------------------------------------------- //
// bf16: mma.sync tiles
// ----------------------------------------------------------------------- //
constexpr int kBM = 128;  // block rows
constexpr int kBK = 32;   // k slice per pipeline stage
constexpr int kThreads = 256;
constexpr int kPad = 8;   // row padding (elements): ldmatrix rows hit distinct banks

template <int BN, int NMAT>
struct Tiles {
  bf16 a[2][kBM][kBK + kPad];
  bf16 b[2][NMAT][kBK][BN + kPad];
};

// C [M, N] = A [M, K] @ B0 [K, N]                       (kDual == false)
// C [M, N] = silu(A @ B0) * (A @ B1), rounded once      (kDual == true)
// 8 warps as 2 (rows) x 4 (columns); a warp owns 64 rows x BN / 4 columns
// of each product.
template <int BN, bool kDual>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B0,
                 const bf16* __restrict__ B1, bf16* __restrict__ C, int M, int N, int K) {
  constexpr int NMAT = kDual ? 2 : 1;
  constexpr int WN = BN / 4;  // warp tile width
  constexpr int MT = 4;       // m16 tiles per warp
  constexpr int NT = WN / 8;  // n8 tiles per warp and product
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  constexpr int kChunksA = kBM * kBK / 8 / kThreads;
  constexpr int kChunksB = kBK * BN / 8 / kThreads;
  static_assert(kChunksA * kThreads * 8 == kBM * kBK, "A tile split");
  static_assert(kChunksB * kThreads * 8 == kBK * BN, "B tile split");
  __shared__ __align__(128) Tiles<BN, NMAT> sm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + kBK - 1) / kBK;

  float acc[NMAT][MT][NT][4];
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mat][mt][nt][i] = 0.0f;

  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kChunksA; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + col < K;
      const bf16* src = ok ? A + static_cast<long long>(m0 + r) * K + k0 + col : A;
      cp_async16(&sm.a[st][r][col], src, ok);
    }
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      const bf16* B = mat == 0 ? B0 : B1;
#pragma unroll
      for (int i = 0; i < kChunksB; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (BN / 8);
        const int col = (c % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + col < N;
        const bf16* src = ok ? B + static_cast<long long>(k0 + r) * N + n0 + col : B;
        cp_async16(&sm.b[st][mat][r][col], src, ok);
      }
    }
  };

  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < k_tiles) {
      load_tile(kt + 1, st ^ 1);  // that stage's readers passed the last barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], &sm.a[st][wm * 64 + mt * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, &sm.b[st][mat][kk + (lane & 15)][wn * WN + np * 16 + (lane >> 4) * 8]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mat][mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(acc[mat][mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gr = lane >> 2;
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WN + nt * 8 + gc;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + gr + half * 8;
        if (row < M && col < N) {
          float v0 = acc[0][mt][nt][2 * half];
          float v1 = acc[0][mt][nt][2 * half + 1];
          if (kDual) {
            v0 = silu(v0) * acc[NMAT - 1][mt][nt][2 * half];
            v1 = silu(v1) * acc[NMAT - 1][mt][nt][2 * half + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(C + static_cast<long long>(row) * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// ----------------------------------------------------------------------- //
// float32: CUDA-core tiles
// ----------------------------------------------------------------------- //
constexpr int kFT = 64;  // block rows and columns
constexpr int kFK = 16;  // k slice

template <bool kDual>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                const float* __restrict__ B1, float* __restrict__ C, int M, int N, int K) {
  constexpr int NMAT = kDual ? 2 : 1;
  __shared__ float as[kFK][kFT + 4];  // the A tile transposed: [k][row]
  __shared__ float bs[NMAT][kFK][kFT + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kFT;
  const int n0 = blockIdx.x * kFT;
  float acc[NMAT][4][4];
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mat][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < kFT * kFK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kFK;
      const int kk = e % kFK;
      const int gr = m0 + r;
      const int gk = k0 + kk;
      as[kk][r] = gr < M && gk < K ? A[static_cast<long long>(gr) * K + gk] : 0.0f;
    }
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      const float* B = mat == 0 ? B0 : B1;
#pragma unroll
      for (int i = 0; i < kFT * kFK / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int kk = e / kFT;
        const int c = e % kFT;
        const int gk = k0 + kk;
        const int gc = n0 + c;
        bs[mat][kk][c] = gk < K && gc < N ? B[static_cast<long long>(gk) * N + gc] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = bs[mat][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mat][i][j] = fmaf(a[i], bv, acc[mat][i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row < M && col < N) {
        const float v = kDual ? silu(acc[0][i][j]) * acc[NMAT - 1][i][j] : acc[0][i][j];
        C[static_cast<long long>(row) * N + col] = v;
      }
    }
  }
}

constexpr int kUpBN = 64;     // up: two products of a 128 x 64 tile
constexpr int kDownBN = 128;  // down: one product of a 128 x 128 tile

}  // namespace

// Launch 1: h [T, F] = silu(x Wg) * (x Wu) in x's dtype.
extern "C" int repro_swiglu_up(const void* x, const void* wg, const void* wu, void* h, int t,
                               int d, int f, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t == 0 || f == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((f + kUpBN - 1) / kUpBN, (t + kBM - 1) / kBM);
    gemm_bf16_kernel<kUpBN, true><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
        static_cast<const bf16*>(wu), static_cast<bf16*>(h), t, f, d);
  } else {
    const dim3 grid((f + kFT - 1) / kFT, (t + kFT - 1) / kFT);
    gemm_f32_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<float*>(h), t, f, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: out [T, D] = h Wo in x's dtype.
extern "C" int repro_swiglu_down(const void* h, const void* wo, void* out, int t, int d, int f,
                                 int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((d + kDownBN - 1) / kDownBN, (t + kBM - 1) / kBM);
    gemm_bf16_kernel<kDownBN, false><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(wo), nullptr,
        static_cast<bf16*>(out), t, d, f);
  } else {
    const dim3 grid((d + kFT - 1) / kFT, (t + kFT - 1) / kFT);
    gemm_f32_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(wo), nullptr,
        static_cast<float*>(out), t, d, f);
  }
  return static_cast<int>(cudaGetLastError());
}
