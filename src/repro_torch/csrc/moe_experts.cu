// The routed experts of a mixture of experts, grouped over the experts and
// over the filled slots of their capacity buffer:
//
//   up:   h [e, c]   = silu(x [e, c] Wg [e]) * (x [e, c] Wu [e])
//   down: out [e, c] = h [e, c] Wo [e]
//
// x [E, C, D], Wg / Wu [E, D, F], Wo [E, F, D], h [E, C, F], out [E, C, D],
// bf16, row-major.  counts [E] (int32, on the device): slots c < counts[e]
// of expert e hold routed tokens, every later slot is a zero row.
//
// Replaces no Pallas kernel: the JAX package runs the experts as three
// einsums over the whole padded buffer (src/repro/models/ffn.py,
// `moe_layer`), and models/ffn.py `_experts` as three `torch.bmm`s with the
// gate's SiLU in float32 between them.  At a capacity factor of 1.25 at
// most 80 % of the slots can be filled, so a fifth or more of the rows those
// products multiply are zero rows whose results nobody reads; and the gate
// makes a float32 round trip through device memory.
//
// What bounds it on the H100: the tensor cores (6 D F operations a filled
// slot; mixtral-8x22b's experts at 4 x 4,096 prefill tokens, ~30,800 of
// 40,960 slots filled a layer, 1.9e13 operations: 19 ms a layer at 989
// TFLOP/s).  The design is `swiglu_wgmma_kernel`'s (swiglu.cu): a block owns
// 128 rows of one expert and 256 weight columns per stage -- [Wg | Wu] for
// 128 output columns (`up`) or 256 columns of Wo (`down`) -- fed by one
// producer warp issuing TMA loads of 64-deep bf16 tiles (128-byte swizzle)
// into a 4-stage ring, two consumer warpgroups each on one `wgmma`
// m64n256k16 a 16-deep step, `setmaxnreg` moving registers to them -- the
// main loop both share (hopper.cuh `wgmma_ring_128x256`).  What is new:
//
// * The grid is (row tiles x column tiles of one expert, expert).  A block
//   reads its expert's count first; a block whose row tile starts at or past
//   it returns before any load.  The live blocks of an expert are the first
//   indices of its row, rastered in groups of 8 counted row tiles that walk
//   the column tiles together (their weight columns shared in L2).  The
//   counts stay on the device: the host launches the full grid and never
//   waits for the routing.
// * 3-D tensor maps over [E, C, D] / [E, D, F] / [E, F, D]: a tile never
//   reads into the next expert, and TMA zero-fills the ragged edge past C.
// * `up`'s epilogue rounds where models/ffn.py `_experts` rounds: the gate
//   to bf16, its silu taken in float32 and rounded to bf16, the up product
//   rounded to bf16, their product rounded to bf16.  `down` accumulates in
//   float32 and rounds once.  Only the order of accumulation inside a
//   product differs from cuBLAS's; no split-K, no atomics, so two runs give
//   the same bits.
//
// Rows of a run tile past the count (zero rows) come out 0 in h and out;
// rows of the tiles not run are not written.  D and F must be multiples of 8
// (16-byte rows, as TMA needs) and the pointers 16-byte aligned -- the
// wrapper (kernels/moe_experts/kernel.py) checks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using repro::tensor_map_batched;
using repro::tma_load_3d;

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // block rows: two consumer warpgroups x 64
constexpr int kBN = 256;       // B columns per stage: [Wg | Wu] x 128 (up), Wo x 256 (down)
constexpr int kBK = 64;        // k depth of one stage: 128 bytes of bf16
constexpr int kThreads = 384;  // consumers (warpgroups 0, 1), producer (2)
constexpr int kGroupM = 8;     // row tiles per raster group

template <int NMAT>
struct Plan {
  static constexpr int kStages = 4;
  static constexpr int kCols = kBN / NMAT;  // output columns per block
  static constexpr int kABytes = kBM * kBK * 2;  // 16 KB
  static constexpr int kBBytes = kBK * kBN * 2;  // 32 KB: four 64-column slabs
  static constexpr int kSlab = kBBytes / 4;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }
__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Expert blockIdx.y: C [M, N] = A [M, K] @ B0 [K, N]         (NMAT == 1)
//                    C [M, N] = silu(A @ B0) * (A @ B1)      (NMAT == 2)
// over the row tiles that hold one of its counts[e] filled rows.
template <int NMAT>
__global__ void __launch_bounds__(kThreads, 1)
experts_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb0,
                     const __grid_constant__ CUtensorMap tb1, bf16* __restrict__ c,
                     const int* __restrict__ counts, int M, int N, int K) {
  using P = Plan<NMAT>;
  const int e = blockIdx.y;
  const int num_m = (min(__ldg(counts + e), M) + kBM - 1) / kBM;  // counted row tiles
  const int num_n = (N + P::kCols - 1) / P::kCols;
  if (static_cast<int>(blockIdx.x) >= num_m * num_n) return;  // only empty slots: no work
  extern __shared__ __align__(128) uint8_t smem_raw[];

  // Grouped raster over the counted row tiles.
  const int per_group = kGroupM * num_n;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int gm = min(num_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * kBM;
  const int n0 = (in_group / gm) * P::kCols;
  const int k_tiles = (K + kBK - 1) / kBK;

  float acc[128];  // up: columns 0-127 the gate, 128-255 the up product
  const bool consumer = repro::wgmma_ring_128x256<P::kStages, P::kABytes, P::kSlab>(
      smem_raw, k_tiles,
      [&](uint8_t* st, uint64_t* bar, int kt) {
        tma_load_3d(st, &ta, bar, kt * kBK, m0, e);
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {  // up: Wg, Wg, Wu, Wu; down: Wo x 4
          const CUtensorMap* tb = NMAT == 2 && sl >= 2 ? &tb1 : &tb0;
          const int col = n0 + (NMAT == 2 ? (sl & 1) : sl) * 64;
          tma_load_3d(st + P::kABytes + sl * P::kSlab, tb, bar, col, kt * kBK, e);
        }
      },
      acc);
  if (consumer) {  // warpgroup wg holds rows [64 wg, 64 wg + 64) of the tile
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x & 31;
    // Accumulator layout: d[4 j + 2 h + i] is row 16 w + lane / 4 + 8 h,
    // column 8 j + 2 (lane % 4) + i of the warpgroup's 64 x 256 tile.
    const int warp = (threadIdx.x & 127) >> 5;
    const int row0 = m0 + wg * (kBM / 2) + warp * 16 + (lane >> 2);
    bf16* ce = c + static_cast<long long>(e) * M * N;
#pragma unroll
    for (int j = 0; j < P::kCols / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M && col < N) {
          float v[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            v[i] = acc[4 * j + 2 * h + i];
            if (NMAT == 2)  // bf16 gate -> float32 silu -> bf16, times the bf16 up
              v[i] = to_bf16(silu(to_bf16(v[i]))) * to_bf16(acc[4 * (j + 16) + 2 * h + i]);
          }
          *reinterpret_cast<__nv_bfloat162*>(ce + static_cast<long long>(row) * N + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

// One grouped product over E experts: A [E, m, k] against B0 (and B1) [E,
// k, n] into C [E, m, n].
template <int NMAT>
int run(const void* a, const void* b0, const void* b1, void* c, const int* counts, int e, int m,
        int n, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e == 0 || m == 0 || n == 0) return 0;
  static bool ready[16] = {};
  auto kern = experts_wgmma_kernel<NMAT>;
  err = repro::allow_smem(kern, Plan<NMAT>::kSmem, device, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tb0, tb1;
  if (!tensor_map_batched(&ta, a, e, m, k, kBM) || !tensor_map_batched(&tb0, b0, e, k, n, kBK) ||
      !tensor_map_batched(&tb1, NMAT == 2 ? b1 : b0, e, k, n, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((m + kBM - 1) / kBM) * ((n + Plan<NMAT>::kCols - 1) / Plan<NMAT>::kCols), e);
  kern<<<grid, kThreads, Plan<NMAT>::kSmem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb0, tb1, static_cast<bf16*>(c), counts, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// up: h [E, C, F] = silu(x Wg) * (x Wu), expert by expert, over the row
// tiles below each expert's count.
extern "C" int repro_moe_experts_up(const void* x, const void* wg, const void* wu, void* h,
                                    const int* counts, int e, int c, int d, int f, int device,
                                    void* stream) {
  return run<2>(x, wg, wu, h, counts, e, c, f, d, device, stream);
}

// down: out [E, C, D] = h Wo over the same tiles.
extern "C" int repro_moe_experts_down(const void* h, const void* wo, void* out,
                                      const int* counts, int e, int c, int d, int f, int device,
                                      void* stream) {
  return run<1>(h, wo, nullptr, out, counts, e, c, d, f, device, stream);
}
