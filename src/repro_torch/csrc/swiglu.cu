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
// Two products per call, `up` (h = silu(x Wg) * (x Wu), both products of
// one tile from the same x tile) and `down` (h Wo).  The TPU kernel keeps
// the hidden in VMEM; here it makes one round trip through device memory
// (2 T F bytes, ~0.16 ms of llama's 1.67 ms bound at T = 16,384).
//
// What bounds it on the H100, and the path each regime takes (the wrapper
// plans the launch from host numbers, kernels/swiglu/kernel.py:plan):
//
// * Large T (prefill; bf16): the tensor cores (6 T D F operations, 1.65
//   TFLOP per llama layer at T = 16,384: 1.67 ms at 989 TFLOP/s).
//   `swiglu_wgmma_kernel`: a block owns 128 rows and 256 weight columns
//   per stage -- [Wg | Wu] for 128 output columns (`up`, both products
//   from one x tile) or 256 columns of Wo (`down`) -- fed by one producer
//   warp issuing TMA loads of 64-deep bf16 tiles (128-byte swizzle) into a
//   4-stage ring in dynamic shared memory, with `mbarrier`s for full and
//   empty slots; two consumer warpgroups each run one `wgmma.mma_async`
//   m64n256k16 per 16-deep step on 64 rows, float32 accumulators in
//   registers (`setmaxnreg` moves registers from the producer to the
//   consumers).  One m64n256 product reads the x tile once per step where
//   two m64n128 products would read it twice.  x / h tiles are
//   K-major, the weight tiles N-major (the weights stay [K, N] row-major;
//   wgmma reads them transposed).  TMA zero-fills the ragged T, N and K
//   edges; the epilogue stores are guarded.  Tiles are visited in groups
//   of 8 row tiles so the blocks in flight share their weight columns in
//   L2.
// * Small T (decode, T <= 16): the weight bytes (~100 MB per llama layer,
//   30 us; ~308 MB at zamba2's width, 92 us).  `swiglu_stream_kernel`
//   streams 64 x 64 weight tiles through a 4-stage cp.async ring (16-byte
//   copies), with x zero-padded to the 16 rows of an mma.sync m16n8k16
//   tile; each block owns 64 output columns and one slice of K, so the
//   grid (column tiles x K slices) covers the card several times over.  The K
//   slices' float32 partials are summed by `swiglu_reduce_kernel` in slice
//   order (no atomics: a result does not change from run to run).
// * float32 (the parity path, exact float32, no TF32): the same K split
//   on CUDA cores at T <= 16 (`swiglu_stream_f32_kernel`), a 64 x 64
//   CUDA-core tile (`swiglu_f32_tile_kernel`) at larger T.
//
// D and F must be multiples of 8 (16-byte rows, as TMA needs) and the
// pointers 16-byte aligned -- the wrapper checks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tensor_core.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::smem_u32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// ======================================================================= //
// Large T, bf16: wgmma + TMA
// ======================================================================= //
constexpr int kWgBM = 128;  // block rows: two consumer warpgroups x 64
constexpr int kWgBN = 256;  // B columns per stage: [Wg | Wu] x 128 (up), Wo x 256 (down)
constexpr int kWgBK = 64;   // k depth of one stage: 128 bytes of bf16
constexpr int kWgThreads = 384;  // consumers (warpgroups 0, 1), producer (2)
constexpr int kWgGroupM = 8;     // row tiles per raster group

template <int NMAT>
struct WgPlan {
  static constexpr int kStages = 4;
  static constexpr int kCols = kWgBN / NMAT;  // output columns per block
  static constexpr int kABytes = kWgBM * kWgBK * 2;        // 16 KB
  static constexpr int kBBytes = kWgBK * kWgBN * 2;        // 32 KB: four 64-column slabs
  static constexpr int kSlab = kBBytes / 4;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one box at (c0 = inner column, c1 = row) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major (x / h): rows
// of 128 bytes, 8-row groups 1024 bytes apart (stride offset); N-major
// (weights): 64-column slabs `lbo` bytes apart (leading offset), 8-row k
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[128] += A (64 x 16, K-major) * B (16 x 256, N-major), float32 accumulate.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// C [M, N] = A [M, K] @ B0 [K, N]                       (NMAT == 1)
// C [M, N] = silu(A @ B0) * (A @ B1), rounded once      (NMAT == 2)
template <int NMAT>
__global__ void __launch_bounds__(kWgThreads, 1)
swiglu_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb0,
                    const __grid_constant__ CUtensorMap tb1, bf16* __restrict__ c, int M, int N,
                    int K) {
  using P = WgPlan<NMAT>;
  constexpr int S = P::kStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + S * P::kStageBytes);
  uint64_t* empty = full + S;

  // Grouped raster: kWgGroupM row tiles walk the column tiles together.
  const int num_m = (M + kWgBM - 1) / kWgBM;
  const int num_n = (N + P::kCols - 1) / P::kCols;
  const int per_group = kWgGroupM * num_n;
  const int first_m = (blockIdx.x / per_group) * kWgGroupM;
  const int gm = min(num_m - first_m, kWgGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * kWgBM;
  const int n0 = (in_group / gm) * P::kCols;
  const int k_tiles = (K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // k step kt uses stage kt % S in phase (kt / S) & 1.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % S;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        uint8_t* st = tiles + s * P::kStageBytes;
        mbar_expect_tx(&full[s], P::kStageBytes);
        tma_load(st, &ta, &full[s], kt * kWgBK, m0);
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {  // up: Wg, Wg, Wu, Wu; down: Wo x 4
          const CUtensorMap* tb = NMAT == 2 && sl >= 2 ? &tb1 : &tb0;
          const int col = n0 + (NMAT == 2 ? (sl & 1) : sl) * 64;
          tma_load(st + P::kABytes + sl * P::kSlab, tb, &full[s], col, kt * kWgBK);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[128];  // up: columns 0-127 the gate, 128-255 the up product
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % S;
      mbar_wait(&full[s], (kt / S) & 1);
      const uint8_t* st = tiles + s * P::kStageBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t da = wg_desc(st + wg * (kWgBM / 2) * 128 + kk * 32, 16);
        const uint64_t db = wg_desc(st + P::kABytes + kk * 16 * 128, P::kSlab);
        wgmma_m64n256k16(acc, da, db);
      }
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
    }
    wg_wait<0>();

    // Accumulator layout: d[4 j + 2 h + e] is row 16 w + lane / 4 + 8 h,
    // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 256 tile.
    const int warp = (threadIdx.x & 127) >> 5;
    const int row0 = m0 + wg * (kWgBM / 2) + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < P::kCols / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M && col < N) {
          float v0 = acc[4 * j + 2 * h];
          float v1 = acc[4 * j + 2 * h + 1];
          if (NMAT == 2) {
            v0 = silu(v0) * acc[4 * (j + 16) + 2 * h];
            v1 = silu(v1) * acc[4 * (j + 16) + 2 * h + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(c + static_cast<long long>(row) * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, cols] matrix in boxes of [box_rows, 64].
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NMAT>
cudaError_t launch_wgmma(const void* a, const void* b0, const void* b1, void* c, int m, int n,
                         int k, int device, cudaStream_t s) {
  static bool ready[16] = {};
  auto kern = swiglu_wgmma_kernel<NMAT>;
  cudaError_t err = repro::allow_smem(kern, WgPlan<NMAT>::kSmem, device, ready);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb0, tb1;
  if (!tensor_map(&ta, a, m, k, kWgBM) || !tensor_map(&tb0, b0, k, n, kWgBK) ||
      !tensor_map(&tb1, NMAT == 2 ? b1 : b0, k, n, kWgBK))
    return cudaErrorInvalidValue;
  const int blocks =
      ((m + kWgBM - 1) / kWgBM) * ((n + WgPlan<NMAT>::kCols - 1) / WgPlan<NMAT>::kCols);
  kern<<<blocks, kWgThreads, WgPlan<NMAT>::kSmem, s>>>(ta, tb0, tb1, static_cast<bf16*>(c), m,
                                                        n, k);
  return cudaGetLastError();
}

// ======================================================================= //
// Small T: weight streaming with a K split
// ======================================================================= //
constexpr int kStRows = 16;  // x rows per mma tile (T <= 16, zero-padded)
constexpr int kStBN = 64;    // block columns per product
constexpr int kStBK = 64;    // k rows per stage
constexpr int kStStages = 4;
constexpr int kStThreads = 128;  // 4 warps x 16 columns
constexpr int kStPad = 8;        // row padding: ldmatrix rows hit distinct banks

template <int NMAT>
struct StTiles {
  bf16 x[kStStages][kStRows][kStBK + kStPad];
  bf16 w[kStStages][NMAT][kStBK][kStBN + kStPad];
};

// Writes a block's [T, 64] result: the finished output when the K range
// is whole (splits == 1), else float32 partials ws[split][mat][T][N].
template <typename T, int NMAT>
__device__ __forceinline__ void stream_store(T* __restrict__ c, float* __restrict__ ws, int t,
                                             int n, int row, int col, int splits,
                                             const float (&v)[NMAT][2]) {
  if (row >= t || col >= n) return;
  if (splits == 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float r = NMAT == 2 ? silu(v[0][e]) * v[NMAT - 1][e] : v[0][e];
      store_out(c + static_cast<long long>(row) * n + col + e, r);
    }
  } else {
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      float* p = ws + ((static_cast<long long>(blockIdx.y) * NMAT + mat) * t + row) * n + col;
      p[0] = v[mat][0];
      p[1] = v[mat][1];
    }
  }
}

// Block (column tile x, K slice y): x [t, k] rows [k0, k0 + kper) against
// the same rows of each B [k, n], columns [64 x, 64 x + 64).
template <int NMAT>
__global__ void __launch_bounds__(kStThreads)
swiglu_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ b0,
                     const bf16* __restrict__ b1, bf16* __restrict__ c, float* __restrict__ ws,
                     int t, int n, int k, int kper, int splits) {
  extern __shared__ __align__(128) uint8_t st_raw[];
  StTiles<NMAT>& sm = *reinterpret_cast<StTiles<NMAT>*>(st_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kStBN;
  const int kbeg = blockIdx.y * kper;
  const int kend = min(k, kbeg + kper);
  const int k_tiles = (kend - kbeg + kStBK - 1) / kStBK;

  auto load = [&](int kt, int st) {
    const int k0 = kbeg + kt * kStBK;
    {  // x: 16 rows x 64 = 128 chunks of 16 bytes, one per thread
      const int r = tid >> 3;
      const int col = (tid & 7) * 8;
      const bool ok = r < t && k0 + col < kend;
      cp_async16(&sm.x[st][r][col], ok ? x + static_cast<long long>(r) * k + k0 + col : x, ok);
    }
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      const bf16* b = mat == 0 ? b0 : b1;
#pragma unroll
      for (int i = 0; i < kStBK * kStBN / 8 / kStThreads; ++i) {
        const int chunk = tid + i * kStThreads;
        const int r = chunk >> 3;
        const int col = (chunk & 7) * 8;
        const bool ok = k0 + r < kend && n0 + col < n;
        cp_async16(&sm.w[st][mat][r][col],
                   ok ? b + static_cast<long long>(k0 + r) * n + n0 + col : b, ok);
      }
    }
  };

  float acc[NMAT][2][4];
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mat][nt][i] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStStages - 1; ++st) {
    if (st < k_tiles) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1's readers are done
    if (kt + kStStages - 1 < k_tiles) load(kt + kStStages - 1, (kt + kStStages - 1) % kStStages);
    cp_async_commit();
    const int st = kt % kStStages;
#pragma unroll
    for (int kk = 0; kk < kStBK; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, &sm.x[st][lane & 15][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sm.w[st][mat][kk + (lane & 15)][warp * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[mat][0], a, b[0], b[1]);
        mma_bf16(acc[mat][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2;
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = n0 + warp * 16 + nt * 8 + gc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows gr (the only ones T <= 8 fills) and gr + 8
      float v[NMAT][2];
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        v[mat][0] = acc[mat][nt][2 * h];
        v[mat][1] = acc[mat][nt][2 * h + 1];
      }
      stream_store<bf16, NMAT>(c, ws, t, n, gr + 8 * h, col, splits, v);
    }
  }
}

// float32, exact (CUDA cores): 128 threads = 16 groups of 4 columns
// (16-byte weight loads; a warp reads 256 contiguous bytes of two rows) x
// 8 k lanes; each thread sums its lane's rows for the TR (>= T) x rows,
// then the two lanes of a warp and the four warps are summed in a fixed
// order.
constexpr int kSfThreads = 128;

template <int NMAT, int TR>
__global__ void __launch_bounds__(kSfThreads)
swiglu_stream_f32_kernel(const float* __restrict__ x, const float* __restrict__ b0,
                         const float* __restrict__ b1, float* __restrict__ c,
                         float* __restrict__ ws, int t, int n, int k, int kper, int splits) {
  __shared__ __align__(16) float red[kSfThreads / 32][NMAT][TR][kStBN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = lane & 15;
  const int klane = 2 * warp + (lane >> 4);
  const int col = blockIdx.x * kStBN + 4 * cg;
  const int kbeg = blockIdx.y * kper;
  const int kend = min(k, kbeg + kper);
  float acc[NMAT][TR][4];
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mat][r][e] = 0.0f;
  if (col < n) {
#pragma unroll 2
    for (int kk = kbeg + klane; kk < kend; kk += 8) {
      float4 w[NMAT];
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat)
        w[mat] = __ldg(reinterpret_cast<const float4*>((mat == 0 ? b0 : b1) +
                                                       static_cast<long long>(kk) * n + col));
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        if (r < t) {
          const float xv = __ldg(x + static_cast<long long>(r) * k + kk);
#pragma unroll
          for (int mat = 0; mat < NMAT; ++mat) {
            acc[mat][r][0] = fmaf(xv, w[mat].x, acc[mat][r][0]);
            acc[mat][r][1] = fmaf(xv, w[mat].y, acc[mat][r][1]);
            acc[mat][r][2] = fmaf(xv, w[mat].z, acc[mat][r][2]);
            acc[mat][r][3] = fmaf(xv, w[mat].w, acc[mat][r][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mat][r][e] += __shfl_xor_sync(0xffffffffu, acc[mat][r][e], 16);
      if (lane < 16)
        *reinterpret_cast<float4*>(&red[warp][mat][r][4 * cg]) =
            make_float4(acc[mat][r][0], acc[mat][r][1], acc[mat][r][2], acc[mat][r][3]);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < TR * kStBN; e += kSfThreads) {
    const int r = e / kStBN;
    const int cl = e % kStBN;
    const int gcol = blockIdx.x * kStBN + cl;
    if (r >= t || gcol >= n) continue;
    float v[NMAT];
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      float s = red[0][mat][r][cl];
#pragma unroll
      for (int w = 1; w < kSfThreads / 32; ++w) s += red[w][mat][r][cl];
      v[mat] = s;
    }
    if (splits == 1) {
      c[static_cast<long long>(r) * n + gcol] = NMAT == 2 ? silu(v[0]) * v[NMAT - 1] : v[0];
    } else {
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat)
        ws[((static_cast<long long>(blockIdx.y) * NMAT + mat) * t + r) * n + gcol] = v[mat];
    }
  }
}

// Sums the K slices' partials in slice order, then the epilogue.
template <typename T, int NMAT>
__global__ void __launch_bounds__(256)
swiglu_reduce_kernel(const float* __restrict__ ws, T* __restrict__ c, int t, int n,
                     int splits) {
  const long long total = static_cast<long long>(t) * n;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < total; e += gridDim.x * 256LL) {
    float v[NMAT];
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      float s = 0.0f;
      for (int sp = 0; sp < splits; ++sp) s += ws[(static_cast<long long>(sp) * NMAT + mat) * total + e];
      v[mat] = s;
    }
    store_out(c + e, NMAT == 2 ? silu(v[0]) * v[NMAT - 1] : v[0]);
  }
}

template <int NMAT>
cudaError_t launch_stream(const void* a, const void* b0, const void* b1, void* c, float* ws,
                          int m, int n, int k, int kper, int splits, bool bf, cudaStream_t s) {
  const dim3 grid((n + kStBN - 1) / kStBN, splits);
  if (bf) {
    static bool ready[16] = {};
    int device = 0;
    cudaGetDevice(&device);
    auto kern = swiglu_stream_kernel<NMAT>;
    const int smem = static_cast<int>(sizeof(StTiles<NMAT>));
    cudaError_t err = repro::allow_smem(kern, smem, device, ready);
    if (err != cudaSuccess) return err;
    kern<<<grid, kStThreads, smem, s>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b0),
                                        static_cast<const bf16*>(b1), static_cast<bf16*>(c), ws,
                                        m, n, k, kper, splits);
  } else {
#define REPRO_SF(TR)                                                                       \
  swiglu_stream_f32_kernel<NMAT, TR><<<grid, kSfThreads, 0, s>>>(                          \
      static_cast<const float*>(a), static_cast<const float*>(b0),                         \
      static_cast<const float*>(b1), static_cast<float*>(c), ws, m, n, k, kper, splits)
    if (m <= 4) REPRO_SF(4);
    else if (m <= 8) REPRO_SF(8);
    else REPRO_SF(16);
#undef REPRO_SF
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = static_cast<long long>(m) * n;
  const int blocks = static_cast<int>(std::min((total + 255) / 256, 4096LL));
  if (bf)
    swiglu_reduce_kernel<bf16, NMAT><<<blocks, 256, 0, s>>>(ws, static_cast<bf16*>(c), m, n,
                                                             splits);
  else
    swiglu_reduce_kernel<float, NMAT><<<blocks, 256, 0, s>>>(ws, static_cast<float*>(c), m, n,
                                                              splits);
  return cudaGetLastError();
}

// ======================================================================= //
// Large T, float32: CUDA-core tiles
// ======================================================================= //
constexpr int kFT = 64;  // block rows and columns
constexpr int kFK = 16;  // k slice
constexpr int kFThreads = 256;

template <bool kDual>
__global__ void __launch_bounds__(kFThreads)
swiglu_f32_tile_kernel(const float* __restrict__ A, const float* __restrict__ B0,
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
    for (int i = 0; i < kFT * kFK / kFThreads; ++i) {
      const int e = tid + i * kFThreads;
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
      for (int i = 0; i < kFT * kFK / kFThreads; ++i) {
        const int e = tid + i * kFThreads;
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

// One product [m, k] @ [k, n] (two for up), planned by the wrapper:
// splits > 0 streams the weights in `splits` K slices of `kper` rows
// (ws: splits x nmat x m x n floats when splits > 1); splits == 0 tiles.
template <int NMAT>
int run(const void* a, const void* b0, const void* b1, void* c, float* ws, int m, int n, int k,
        int kper, int splits, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 0) {
    if (m > kStRows || kper < 1 || (splits > 1 && ws == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_stream<NMAT>(a, b0, b1, c, ws, m, n, k, kper, splits, is_bf16 != 0, s);
  } else if (is_bf16) {
    err = launch_wgmma<NMAT>(a, b0, b1, c, m, n, k, device, s);
  } else {
    const dim3 grid((n + kFT - 1) / kFT, (m + kFT - 1) / kFT);
    swiglu_f32_tile_kernel<NMAT == 2><<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b0),
        static_cast<const float*>(b1), static_cast<float*>(c), m, n, k);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// up: h [T, F] = silu(x Wg) * (x Wu) in x's dtype.
extern "C" int repro_swiglu_up(const void* x, const void* wg, const void* wu, void* h,
                               float* ws, int t, int d, int f, int kper, int splits,
                               int is_bf16, int device, void* stream) {
  return run<2>(x, wg, wu, h, ws, t, f, d, kper, splits, is_bf16, device, stream);
}

// down: out [T, D] = h Wo in x's dtype.
extern "C" int repro_swiglu_down(const void* h, const void* wo, void* out, float* ws, int t,
                                 int d, int f, int kper, int splits, int is_bf16, int device,
                                 void* stream) {
  return run<1>(h, wo, nullptr, out, ws, t, d, f, kper, splits, is_bf16, device, stream);
}
