// Causal, sliding-window or bidirectional attention with an online softmax
// (flash attention), bf16 or float32 operands, float32 softmax and sums.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/
// kernel.py: `flash_attention_pallas` (body `_kernel`).  Same math: logits
// `q . k * scale`, masked to -1e30 outside the causal (and window) band
// with the `skv - sq` offset, a running max / normaliser / accumulator per
// query row, and `acc / max(l, 1e-30)` at the end.
//
// Layout: q [B, H, Sq, Dh], k / v [B, Hkv, Skv, Dh], out [B, H, Sq, Dh] as
// strided views (batch, head and sequence strides in elements; the head
// dimension is unit-stride), so the model's [B, S, H, Dh] tensors go in
// and come out without a transpose copy.  GQA: query head h reads KV head
// h / (H / Hkv) in place; the KV heads are never repeated.  Fully masked
// key tiles cost nothing (the Pallas grid still visits them).
//
// Bound on the H100: the tensor cores.  A causal prefill does ~2 S^2 Dh
// multiply-adds per head (the causal half of Q K^T and P V): at
// phi3-medium-14b's (B = 4, S = 4096, 40 / 10 heads, Dh = 128) 687 GFLOP
// against ~419 MB of q, k, v and out, 0.695 ms at 989 TFLOP/s bf16 (0.125
// ms of bytes); at llama3.2-1b's (32 / 8 heads, Dh = 64) 0.278 ms.  Each
// logit also takes one 2^x on the special-function unit (16 a clock per
// SM, ~3.9 T/s): at head dim 64 that is as long as the products.
//
// bf16 (the serving and training path): `flash_wgmma_kernel`, the
// FlashAttention-3 design.  A block owns 128 query rows of one (batch, head);
// causal query tiles run longest first, and a head's tiles are in flight
// together, sharing its K and V in L2.  Three warpgroups: one thread of the
// producer issues TMA loads (`setmaxnreg` lowers the group to 24 registers)
// and two consumer warpgroups own 64 query rows each (240 registers).  Q, K
// and V are read through 4-D tensor maps over the strided views (Dh, S, H, B;
// byte strides), 64-column boxes under a 128-byte swizzle (Dh 128 takes two;
// Dh 112's second box is zero-filled past column 111), so the model's [B, S,
// H, Dh] tensors need no copy.  K and V go through a two-stage ring of 128-key
// tiles with `mbarrier`s for full and empty slots, K and V apart (K is free
// once S is done).  S = Q K^T is one `wgmma` m64n128k16 per 16-deep step, Q
// and K K-major from shared memory, float32 accumulators in registers.  The
// online softmax runs on the accumulator fragments (row max and sum over each
// 4-lane quad, 2^x with scale * log2(e) folded into one fmaf; the library
// builds with -fmad=false, so every contraction is written out).  P is rounded
// to bf16 in registers and is the register A operand of O += P V, `wgmma`
// m64nDHk16 (the accumulator layout of two adjacent 8-column groups is the A
// layout): P never touches shared memory; V is read MN-major, transposed by
// the descriptor.  FlashAttention-3's overlap: S of tile t and P V of tile
// t - 1 issue together and the softmax of tile t runs under P V, and the two
// consumer warpgroups issue their products in turn (named barriers), so one's
// softmax runs under the other's products.  Masks are computed only on key
// tiles that cross the diagonal, the window edge or the end of the keys, and
// the key loop of a query tile runs from its window limit to its causal limit.
// A masked logit is -inf rather than the reference's -1e30: every query row
// sees at least its own key (Sq <= Skv when causal, window >= 1), so the
// reference weighs a masked key exactly 0 too, and with the scale folded into
// the fmaf a finite -1e30 would cancel against a rounded -1e30 * scale to an
// error of ~1e22.  The output rows are normalised by one reciprocal a row,
// rounded, and stored from the registers.  A persistent grid (one block per SM
// taking work tiles from a counter, the next Q loading under the current tile)
// timed level with this one within noise, and was dropped.  Rounding P to bf16
// is the one rounding the plain version does not make (FlashAttention-3 and
// SDPA make it too): <= 2^-9 relative per weight.  Head dim 112 runs P V at
// N = 112 on the half filled second box (at N = 128, on its zero-filled
// columns, ptxas serialises the products for want of registers).  The tile
// choices (keys per stage, stages, O's width) were timed with
// `tools/kernel_plans.py flash`.  TMA needs 16-byte-aligned rows:
// the wrapper checks the base pointers and strides and raises otherwise.
//
// float32 (the parity path; tensor cores would mean TF32, which the 2e-5
// rule excludes): `flash_fwd_kernel` on CUDA cores -- four threads per
// query row, each holding an interleaved quarter of the head dims, 32-key
// float32 tiles in shared memory, explicit fmaf.  Its static K and V tiles
// are 2 x 32 x (Dh + 4) floats: 33.8 KB at head dim 128, under the 48 KB
// static limit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;  // elements; the head-dim stride is 1
};

// ----------------------------------------------------------------------- //
// bf16: wgmma tiles fed by a TMA ring
// ----------------------------------------------------------------------- //
constexpr int kWgBQ = 128;         // query rows per block: two consumer warpgroups x 64
constexpr int kWgThreads = 384;    // consumers (warpgroups 0, 1), producer (2)

// DH: head dim; BKV: keys per ring stage; STAGES: ring depth; PVN: the
// width of the O accumulator (DH, or DH rounded up to the 64-column slab).
template <int DH, int BKV, int STAGES, int PVN>
struct WgTile {
  static constexpr int kSlabs = (DH + 63) / 64;       // 64-column (128-byte) slabs of a row
  static constexpr int kQSlab = kWgBQ * 128;          // bytes of one Q slab
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKvSlab = BKV * 128;           // bytes of one K or V slab
  static constexpr int kKBytes = kSlabs * kKvSlab;
  static constexpr int kStageBytes = 2 * kKBytes;     // K, then V
  static constexpr int kSmem = 1024 + kQBytes + STAGES * kStageBytes + (4 * STAGES + 1) * 8;
  static constexpr int kKs = DH / 16;                 // k steps of S = Q K^T
  static_assert(DH % 16 == 0 && PVN % 16 == 0 && PVN >= DH && PVN <= 64 * kSlabs, "head dim");
  static_assert(BKV == 64 || BKV == 128, "keys per stage");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) repro::wgmma_ss_m64n64k16(d, da, db, acc);
  else repro::wgmma_ss_m64n128k16(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) repro::wgmma_rs_m64n64k16(d, a, db);
  else if constexpr (N == 112) repro::wgmma_rs_m64n112k16(d, a, db);
  else repro::wgmma_rs_m64n128k16(d, a, db);
}

// Orders the compiler's reads and writes of wgmma registers after the wait
// that completes them (the asm statements of an asynchronous product name
// its registers, the wait does not).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// Ping-pong of the two consumer warpgroups: each issues its products in
// turn (named barriers 3 and 4, 256 threads: the waiting warpgroup's sync
// and the other's arrive), so one warpgroup's softmax runs under the
// other's products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}

// S = Q K^T for one key tile, issued and committed (not waited for): 64 rows
// x BKV keys; Q and K both K-major, a k step of 16 dims is 32 bytes into a
// 128-byte swizzled row, and dims 64-127 are the second slab.
template <class C, int BKV>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2], const uint8_t* s_qw,
                                         const uint8_t* tk_s) {
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
  repro::wg_fence();
#pragma unroll
  for (int kk = 0; kk < C::kKs; ++kk) {
    const int sl = kk / 4, in = (kk % 4) * 32;
    wgmma_ss<BKV>(sc, repro::wg_desc(s_qw + sl * C::kQSlab + in, 16),
                  repro::wg_desc(tk_s + sl * C::kKvSlab + in, 16), kk > 0);
  }
  repro::wg_commit();
}

// O += P V for one key tile, issued and committed: P (bf16 registers) is the
// A operand, V is read N-major, its 64-column slabs kKvSlab bytes apart.
template <class C, int BKV, int PVN>
__device__ __forceinline__ void issue_pv(float (&acc)[PVN / 2], const uint32_t (&pa)[BKV / 16][4],
                                         const uint8_t* tv_s) {
  repro::wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs<PVN>(acc, pa[kk], repro::wg_desc(tv_s + kk * 16 * 128, C::kKvSlab));
  repro::wg_commit();
}

// O's rows times the softmax's rescale factors (alpha[0] for the thread's
// first row, alpha[1] for the row 8 below).
template <int PVN>
__device__ __forceinline__ void rescale(float (&acc)[PVN / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < PVN / 8; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// P rounded to bf16 in registers: keys 16 kk .. 16 kk + 15 are the
// accumulator's columns j = 2 kk, 2 kk + 1, the A layout of k step kk.
template <int BKV>
__device__ __forceinline__ void pack_p(const float (&sc)[BKV / 2], uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = repro::pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

// The online softmax of one S tile on its fragments, in place: masks (only
// on `edge` tiles: the diagonal, the window edge or skv), the running max,
// the weights 2^(s scale log2e - m scale log2e) and the running sum of the
// thread's rows r = 0, 1 (row_in, row_in + 8); alpha[r] rescales the rows of
// O.  A row's keys live in one 4-lane quad; kp0 is the key of column 2 t4.
template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2], float (&m_row)[2],
                                             float (&l_row)[2], float (&alpha)[2], bool edge,
                                             int kp0, int qpos0, int skv, int causal, int window,
                                             float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = kp0 + j * 8 + (i & 1);
        const int qpos = qpos0 + (i >> 1) * 8;
        if (kp >= skv || (causal && (kp > qpos || (window > 0 && kp <= qpos - window))))
          sc[4 * j + i] = -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m_row[r];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    // A row that has seen no key yet keeps m = -inf; 0 then stands in for
    // its scaled max, so every weight and alpha is exp2(-inf) = 0.
    const float m_scaled = mx == -INFINITY ? 0.0f : mx * scale_log2;
    alpha[r] = repro::exp2_approx(fmaf(m_row[r], scale_log2, -m_scaled));
    m_row[r] = mx;
    float l = l_row[r] * alpha[r];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = repro::exp2_approx(fmaf(sc[4 * j + 2 * r + e], scale_log2, -m_scaled));
        sc[4 * j + 2 * r + e] = p;
        l += p;
      }
    }
    l_row[r] = l;
  }
}

// A block owns query rows [q0, q0 + 128) of head h of batch b: the grid's x
// index, reversed, is the query tile (the longest causal tiles first, and a
// head's tiles in flight together share its K and V in L2), y the (batch,
// head).
template <int DH, int BKV, int STAGES, int PVN>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, Strides os,
                   int n_heads, int n_rep, int sq, int skv, float scale_log2, int causal,
                   int window) {
  using C = WgTile<DH, BKV, STAGES, PVN>;
  extern __shared__ __align__(128) uint8_t wg_smem[];
  uint8_t* s_q = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* s_kv = s_q + C::kQBytes;  // [STAGES][K slabs, V slabs]
  // K and V of a stage fill and empty apart: K is free once S is done.
  uint64_t* full_k = reinterpret_cast<uint64_t*>(s_kv + STAGES * C::kStageBytes);
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  uint64_t* q_full = empty_v + STAGES;

  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y % n_heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int offset = skv - sq;
  // The keys this query tile can see, from a tile boundary.
  const int last_row = min(q0 + kWgBQ, sq) - 1;
  int kv_lo = 0, kv_hi = skv;
  if (causal) {
    kv_hi = min(skv, last_row + offset + 1);
    if (window > 0) kv_lo = max(0, q0 + offset - window + 1);
  }
  kv_lo = (kv_lo / BKV) * BKV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(&full_k[s], 1);
      repro::mbar_init(&full_v[s], 1);
      repro::mbar_init(&empty_k[s], 8);  // lane 0 of each consumer warp
      repro::mbar_init(&empty_v[s], 8);
    }
    repro::mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // Key tile t uses stage t % STAGES in phase (t / STAGES) & 1.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const int hk = h / n_rep;
      repro::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl)
        repro::tma_load_4d(s_q + sl * C::kQSlab, &tq, q_full, sl * 64, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t phase = ((t / STAGES) & 1) ^ 1;
        uint8_t* st = s_kv + s * C::kStageBytes;
        const int k0 = kv_lo + t * BKV;
        repro::mbar_wait(&empty_k[s], phase);
        repro::mbar_expect_tx(&full_k[s], C::kKBytes);
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl)
          repro::tma_load_4d(st + sl * C::kKvSlab, &tk, &full_k[s], sl * 64, k0, hk, b);
        repro::mbar_wait(&empty_v[s], phase);
        repro::mbar_expect_tx(&full_v[s], C::kKBytes);
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl)
          repro::tma_load_4d(st + C::kKBytes + sl * C::kKvSlab, &tv, &full_v[s], sl * 64, k0, hk,
                             b);
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int row_in = (tid >> 5) * 16 + (lane >> 2);  // the thread's rows: row_in, row_in + 8
    const int qpos0 = q0 + wg * 64 + row_in + offset;
    const uint8_t* s_qw = s_q + wg * 64 * 128;  // the warpgroup's rows of each Q slab
    auto k_of = [&](int t) { return s_kv + (t % STAGES) * C::kStageBytes; };
    auto v_of = [&](int t) { return s_kv + (t % STAGES) * C::kStageBytes + C::kKBytes; };
    auto parity = [](int t) { return static_cast<uint32_t>((t / STAGES) & 1); };
    // Masks, only on tiles that cross the diagonal, the window edge or skv.
    auto edge = [&](int k0) {
      return k0 + BKV > skv ||
             (causal && (k0 + BKV - 1 > q0 + offset ||
                         (window > 0 && k0 <= q0 + kWgBQ - 1 + offset - window)));
    };

    float acc[PVN / 2];
    float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t pa[BKV / 16][4];  // P of the last tile, the A operand of its P V product
#pragma unroll
    for (int i = 0; i < PVN / 2; ++i) acc[i] = 0.0f;

    repro::mbar_wait(q_full, 0);
    if (wg == 1) turn_pass(1);  // warpgroup 0 issues first
    // FlashAttention-3's order: S of tile t and P V of tile t - 1 are issued
    // together, and the softmax of tile t runs under P V.  Tile 0's S runs
    // alone, the last P V after the loop; the loop has no branch on t, so
    // the compiler sees which products each wait completes.
    if (n_tiles > 0) {
      repro::mbar_wait(&full_k[0], 0);
      float sc[BKV / 2];
      turn_wait(wg);
      issue_qk<C, BKV>(sc, s_qw, k_of(0));
      turn_pass(wg);
      repro::wg_wait<0>();
      fence_regs(sc);
      if (lane == 0) repro::mbar_arrive(&empty_k[0]);
      softmax_tile<BKV>(sc, m_row, l_row, alpha, edge(kv_lo), kv_lo + 2 * t4, qpos0, skv,
                        causal, window, scale_log2);
      pack_p<BKV>(sc, pa);
    }
    for (int t = 1; t < n_tiles; ++t) {
      const int k0 = kv_lo + t * BKV;
      repro::mbar_wait(&full_k[t % STAGES], parity(t));
      float sc[BKV / 2];
      turn_wait(wg);
      issue_qk<C, BKV>(sc, s_qw, k_of(t));
      rescale<PVN>(acc, alpha);  // to tile t - 1's max, under S
      repro::mbar_wait(&full_v[(t - 1) % STAGES], parity(t - 1));
      issue_pv<C, BKV, PVN>(acc, pa, v_of(t - 1));
      turn_pass(wg);
      repro::wg_wait<1>();
      fence_regs(sc);
      if (lane == 0) repro::mbar_arrive(&empty_k[t % STAGES]);
      softmax_tile<BKV>(sc, m_row, l_row, alpha, edge(k0), k0 + 2 * t4, qpos0, skv, causal,
                        window, scale_log2);
      repro::wg_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) repro::mbar_arrive(&empty_v[(t - 1) % STAGES]);
      pack_p<BKV>(sc, pa);
    }
    if (n_tiles > 0) {
      const int t = n_tiles - 1;
      rescale<PVN>(acc, alpha);
      repro::mbar_wait(&full_v[t % STAGES], parity(t));
      turn_wait(wg);
      issue_pv<C, BKV, PVN>(acc, pa, v_of(t));
      turn_pass(wg);
      repro::wg_wait<0>();
      fence_regs(acc);
    }
    // Warpgroup 1's first pass is matched by warpgroup 0's last wait.
    if (wg == 0) turn_wait(0);

    // Normalise (one reciprocal a row), round, and store each bf16 pair of
    // the accumulator straight from its registers: rows below sq.
    bf16* ob = o + b * os.b + h * os.h + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_row[r];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const float inv = 1.0f / fmaxf(l, 1e-30f);
      const int row = q0 + wg * 64 + row_in + 8 * r;
      if (row < sq) {
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row) * os.s + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// One strided [B, H, S, Dh] bf16 operand as a 4-D tensor map (Dh, S, H, B)
// in boxes of 64 columns x `box_rows` rows.  A dimension of extent 1 never
// steps, so its stride is free: it takes 16 bytes (TMA wants multiples of 16).
bool head_map(CUtensorMap* map, const void* ptr, Strides st, int dh, int s, int h, int b,
              int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {s > 1 ? static_cast<cuuint64_t>(st.s) * 2 : 16,
                                 h > 1 ? static_cast<cuuint64_t>(st.h) * 2 : 16,
                                 b > 1 ? static_cast<cuuint64_t>(st.b) * 2 : 16};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  return repro::tensor_map_bf16(map, ptr, 4, dims, strides, box);
}

template <int DH, int BKV, int STAGES, int PVN>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, Strides qs,
                         Strides ks, Strides vs, Strides os, int b, int h, int hkv, int sq,
                         int skv, float scale, int causal, int window, int device,
                         cudaStream_t s) {
  using C = WgTile<DH, BKV, STAGES, PVN>;
  auto kern = flash_wgmma_kernel<DH, BKV, STAGES, PVN>;
  static bool ready[16] = {};
  const cudaError_t err = repro::allow_smem(kern, C::kSmem, device, ready);
  if (err != cudaSuccess) return err;
  // With no keys the K / V maps are never read: they describe q instead.
  const bool none = skv == 0;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, qs, DH, sq, h, b, kWgBQ) ||
      !head_map(&tk, none ? q : k, none ? qs : ks, DH, none ? 1 : skv, none ? 1 : hkv, b, BKV) ||
      !head_map(&tv, none ? q : v, none ? qs : vs, DH, none ? 1 : skv, none ? 1 : hkv, b, BKV))
    return cudaErrorInvalidValue;
  const dim3 grid((sq + kWgBQ - 1) / kWgBQ, b * h);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  kern<<<grid, kWgThreads, C::kSmem, s>>>(tq, tk, tv, static_cast<bf16*>(o), os, h, h / hkv, sq,
                                          skv, scale_log2, causal, window);
  return cudaGetLastError();
}

// ----------------------------------------------------------------------- //
// float32: CUDA cores
// ----------------------------------------------------------------------- //
constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 32;       // keys per shared-memory tile
constexpr int kThreads = 256;  // four threads per query row

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
                 Strides vs, Strides os, int n_heads, int n_rep, int sq, int skv, float scale,
                 int causal, int window) {
  constexpr int kPart = DH / 4;  // head dims per thread: d = i * 4 + part
  __shared__ float k_tile[kBKV][DH + 4];
  __shared__ float v_tile[kBKV][DH + 4];

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int part = tid & 3;
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y % n_heads;
  const int hk = h / n_rep;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + row;
  const int offset = skv - sq;
  const int qpos = qi + offset;  // absolute position of this query row

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float qr[kPart], acc[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) {
    qr[i] = qi < sq ? qb[qi * qs.s + i * 4 + part] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNeg, l = 0.0f;

  // The keys this query tile can see.
  const int last_row = min(q0 + kBQ, sq) - 1;
  int kv_lo = 0, kv_hi = skv;
  if (causal) {
    kv_hi = min(skv, last_row + offset + 1);
    if (window > 0) kv_lo = max(0, q0 + offset - window + 1);
  }
  kv_lo = (kv_lo / kBKV) * kBKV;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBKV * DH; e += kThreads) {
      const int r = e / DH;
      const int d = e % DH;
      const int kp = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (kp < skv) {
        kx = kb[kp * ks.s + d];
        vx = vb[kp * vs.s + d];
      }
      k_tile[r][d] = kx;
      v_tile[r][d] = vx;
    }
    __syncthreads();

    float s[kBKV];
    float m_blk = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBKV; ++c) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kPart; ++i) dot = fmaf(qr[i], k_tile[c][i * 4 + part], dot);
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      const int kp = k0 + c;
      float sc;
      if (kp >= skv) {
        sc = -INFINITY;  // past the keys: weight exactly 0
      } else {
        bool ok = true;
        if (causal) {
          ok = kp <= qpos;
          if (window > 0) ok = ok && kp > qpos - window;
        }
        sc = ok ? dot * scale : kNeg;
      }
      s[c] = sc;
      m_blk = fmaxf(m_blk, sc);
    }
    const float m_new = fmaxf(m, m_blk);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPart; ++i) acc[i] *= alpha;
#pragma unroll
    for (int c = 0; c < kBKV; ++c) {
      const float p = expf(s[c] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < kPart; ++i) acc[i] = fmaf(p, v_tile[c][i * 4 + part], acc[i]);
    }
    m = m_new;
  }

  if (qi < sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* ob = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int i = 0; i < kPart; ++i) ob[i * 4 + part] = acc[i] / denom;
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, Strides qs,
                       Strides ks, Strides vs, Strides os, int b, int h, int hkv, int sq,
                       int skv, float scale, int causal, int window, cudaStream_t s) {
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_fwd_kernel<DH><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), qs, ks, vs, os, h, h / hkv, sq, skv, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// `window` <= 0 means no window; it applies only when `causal` is set (as
// in the reference).  The wrapper checks the shapes, the head dims and, for
// bf16, the 16-byte alignment of every row.  llama3.2-1b's head dim (64),
// zamba2-7b's (3584 / 32 = 112) and the 128 of phi3-medium-14b, yi-34b and
// command-r-35b; other widths are instantiated when a config needs them.
// The GQA ratio is a runtime argument.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     long long q_sb, long long q_sh, long long q_ss,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss,
                                     long long o_sb, long long o_sh, long long o_ss, int b,
                                     int h, int hkv, int sq, int skv, int dh, float scale,
                                     int causal, int window, int is_bf16, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || h == 0 || sq == 0) return 0;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && dh == 64) {
    err = launch_wgmma<64, 128, 2, 64>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale,
                                       causal, window, device, s);
  } else if (is_bf16 && dh == 112) {
    err = launch_wgmma<112, 128, 2, 112>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale,
                                         causal, window, device, s);
  } else if (is_bf16 && dh == 128) {
    err = launch_wgmma<128, 128, 2, 128>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale,
                                         causal, window, device, s);
  } else if (!is_bf16 && dh == 64) {
    err = launch_f32<64>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale, causal,
                         window, s);
  } else if (!is_bf16 && dh == 112) {
    err = launch_f32<112>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale, causal,
                          window, s);
  } else if (!is_bf16 && dh == 128) {
    err = launch_f32<128>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale, causal,
                          window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
