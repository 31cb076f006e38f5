// Single-token attention over a KV cache with a valid-prefix length and an
// optional window (flash decoding), bf16 or float32, float32 softmax and sums.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention/
// kernel.py: `decode_attention_pallas` (body `_kernel`).  Same math: logits
// `q . k * scale` over cache positions `< length` (and `> length - 1 -
// window`), a running max / normaliser / accumulator, `acc / max(l,
// 1e-30)`.  Positions outside that range weigh exactly 0, as the
// reference's -1e30 logits do.  When the range is empty (length 0) every
// logit of the reference is -1e30 and its softmax weighs all S_max rows
// equally: the kernel then reads the whole cache with equal logits, so the
// output is the mean of V, as `ref.py` computes (the Pallas kernel returns
// zeros there; ROADMAP Queue 3).
//
// Layout: q [B, H, Dh], caches [B, S_max, Hkv, Dh] (the model's per-layer
// layout, read in place), out [B, H, Dh], all contiguous; `length` is one
// device int32, so the decode step needs no host sync.  GQA: query head h
// reads KV head h / (H / Hkv); the cache is never repeated.
//
// Bound on the H100: the cache read.  At B = 16, length 32000, 8 KV heads,
// Dh = 64, bf16, one layer reads 1.05 GB of K and V (0.31 ms at 3.35
// TB/s); the arithmetic is 4 flops per cache element and query head, 8 per
// cache byte at 8 query heads per KV head: far under the tensor cores'
// ~295 per byte, but more than the CUDA cores issue beside the conversions.
//
// Design: `decode_tma_kernel`, one launch.
// (1) The work, B * Hkv groups (a sequence's KV head and its query heads;
//     for MHA over an even count of heads, two adjacent heads) x n = hi -
//     lo valid rows, flattened group by group, is cut into equal
//     contiguous ranges of ceil(W / grid) rows, one per block, stream-K
//     style: a range may end mid-tile and cross from one group into the
//     next.  The grid is host-known (one block per SM: one wave); each
//     block reads `length` and computes its own range (kernels/
//     decode_attention/kernel.py:segments mirrors the formula).  Every
//     group's rows are spread over the whole card whatever B * Hkv is.
// (2) A producer warp keeps a four-stage ring of K and V tiles (TILE rows
//     of the group's KV heads, the whole head dim) in flight with TMA
//     through 4-D tensor maps over the cache (Dh, S_max, Hkv, B) and
//     `mbarrier`s for full and empty slots, without L2 promotion (a tile
//     row is a head's slice of a cache row: promoted to 256 bytes it read
//     ~2x the bytes at head dims 64 and 112); rows past the range are
//     loaded and masked, rows past S_max come back zero-filled.  Four
//     consumer warps take a quarter of each tile's rows each, with their
//     own online softmax (in log2 units: 2^x with the scale times log2(e)).
// (3) bf16 GQA (2 or more query heads per KV head): the products run on
//     the tensor cores, `mma.sync` m16n8k16.  The group's <= 8 query rows,
//     padded to 16, are the A fragment of S = Q K^T and stay in registers
//     through the range; K is read from the 128-byte-swizzled tile with
//     `ldmatrix`, V with `ldmatrix.trans`; P goes from the S accumulator
//     straight into the A fragment of O += P V, FlashAttention-2's way.
//     The padded rows' products are issued with their accumulators dead
//     (their inputs zero), so they cost no registers.  Rounding P to bf16
//     is the one rounding the plain version does not make (<= 2^-9 relative
//     per weight).  MHA and every float32 case run on CUDA cores from
//     unswizzled tiles in shared memory: a cache row is split over Dh /
//     (16 B) lanes, each holding the query heads' elements of its 16 bytes
//     (MHA is ~1 operation per byte; in float32 TF32 would break the 2e-5
//     tolerance).  MHA reads its heads in pairs: one head's 224-byte slice
//     at Dh 112 starts off a 64-byte boundary every other head, two heads'
//     448 bytes do not (zamba2's 524,288-row read on an H100: 2.9 -> 2.5 ms).
// (4) At the end of each group's segment the warps merge through shared
//     memory.  A block that holds a whole group writes its output; one that
//     holds part of it writes a float32 partial (m, l, acc) into one of its
//     two workspace slots (slot 0: its first group, slot 1: its last), then
//     `__threadfence` and an atomic on the group's counter tell the last of
//     the group's blocks to merge the partials in block order (fixed order:
//     equal bits from call to call), write the output and reset the counter
//     to 0.  The counters live in a zeroed buffer the wrapper keeps per
//     device and stream across calls: no memset is launched.
// The form, tile rows, ring stages and blocks per SM were timed with
// `tools/kernel_plans.py decode` (PERF.md, row 8): the kernel runs within
// 8 % of its ring alone (the same kernel with the arithmetic taken out) at
// the timed shapes but one 19 us call, so the products are hidden under
// the cache read; the CUDA-core form ran GQA 1.1-2.8x slower.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;                     // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;   // and the producer warp
constexpr float kNeg = -1e30f;                // the running max before any row
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// A tile row is one KV head's slice of a cache row (128-256 bytes, the
// next head's slice beside it): no L2 promotion, which would fetch the
// neighbours' bytes with it (2x the reads at head dims 64 and 112).
constexpr CUtensorMapL2promotion kPromotion = CU_TENSOR_MAP_L2_PROMOTION_NONE;

// 2^x: the special-function unit for bf16 operands, the library's exp2f
// for float32.
template <typename T>
__device__ __forceinline__ float exp2_of(float x) {
  if constexpr (std::is_same<T, bf16>::value) {
    return repro::exp2_approx(x);
  } else {
    return exp2f(x);
  }
}

// 16 bytes of T as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&out)[4]) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
  __device__ __forceinline__ static void put(float* p, float x) { *p = x; }
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&out)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float one(const bf16* p) { return __bfloat162float(*p); }
  __device__ __forceinline__ static void put(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// The c0, c1 half (rows lane / 4) of c += a (16 x 16) * b (16 x 8), bf16
// in, float32 accumulate, for an A whose rows 8..15 are zero: those rows'
// accumulators go in as zero and come out dead.
__device__ __forceinline__ void mma_top(float (&c)[2], uint32_t a0, uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.0f));
}

// The warps' states at the end of a segment, merged through shared memory:
// acc [kWarps][NREP][DH], then m and l [kWarps][NREP].
template <int DH, int NREP>
struct Merge {
  static constexpr int kFloats = kWarps * NREP * (DH + 2);
  float* acc;
  float* m;
  float* l;
  __device__ explicit Merge(float* base)
      : acc(base), m(base + kWarps * NREP * DH), l(base + kWarps * NREP * (DH + 1)) {}
};

// ---------------------------------------------------------------------- //
// Consumers: what the four warps do with a tile.  Each has
//   begin(q of the group, scale_log2)  the group's query rows, a fresh state;
//   tile(stage, row0, end, uniform)    the tile at cache row row0 (rows at
//                                      or past `end` masked; `uniform`: all
//                                      logits 0);
//   finish(merge)                      the warp's state into shared memory;
// and the stage's layout and its TMA loads.
// ---------------------------------------------------------------------- //

// CUDA cores, from unswizzled [HEADS][TILE][DH] tiles of K and of V.  A row
// is split over kLanes lanes of 16 bytes, spanning the next power of two;
// a warp reads kGroups consecutive rows at once.  HEADS = 1: the group's
// NREP query rows share one KV head.  HEADS = NREP = 2 (MHA): a group is
// two adjacent heads and query row r reads head r, so a tile row is two
// heads' slices side by side (448 bytes at Dh 112, on a 64-byte boundary,
// where one head's 224 bytes start off it every other head).
template <typename T_, int DH_, int NREP_, int TILE_, int STAGES_, int HEADS = 1>
struct CoreTile {
  using T = T_;
  static constexpr int DH = DH_, NREP = NREP_, TILE = TILE_, STAGES = STAGES_;
  static constexpr int kHeads = HEADS;
  static constexpr int kVec = Vec<T>::kN;
  static constexpr int kLanes = DH / kVec;
  static constexpr int kSpan = kLanes <= 8 ? 8 : kLanes <= 16 ? 16 : 32;
  static constexpr int kGroups = 32 / kSpan;
  static constexpr int kKW = TILE / kWarps;        // rows of a tile per warp
  static constexpr int kRows = kKW / kGroups;      // rows per lane group per tile
  static constexpr int kU = kRows < 4 ? kRows : 4;  // rows per online update
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  static constexpr int kHeadBytes = TILE * kRowBytes;
  static constexpr int kTileBytes = HEADS * kHeadBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static_assert(DH % kVec == 0 && kLanes <= 32 && kKW % kGroups == 0 && kRows % kU == 0 &&
                (HEADS == 1 || HEADS == NREP), "tile shape");
  static_assert(kTileBytes % 128 == 0 && TILE <= 256, "TMA box");

  int warp, grp, sub;
  bool on;  // lanes past the row's end hold zeros
  float qv[NREP][kVec], m[NREP], l[NREP], acc[NREP][kVec];

  __device__ CoreTile(int warp_, int lane) : warp(warp_), grp(lane / kSpan), sub(lane % kSpan) {
    on = sub < kLanes;
  }

  static bool maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v,
                   const cuuint64_t* dims, const cuuint64_t* strides) {
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(DH), static_cast<cuuint32_t>(TILE), HEADS,
                               1};
    return repro::tensor_map_tiled(tk, Vec<T>::kType, k, 4, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_NONE, kPromotion) &&
           repro::tensor_map_tiled(tv, Vec<T>::kType, v, 4, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_NONE, kPromotion);
  }

  __device__ static void load(uint8_t* stage, const CUtensorMap* tk, const CUtensorMap* tv,
                              uint64_t* bar, int row, int h, int b) {
    repro::tma_load_4d(stage, tk, bar, 0, row, h, b);
    repro::tma_load_4d(stage + kTileBytes, tv, bar, 0, row, h, b);
  }

  __device__ void begin(const T* qg, float scale_log2) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        qv[r][j] = on ? Vec<T>::one(qg + r * DH + sub * kVec + j) * scale_log2 : 0.0f;
      m[r] = kNeg;
      l[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] = 0.0f;
    }
  }

  __device__ void tile(const uint8_t* stage, int row0, int end, bool uniform) {
    const uint8_t* kt = stage + sub * 16;
    const uint8_t* vt = stage + kTileBytes + sub * 16;
#pragma unroll
    for (int u0 = 0; u0 < kRows; u0 += kU) {
      float kx[kU][kVec], vx[kU][kVec];
      int rows[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) rows[u] = warp * kKW + (u0 + u) * kGroups + grp;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        if (r == 0 || HEADS > 1) {  // the rows of query row r's head
          const int hd = HEADS > 1 ? r * kHeadBytes : 0;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
            if (on) {
              kr = *reinterpret_cast<const uint4*>(kt + hd + rows[u] * kRowBytes);
              vr = *reinterpret_cast<const uint4*>(vt + hd + rows[u] * kRowBytes);
            }
            Vec<T>::unpack(kr, kx[u]);
            Vec<T>::unpack(vr, vx[u]);
          }
        }
        float sc[kU];
        float m_blk = -INFINITY;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float dot = 0.0f;
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot = fmaf(qv[r][j], kx[u][j], dot);
#pragma unroll
          for (int off = kSpan / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
          sc[u] = row0 + rows[u] < end ? (uniform ? 0.0f : dot) : -INFINITY;
          m_blk = fmaxf(m_blk, sc[u]);
        }
        const float m_new = fmaxf(m[r], m_blk);
        const float alpha = exp2_of<T>(m[r] - m_new);
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[r][j] *= alpha;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float p = exp2_of<T>(sc[u] - m_new);
          l[r] += p;
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[r][j] = fmaf(p, vx[u][j], acc[r][j]);
        }
        m[r] = m_new;
      }
    }
  }

  __device__ void finish(Merge<DH, NREP>& mg) {
    // The lane groups of the warp (lanes with the same `sub`), by shuffles.
#pragma unroll
    for (int off = kSpan; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float mo = __shfl_xor_sync(kFull, m[r], off);
        const float lo = __shfl_xor_sync(kFull, l[r], off);
        const float mm = fmaxf(m[r], mo);
        const float a = exp2_of<T>(m[r] - mm);
        const float c = exp2_of<T>(mo - mm);
        l[r] = fmaf(l[r], a, lo * c);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float ao = __shfl_xor_sync(kFull, acc[r][j], off);
          acc[r][j] = fmaf(acc[r][j], a, ao * c);
        }
        m[r] = mm;
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        if (sub == 0) {
          mg.m[warp * NREP + r] = m[r];
          mg.l[warp * NREP + r] = l[r];
        }
        if (on) {
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            mg.acc[(warp * NREP + r) * DH + sub * kVec + j] = acc[r][j];
        }
      }
    }
  }
};

// Tensor cores (bf16, 2-8 query heads per KV head), from K and V tiles of
// 64-column slabs under a 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)); Dh 112's second slab is zero-filled past column 111.
template <int DH_, int NREP_, int TILE_, int STAGES_>
struct MmaTile {
  using T = bf16;
  static constexpr int DH = DH_, NREP = NREP_, TILE = TILE_, STAGES = STAGES_;
  static constexpr int kSlabs = (DH + 63) / 64;
  static constexpr int kSlabBytes = TILE * 128;
  static constexpr int kTileBytes = kSlabs * kSlabBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kKW = TILE / kWarps;  // keys of a tile per warp
  static constexpr int kNT = kKW / 8;        // 8-key column tiles of S
  static constexpr int kKS = DH / 16;        // 16-deep steps of Q K^T
  static constexpr int kDT = DH / 8;         // 8-column tiles of O
  static constexpr int kHeads = 1;           // KV heads per group
  static_assert(NREP >= 2 && NREP <= 8 && DH % 16 == 0 && kKW % 16 == 0 && TILE <= 256,
                "tile shape");

  int warp, row, t4;  // the thread's query row (lane / 4) and column pair (lane % 4)
  uint32_t qa[kKS][2];  // Q's A fragment: rows `row`, columns 16 kk + 2 t4 (+ 8)
  float o[kDT][2];      // O's row `row`, columns 8 dt + 2 t4, + 1
  float m_row, l_row;   // this thread's share of the row's sum; the quad adds up at the end
  float scale_log2;

  __device__ MmaTile(int warp_, int lane) : warp(warp_), row(lane >> 2), t4(lane & 3) {}

  static bool maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v,
                   const cuuint64_t* dims, const cuuint64_t* strides) {
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(TILE), 1, 1};
    return repro::tensor_map_tiled(tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, 4, dims, strides,
                                   box, CU_TENSOR_MAP_SWIZZLE_128B, kPromotion) &&
           repro::tensor_map_tiled(tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, 4, dims, strides,
                                   box, CU_TENSOR_MAP_SWIZZLE_128B, kPromotion);
  }

  __device__ static void load(uint8_t* stage, const CUtensorMap* tk, const CUtensorMap* tv,
                              uint64_t* bar, int r, int h, int b) {
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      repro::tma_load_4d(stage + sl * kSlabBytes, tk, bar, sl * 64, r, h, b);
      repro::tma_load_4d(stage + kTileBytes + sl * kSlabBytes, tv, bar, sl * 64, r, h, b);
    }
  }

  // Byte offset of 16-byte chunk `ch` (of DH / 8) of tile row `key`.
  __device__ static int at(int key, int ch) {
    return (ch >> 3) * kSlabBytes + key * 128 + (((ch & 7) ^ (key & 7)) << 4);
  }

  __device__ void begin(const bf16* qg, float scale_log2_) {
    scale_log2 = scale_log2_;
    const bool real = row < NREP;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(qg + row * DH + 2 * t4);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      qa[kk][0] = real ? qw[8 * kk] : 0u;
      qa[kk][1] = real ? qw[8 * kk + 4] : 0u;
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) o[dt][0] = o[dt][1] = 0.0f;
    m_row = kNeg;
    l_row = 0.0f;
  }

  __device__ void tile(const uint8_t* stage, int row0, int end, bool uniform) {
    const int lane = row * 4 + t4;
    const int key0 = warp * kKW;
    float s[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = 0.0f;
    // S = Q K^T: ldmatrix x4 gives two column tiles' B fragments a step.
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        const int key = key0 + 8 * (nt + (lane >> 4)) + (lane & 7);
        uint32_t bk[4];
        repro::ldmatrix_x4(bk, stage + at(key, 2 * kk + ((lane >> 3) & 1)));
        mma_top(s[nt], qa[kk][0], qa[kk][1], bk[0], bk[1]);
        mma_top(s[nt + 1], qa[kk][0], qa[kk][1], bk[2], bk[3]);
      }
    }
    // The online softmax of row `row` over the warp's keys (a quad holds a row).
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = row0 + key0 + 8 * nt + 2 * t4 + e < end;
        s[nt][e] = ok ? (uniform ? 0.0f : s[nt][e] * scale_log2) : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_row, mx);
    const float alpha = exp2_of<bf16>(m_row - m_new);
    m_row = m_new;
    l_row *= alpha;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o[dt][0] *= alpha;
      o[dt][1] *= alpha;
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2_of<bf16>(s[nt][e] - m_new);
        l_row += s[nt][e];
      }
    }
    // O += P V: P's A fragment from S's accumulators, V by ldmatrix.trans.
#pragma unroll
    for (int ks = 0; ks < kKW / 16; ++ks) {
      const uint32_t pa0 = repro::pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      const uint32_t pa2 = repro::pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      const int key = key0 + 16 * ks + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(bv, stage + kTileBytes + at(key, dt + (lane >> 4)));
        mma_top(o[dt], pa0, pa2, bv[0], bv[1]);
        mma_top(o[dt + 1], pa0, pa2, bv[2], bv[3]);
      }
    }
  }

  __device__ void finish(Merge<DH, NREP>& mg) {
    float l = l_row;
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    if (row < NREP) {
      if (t4 == 0) {
        mg.m[warp * NREP + row] = m_row;
        mg.l[warp * NREP + row] = l;
      }
      float* a = mg.acc + (warp * NREP + row) * DH + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        a[8 * dt] = o[dt][0];
        a[8 * dt + 1] = o[dt][1];
      }
    }
  }
};

// The block's share of the work: W = groups x n rows, flattened group by
// group, cut into ranges of ceil(W / grid) rows; this block's is [w0, w1).
// kernels/decode_attention/kernel.py:segments mirrors it.  The wrapper
// keeps W under 2^31, so unsigned 32-bit arithmetic holds every product
// (ptxas calls a subroutine for a 64-bit division, and spills around it).
struct Share {
  unsigned n, chunk, w0, w1;
  __device__ Share(int n_rows, int groups, int grid, int block) : n(n_rows) {
    const unsigned w = n * static_cast<unsigned>(groups);
    chunk = (w + grid - 1) / grid;
    w0 = block * chunk;
    w1 = min(w, w0 + chunk);
  }
  __device__ int first_group() const { return w0 / n; }
  __device__ int last_group() const { return (w1 - 1) / n; }
  // Group g's rows in this range, [a, z) of its n.
  __device__ void rows(int g, int& a, int& z) const {
    const unsigned base = g * n;
    a = max(w0, base) - base;
    z = min(w1, base + n) - base;
  }
  // The blocks whose ranges meet group g, and the workspace slot block j
  // keeps g's partial in (0 if g is j's first group, else 1).
  __device__ int first_block(int g) const { return g * n / chunk; }
  __device__ int last_block(int g) const { return (g * n + n - 1) / chunk; }
  __device__ int slot(int j, int g) const {
    return j * chunk / n == static_cast<unsigned>(g) ? 0 : 1;
  }
};

// The last block of a split group merges its blocks' partials, j = fb..lb
// in order (the bits do not depend on which block is last): an online
// merge, a thread per (query row, head dim) element, each thread's kE
// elements at once and kJ partials a step, so ~3 kE kJ independent L2
// loads are in flight instead of one at a time.
template <typename T, int NREP, int DH>
__device__ __forceinline__ void merge_partials(const float* part, T* og, const Share& sh, int g,
                                               int fb, int lb, int tid) {
  constexpr int kPart = NREP * (DH + 2);
  constexpr int kE = (NREP * DH + kWarps * 32 - 1) / (kWarps * 32);
  constexpr int kJ = kE >= 5 ? 2 : 4;  // <= 3 x 16 registers of loads
  float mm[kE], ls[kE], o[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    mm[k] = -INFINITY;
    ls[k] = 0.0f;
    o[k] = 0.0f;
  }
  for (int j0 = fb; j0 <= lb; j0 += kJ) {
    float pm[kJ][kE], pl[kJ][kE], pa[kJ][kE];
#pragma unroll
    for (int u = 0; u < kJ; ++u) {
      const int j = j0 + u;
      const float* pj = part + (2LL * j + sh.slot(j, g)) * kPart;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int e = tid + k * kWarps * 32;
        const bool ok = j <= lb && e < NREP * DH;
        const int r = e / DH;
        pm[u][k] = ok ? __ldcg(pj + NREP * DH + r) : -INFINITY;
        pl[u][k] = ok ? __ldcg(pj + NREP * DH + NREP + r) : 0.0f;
        pa[u][k] = ok ? __ldcg(pj + e) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kJ; ++u) {
      if (j0 + u > lb) break;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const float mn = fmaxf(mm[k], pm[u][k]);
        const float a = exp2f(mm[k] - mn);
        const float c = exp2f(pm[u][k] - mn);
        ls[k] = fmaf(ls[k], a, pl[u][k] * c);
        o[k] = fmaf(o[k], a, pa[u][k] * c);
        mm[k] = mn;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int e = tid + k * kWarps * 32;
    if (e < NREP * DH) Vec<T>::put(og + e, o[k] / fmaxf(ls[k], 1e-30f));
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
}

template <class C>
constexpr int smem_bytes() {
  return 1024 + C::STAGES * C::kStageBytes + Merge<C::DH, C::NREP>::kFloats * 4 +
         2 * C::STAGES * 8;
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
decode_tma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const typename C::T* __restrict__ q, const int* __restrict__ length_ptr,
                  typename C::T* __restrict__ out, float* __restrict__ part,
                  unsigned* __restrict__ count, int s_max, int n_kv, int n_groups,
                  float scale_log2, int window) {
  // A group: C::kHeads KV heads of a sequence (`n_kv` groups a sequence)
  // and their NREP query heads, contiguous in q and out.
  using T = typename C::T;
  constexpr int DH = C::DH, NREP = C::NREP, TILE = C::TILE, STAGES = C::STAGES;
  constexpr int kPart = NREP * (DH + 2);  // one workspace slot: acc [NREP][DH], then m, l
  extern __shared__ __align__(128) uint8_t dec_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dec_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  float* merge_base = reinterpret_cast<float*>(ring + STAGES * C::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(merge_base + Merge<DH, NREP>::kFloats);
  uint64_t* empty = full + STAGES;
  __shared__ int last_flag;

  // The valid range, as kernels/decode_attention/kernel.py:valid_range.
  const int length = *length_ptr;
  int hi = min(length, s_max);
  int lo = window > 0 ? max(0, length - window) : 0;
  const bool uniform = hi <= lo;  // no valid row: equal weight on all S_max rows
  if (uniform) {
    lo = 0;
    hi = s_max;
  }
  const Share sh(hi - lo, n_groups, gridDim.x, blockIdx.x);
  if (sh.w0 >= sh.w1) return;  // a range past the work (W < grid)
  const int g_first = sh.first_group(), g_last = sh.last_group();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], kWarps);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // Tile i of the block (counted over its segments) uses stage i % STAGES
  // in phase (i / STAGES) & 1.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kWarps) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      int i = 0;
      for (int g = g_first; g <= g_last; ++g) {
        int a, z;
        sh.rows(g, a, z);
        for (int r = lo + a; r < lo + z; r += TILE, ++i) {
          const int s = i % STAGES;
          repro::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          repro::mbar_expect_tx(&full[s], C::kStageBytes);
          C::load(ring + s * C::kStageBytes, &tk, &tv, &full[s], r, g % n_kv * C::kHeads,
                  g / n_kv);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;  // 0..127: the consumers
  Merge<DH, NREP> mg(merge_base);
  C c(warp, lane);
  int i = 0;
  for (int g = g_first; g <= g_last; ++g) {
    int a, z;
    sh.rows(g, a, z);
    c.begin(q + static_cast<long long>(g) * NREP * DH, scale_log2);
    for (int r = lo + a; r < lo + z; r += TILE, ++i) {
      const int s = i % STAGES;
      repro::mbar_wait(&full[s], (i / STAGES) & 1);
      c.tile(ring + s * C::kStageBytes, r, lo + z, uniform);
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(&empty[s]);
    }
    c.finish(mg);
    consumers_sync();

    // Merge the warps: one thread per (query row, head dim).  A warp that
    // saw no valid row holds m = -1e30, l = 0 and weighs 0.
    const int fb = sh.first_block(g), lb = sh.last_block(g);
    const bool whole = fb == lb;
    float* slot = part + (2LL * blockIdx.x + (g == g_first ? 0 : 1)) * kPart;
    T* og = out + static_cast<long long>(g) * NREP * DH;
    for (int e = tid; e < NREP * DH; e += kWarps * 32) {
      const int r = e / DH;
      float mm = mg.m[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, mg.m[w * NREP + r]);
      float lsum = 0.0f, o = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float cw = exp2f(mg.m[w * NREP + r] - mm);
        lsum = fmaf(mg.l[w * NREP + r], cw, lsum);
        o = fmaf(mg.acc[w * NREP * DH + e], cw, o);
      }
      if (whole) {
        Vec<T>::put(og + e, o / fmaxf(lsum, 1e-30f));
      } else {
        slot[e] = o;
        if (e % DH == 0) {
          slot[NREP * DH + r] = mm;
          slot[NREP * DH + NREP + r] = lsum;
        }
      }
    }
    if (!whole) {
      // The last of the group's blocks to get here merges its partials.
      __threadfence();
      consumers_sync();
      if (tid == 0) {
        const unsigned n_parts = static_cast<unsigned>(lb - fb + 1);
        const unsigned ticket = atomicAdd(&count[g], 1u);
        last_flag = ticket == n_parts - 1;
        if (last_flag) count[g] = 0;  // ready for the next call
      }
      consumers_sync();
      if (last_flag) {
        __threadfence();
        merge_partials<T, NREP, DH>(part, og, sh, g, fb, lb, tid);
      }
    }
    consumers_sync();  // the merge area and the flag are free again
  }
}

struct Args {
  const void *q, *k, *v;
  const int* len;
  void* o;
  float* part;
  unsigned* count;
  int b, s_max, n_kv, grid;
  float scale;
  int window;
};

template <class C>
cudaError_t occupancy(int device, int* blocks_per_sm) {
  auto kern = decode_tma_kernel<C>;
  static bool ready[16] = {};
  const cudaError_t err = repro::allow_smem(kern, smem_bytes<C>(), device, ready);
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, kThreads,
                                                       smem_bytes<C>());
}

template <class C>
cudaError_t launch(const Args& a, int device, cudaStream_t s) {
  using T = typename C::T;
  if (a.n_kv % C::kHeads) return cudaErrorInvalidValue;  // pairs of heads need an even count
  cudaError_t err = occupancy<C>(device, nullptr);
  if (err != cudaSuccess) return err;
  // The cache as (Dh, S_max, Hkv, B), byte strides; a dimension of extent
  // 1 never steps, so its stride is free: it takes 16 (TMA wants multiples
  // of 16).
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C::DH), static_cast<cuuint64_t>(a.s_max),
                              static_cast<cuuint64_t>(a.n_kv), static_cast<cuuint64_t>(a.b)};
  const cuuint64_t strides[3] = {a.s_max > 1 ? a.n_kv * C::DH * e : 16,
                                 a.n_kv > 1 ? C::DH * e : 16,
                                 a.b > 1 ? a.s_max * a.n_kv * C::DH * e : 16};
  CUtensorMap tk, tv;
  if (!C::maps(&tk, &tv, a.k, a.v, dims, strides)) return cudaErrorInvalidValue;
  const int per_b = a.n_kv / C::kHeads;  // groups a sequence
  decode_tma_kernel<C><<<a.grid, kThreads, smem_bytes<C>(), s>>>(
      tk, tv, static_cast<const T*>(a.q), a.len, static_cast<T*>(a.o), a.part, a.count,
      a.s_max, per_b, a.b * per_b, a.scale * kLog2e, a.window);
  return cudaGetLastError();
}

// The instance each (dtype, head dim, query heads per KV head) runs: bf16
// GQA on the tensor cores, MHA and float32 on CUDA cores; four ring stages
// of 64-row tiles in bf16 and 32-row tiles in float32 (<= 128 KB: one block
// an SM, the wrapper's grid); MHA over an even count of heads in pairs,
// half the rows a tile.  `tools/kernel_plans.py decode` timed 2-4
// stages, 32-128 rows and 1-4 blocks per SM level within a few per cent,
// except that more blocks per SM split the short calls' groups into more
// partials and ran slower.
template <typename T, int DH, int NREP>
struct Plan {
  static constexpr bool kMma = std::is_same<T, bf16>::value && NREP >= 2;
  static constexpr int kTile = std::is_same<T, bf16>::value ? 64 : 32;
  using type = typename std::conditional<kMma, MmaTile<DH, (NREP >= 2 ? NREP : 2), kTile, 4>,
                                         CoreTile<T, DH, NREP, kTile, 4>>::type;
};

template <typename T, int DH, int NREP>
cudaError_t run(const Args& a, int device, cudaStream_t s) {
  if constexpr (NREP == 1) {
    if (a.n_kv % 2 == 0)
      return launch<CoreTile<T, DH, 2, Plan<T, DH, 1>::kTile / 2, 4, 2>>(a, device, s);
  }
  return launch<typename Plan<T, DH, NREP>::type>(a, device, s);
}

// Instantiated for the (head dim, query heads per KV head) pairs of the
// ported configs: llama3.2-1b (64, 32 / 8 = 4), whisper-medium's self and
// cross attention (64, MHA: 1) and its smoke config, zamba2-7b's shared
// attention (112, MHA: 1), kimi-k2-1t-a32b (112, 64 / 8 = 8),
// phi3-medium-14b (128, 40 / 10 = 4), mixtral-8x22b (128, 48 / 8 = 6),
// qwen2-vl-2b (128, 12 / 2 = 6), yi-34b (128, 56 / 8 = 7) and
// command-r-35b (128, 64 / 8 = 8); and the smoke configs at the kernels'
// head dim of 64 (`configs.for_kernels` widens their head dims and keeps
// their ratios of 2, 3, 7 and 8).  Other shapes are added when a config
// needs them.
template <typename T>
cudaError_t dispatch(int dh, int n_rep, const Args& a, int device, cudaStream_t s) {
  if (dh == 64) {
    switch (n_rep) {
      case 1: return run<T, 64, 1>(a, device, s);
      case 2: return run<T, 64, 2>(a, device, s);
      case 3: return run<T, 64, 3>(a, device, s);
      case 4: return run<T, 64, 4>(a, device, s);
      case 7: return run<T, 64, 7>(a, device, s);
      case 8: return run<T, 64, 8>(a, device, s);
    }
  } else if (dh == 112) {
    switch (n_rep) {
      case 1: return run<T, 112, 1>(a, device, s);
      case 8: return run<T, 112, 8>(a, device, s);
    }
  } else if (dh == 128) {
    switch (n_rep) {
      case 4: return run<T, 128, 4>(a, device, s);
      case 6: return run<T, 128, 6>(a, device, s);
      case 7: return run<T, 128, 7>(a, device, s);
      case 8: return run<T, 128, 8>(a, device, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// `length` points at one device int32; `window` <= 0 means no window.
// `grid` blocks (the wrapper's: one per SM); `part` holds 2 * grid
// workspace slots of max(H / Hkv, 2) * (dh + 2) floats, `count` B * Hkv
// zeroed counters (left zeroed).  One launch.
extern "C" int repro_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const int* length, void* out, float* part,
                                      unsigned* count, int b, int h, int hkv, int s_max, int dh,
                                      int grid, float scale, int window, int is_bf16,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || h == 0) return 0;
  if (grid < 1 || s_max < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, length, out, part, count, b, s_max, hkv, grid, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch<bf16>(dh, h / hkv, a, device, s)
                : dispatch<float>(dh, h / hkv, a, device, s);
  return static_cast<int>(err);
}
