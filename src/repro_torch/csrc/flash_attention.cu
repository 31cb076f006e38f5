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
// h / (H / Hkv) in place; the KV heads are never repeated.  The key loop
// of a query tile starts at its window limit and ends at its causal limit,
// so fully masked key tiles cost nothing (the Pallas grid still visits
// them).
//
// Bound on the H100: at the llama3.2-1b prefill (B = 4, S = 4096, 32 / 8
// heads, Dh = 64, causal) the work is ~2 * S^2 * Dh per head (the causal
// half of QK^T and PV): 275 GFLOP per layer against ~168 MB of q, k, v
// and out, so the tensor cores bound it (~0.28 ms at 989 TFLOP/s bf16).
//
// bf16 (the serving path): `flash_mma_kernel`, FlashAttention-2's forward
// on warp-level mma.sync (m16n8k16, float32 accumulate).  A block owns
// WARPS * 16 * MT query rows of one (batch, head), 16 * MT per warp; Q is
// copied in once with cp.async and held in registers as A fragments
// (ldmatrix).  K and V go through a two-stage cp.async ring of BKV-key
// bf16 tiles in dynamic shared memory, each row padded by 16 bytes so that
// ldmatrix's eight row addresses fall in distinct banks (Dh 112's 224-byte
// rows included).  S = Q K^T reads K row-major as the `.col` B operand; the
// online softmax runs on the accumulator fragments (row max and sum over
// each 4-lane quad, 2^x on the special-function unit with scale * log2(e)
// folded into one fmaf; the library builds with -fmad=false, so every
// contraction is written out); P is rounded to bf16 in registers and is
// directly the A operand of O += P V (the m16n8 C layout of two adjacent
// key tiles is the m16n8k16 A layout) with V through ldmatrix.trans: P
// never touches shared memory.  Each K / V fragment read from shared memory
// feeds the warp's MT row tiles.  Masks are computed only on key tiles that
// cross the diagonal, the window edge or the end of the keys.  A masked
// logit is -inf rather than the reference's -1e30: every query row sees at
// least its own key (Sq <= Skv when causal, window >= 1), so the reference
// weighs a masked key exactly 0 too, and with the scale folded into the
// fmaf a finite -1e30 would cancel against a rounded -1e30 * scale to an
// error of ~1e22.  Causal query tiles run longest first (the grid's x index
// reversed) so the grid's tail is short.  The output is normalised, rounded
// and staged through shared memory into 16-byte coalesced stores.  Rounding
// P to bf16 is the one rounding the plain version does not make
// (FlashAttention-2 and SDPA make it too): <= 2^-9 relative per weight.
// Tiles, chosen by timing variants on the H100: head dim 64 takes 4 warps x
// 32 rows (MT 2) and 64-key tiles (255 registers, 2 blocks per SM); head
// dim 112 takes 8 warps x 16 rows and 32-key tiles (its 56 accumulator
// registers per row tile leave no room for MT 2); head dim 128 (phi3,
// yi, command-r) takes 4 warps x 16 rows and 64-key tiles: its 64
// accumulator and 32 Q-fragment registers per thread fit under the 255
// that two 128-thread blocks per SM allow, where 8 warps would be held to
// 128 and spill (`tools/kernel_plans.py flash_dh128` times the variants).
// Head dim 128's Q tile and two-stage K / V ring take 87 KB of dynamic
// shared memory (`repro::allow_smem` lifts the 48 KB default).  The copies need
// 16-byte-aligned rows: the wrapper checks the base pointers and strides
// and raises otherwise.  wgmma + TMA with a producer warp is later work.
//
// float32 (the parity path; tensor cores would mean TF32, which the 2e-5
// rule excludes): `flash_fwd_kernel` on CUDA cores -- four threads per
// query row, each holding an interleaved quarter of the head dims, 32-key
// float32 tiles in shared memory, explicit fmaf.  Its static K and V tiles
// are 2 x 32 x (Dh + 4) floats: 33.8 KB at head dim 128, under the 48 KB
// static limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;  // elements; the head-dim stride is 1
};

// ----------------------------------------------------------------------- //
// bf16: mma.sync tiles
// ----------------------------------------------------------------------- //
template <int DH, int WARPS, int MT, int BKV>
struct MmaTile {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kBQ = WARPS * 16 * MT;  // query rows per block, 16 * MT per warp
  static constexpr int kBKV = BKV;             // keys per pipeline stage
  static constexpr int kLd = DH + 8;           // shared row pitch (elements): +16 bytes
  static constexpr int kChunks = DH / 8;       // 16-byte chunks per row
  static constexpr int kKs = DH / 16;          // k steps of S = Q K^T, d pairs of O
  static constexpr size_t kSmem = static_cast<size_t>(kBQ + 4 * kBKV) * kLd * sizeof(bf16);
  static_assert(DH % 16 == 0 && BKV % 16 == 0, "tile shape");
  static_assert(kBQ * kChunks % kThreads == 0, "the Q and output tiles split evenly");
};

// Copy rows [row0, row0 + ROWS) of a strided [rows, DH] bf16 matrix into a
// padded shared tile; rows at or past `limit` are zero-filled.
template <class C, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long stride, int row0,
                                          int limit) {
  constexpr int kCopies = ROWS * C::kChunks;
#pragma unroll
  for (int i = 0; i < (kCopies + C::kThreads - 1) / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    if (kCopies % C::kThreads != 0 && c >= kCopies) break;
    const int r = c / C::kChunks;
    const int col = (c % C::kChunks) * 8;
    const bool ok = row0 + r < limit;
    const bf16* s = ok ? src + static_cast<long long>(row0 + r) * stride + col : src;
    repro::cp_async16(dst + r * C::kLd + col, s, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH, int WARPS, int MT, int BKV>
__global__ void __launch_bounds__(WARPS * 32, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, Strides qs, Strides ks,
                 Strides vs, Strides os, int n_heads, int n_rep, int sq, int skv,
                 float scale_log2, int causal, int window) {
  using C = MmaTile<DH, WARPS, MT, BKV>;
  constexpr int kBQ = C::kBQ, kBKV = C::kBKV, kLd = C::kLd, kKs = C::kKs;
  constexpr int kNt = kBKV / 8;  // n8 key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][kLd]; the output tile at the end
  bf16* s_k = s_q + kBQ * kLd;                    // [2][kBKV][kLd]
  bf16* s_v = s_k + 2 * kBKV * kLd;               // [2][kBKV][kLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;  // fragment column pair
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y % n_heads;
  const int hk = h / n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal tiles first
  const int w0 = warp * 16 * MT;                      // the warp's first row in the tile
  const int offset = skv - sq;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // The keys this query tile can see, from a tile boundary.
  const int last_row = min(q0 + kBQ, sq) - 1;
  int kv_lo = 0, kv_hi = skv;
  if (causal) {
    kv_hi = min(skv, last_row + offset + 1);
    if (window > 0) kv_lo = max(0, q0 + offset - window + 1);
  }
  kv_lo = (kv_lo / kBKV) * kBKV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kBKV - 1) / kBKV : 0;

  copy_rows<C, kBQ>(s_q, qb, qs.s, q0, sq);
  if (n_tiles > 0) {
    copy_rows<C, kBKV>(s_k, kb, ks.s, kv_lo, skv);
    copy_rows<C, kBKV>(s_v, vb, vs.s, kv_lo, skv);
  }
  repro::cp_async_commit();

  // Per m16 tile mt: Q's A fragments, O's accumulators, and for fragment
  // rows g (r = 0) and g + 8 (r = 1) the raw-logit max and this thread's
  // share of the normaliser.
  uint32_t qf[MT][kKs][4];
  float acc[MT][2 * kKs][4];
  float m_row[MT][2], l_row[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 2 * kKs; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_row[mt][r] = -INFINITY;
      l_row[mt][r] = 0.0f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = kv_lo + t * kBKV;
    if (t + 1 < n_tiles) {  // that stage's readers passed the last barrier
      copy_rows<C, kBKV>(s_k + (st ^ 1) * kBKV * kLd, kb, ks.s, k0 + kBKV, skv);
      copy_rows<C, kBKV>(s_v + (st ^ 1) * kBKV * kLd, vb, vs.s, k0 + kBKV, skv);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk)
          repro::ldmatrix_x4(qf[mt][kk], s_q + (w0 + mt * 16 + (lane & 15)) * kLd + kk * 16 +
                                             (lane >> 4) * 8);
    }
    const bf16* tk = s_k + st * kBKV * kLd;
    const bf16* tv = s_v + st * kBKV * kLd;

    // S = Q K^T: 16 * MT rows x kBKV keys per warp; a K fragment feeds all
    // MT row tiles.
    float s[MT][kNt][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][n][i] = 0.0f;
#pragma unroll
    for (int np = 0; np < kNt / 2; ++np) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t bk[4];  // keys np*16 + {0..7, 8..15} x dims kk*16 + {0..7, 8..15}
        repro::ldmatrix_x4(bk, tk + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          repro::mma_bf16(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
          repro::mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
        }
      }
    }

    // Masks, only on tiles that cross the diagonal, the window edge or skv.
    const bool edge = k0 + kBKV > skv ||
                      (causal && (k0 + kBKV - 1 > q0 + offset ||
                                  (window > 0 && k0 <= q0 + kBQ - 1 + offset - window)));
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kp = k0 + n * 8 + 2 * t4 + (i & 1);
            const int qpos = q0 + w0 + mt * 16 + g + (i >> 1) * 8 + offset;
            if (kp >= skv || (causal && (kp > qpos || (window > 0 && kp <= qpos - window))))
              s[mt][n][i] = -INFINITY;
          }
    }

    // Online softmax on the fragments: thread holds rows g (i = 0, 1) and
    // g + 8 (i = 2, 3) of each m16 tile; a row's keys live in one 4-lane
    // quad.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_row[mt][r];
#pragma unroll
        for (int n = 0; n < kNt; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        // A row that has seen no key yet keeps m = -inf; 0 then stands in for
        // its scaled max, so every weight and alpha is exp2(-inf) = 0.
        const float m_scaled = mx == -INFINITY ? 0.0f : mx * scale_log2;
        const float alpha = exp2_approx(fmaf(m_row[mt][r], scale_log2, -m_scaled));
        m_row[mt][r] = mx;
        l_row[mt][r] *= alpha;
#pragma unroll
        for (int n = 0; n < 2 * kKs; ++n) {
          acc[mt][n][2 * r] *= alpha;
          acc[mt][n][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = exp2_approx(fmaf(s[mt][n][2 * r + j], scale_log2, -m_scaled));
            s[mt][n][2 * r + j] = p;
            l_row[mt][r] += p;
          }
        }
      }
    }

    // O += P V: P's accumulator fragments are the A operand, V via
    // ldmatrix.trans; a V fragment feeds all MT row tiles.
#pragma unroll
    for (int j = 0; j < kNt / 2; ++j) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kKs; ++dp) {
        uint32_t bv[4];  // keys j*16 + {0..15} x dims dp*16 + {0..7, 8..15}
        repro::ldmatrix_x4_trans(bv, tv + (j * 16 + (lane & 15)) * kLd + dp * 16 +
                                         (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          repro::mma_bf16(acc[mt][2 * dp], pa[mt], bv[0], bv[1]);
          repro::mma_bf16(acc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled next iteration
  }
  repro::cp_async_wait<0>();  // the Q copy, when no key tile ran
  __syncthreads();

  // Normalise, round, stage the tile in s_q, then 16-byte coalesced stores.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_row[mt][r];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const float denom = fmaxf(l, 1e-30f);
      bf16* dst = s_q + (w0 + mt * 16 + g + r * 8) * kLd + 2 * t4;
#pragma unroll
      for (int n = 0; n < 2 * kKs; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(acc[mt][n][2 * r] / denom, acc[mt][n][2 * r + 1] / denom);
    }
  }
  __syncthreads();
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kBQ * C::kChunks / C::kThreads; ++i) {
    const int c = threadIdx.x + i * C::kThreads;
    const int r = c / C::kChunks;
    const int col = (c % C::kChunks) * 8;
    if (q0 + r < sq)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(q0 + r) * os.s + col) =
          *reinterpret_cast<const uint4*>(s_q + r * kLd + col);
  }
}

template <int DH, int WARPS, int MT, int BKV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, Strides qs,
                       Strides ks, Strides vs, Strides os, int b, int h, int hkv, int sq,
                       int skv, float scale, int causal, int window, int device,
                       cudaStream_t s) {
  using C = MmaTile<DH, WARPS, MT, BKV>;
  auto kern = flash_mma_kernel<DH, WARPS, MT, BKV>;
  static bool ready[16] = {};
  const cudaError_t err = repro::allow_smem(kern, static_cast<int>(C::kSmem), device, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, b * h);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  kern<<<grid, C::kThreads, C::kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), qs, ks, vs, os, h, h / hkv, sq, skv, scale_log2, causal, window);
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
    err = launch_mma<64, 4, 2, 64>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale,
                                   causal, window, device, s);
  } else if (is_bf16 && dh == 112) {
    err = launch_mma<112, 8, 1, 32>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale,
                                    causal, window, device, s);
  } else if (is_bf16 && dh == 128) {
    err = launch_mma<128, 4, 1, 64>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, scale,
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
