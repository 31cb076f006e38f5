// RWKV6 chunked WKV scan, bf16 or float32 operands, float32 arithmetic and
// state.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv6_scan/kernel.py:
// `rwkv6_scan_pallas` (body `_kernel`).  Same function: per chunk of C
// tokens, with pc the inclusive and pc_prev the exclusive cumulative
// log-decay,
//   out_i = (r_i e^{pc_prev_i}) S + sum_{j<i} [sum_d r_id k_jd e^{pc_prev_id - pc_jd}] v_j
//           + [(r_i * u) . k_i] v_i
//   S'    = e^{tot} S + sum_j (k_j e^{tot - pc_j})^T v_j.
// The TPU kernel forms the pair weight as (r e^{pc_prev}) . (k e^{-pc}),
// which overflows float32 once a chunk's decay passes e^-88 (the model's
// floor w = 0.05 reaches e^-96 over 32 tokens).  Both kernels here stay
// finite for any log-decay <= 0.
//
// Layout: r / k / lw [B, H, S, Dk], v / out [B, H, S, Dv] as strided views
// (batch, head and sequence strides in elements, unit last stride), so the
// model's [B, S, H, D] projections go in and come out without a copy; u
// [B, H, Dk] (strided, float32), the states s0 / s_T [B * H, Dk, Dv]
// contiguous float32 (s0 may be null: zeros).  lw is float32.
//
// Bound on the H100: at the rwkv6-1.6b prefill (B = 4, S = 4096, 32 heads,
// Dk = Dv = 64, chunk 32) a layer moves ~0.40 GB of operands (0.12 ms at
// 3.35 TB/s); its ~11 GFLOP of products take ~0.01 ms on the bf16 tensor
// cores, ~0.17 ms at the 67 TFLOP/s float32 rate.
//
// Two kernels.  `rwkv6_scan_kernel` (float32, and bf16 views off the
// 16-byte grid): CUDA cores, every pair weight one expf of a difference
// pc_prev_i - pc_j (at most 0).  `rwkv6_mma_kernel` (bf16): the chunk
// products on mma.sync tensor cores, with the per-key-dim decay folded
// into the operands by one anchor per chunk (see its comment).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;  // elements; the last stride is 1
};

// Shared floats: r, k, pc [C][Dk + 1]; v [C][VB]; att [C][C + 1]; the state
// slice [Dk][VB]; u [Dk].
long long smem_floats(int chunk, int dk, int vb) {
  return 3LL * chunk * (dk + 1) + 1LL * chunk * vb + 1LL * chunk * (chunk + 1) +
         1LL * dk * vb + dk;
}

// The CUDA-core kernel: one 256-thread block per (stream, slice of Dv
// columns).  The columns of S evolve independently, so a slice holds its
// Dk x slice part of the state in shared memory for the whole sequence
// (the TPU kernel's VMEM carry becomes the block's chunk loop); the
// launcher narrows the slice (64 -> 16 columns) until there are two blocks
// per SM.  Each chunk stages r, k and the log-decay as float32 rows padded
// to Dk + 1 (column reads stay conflict-free), scans the log-decay per key
// dim, forms the C x C pair weights with one expf per (i, j, d), then each
// thread keeps an R-row register tile of one column for the output and
// state products, with explicit fmaf.
// R: rows of the register tile per thread, >= ceil(max(C, Dk) / (256 / VB)).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ lw, const float* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ s_t,
                  Strides rs, Strides ks, Strides vs, Strides ws, Strides os, long long u_sb,
                  long long u_sh, int n_heads, int seq, int dk, int dv, int chunk, int vb) {
  extern __shared__ float smem[];
  const int kp = dk + 1;
  const int ap = chunk + 1;
  float* r_s = smem;                     // r, then r * e^{pc_prev}
  float* k_s = r_s + chunk * kp;         // k, then k * e^{tot - pc}
  float* pc_s = k_s + chunk * kp;        // lw, then its inclusive cumsum
  float* v_s = pc_s + chunk * kp;        // this block's v columns
  float* att = v_s + chunk * vb;         // pair weights, bonus on the diagonal
  float* st = att + chunk * ap;          // state slice [Dk][VB]
  float* u_s = st + dk * vb;

  const int tid = threadIdx.x;
  const int stream = blockIdx.x;
  const int b = stream / n_heads;
  const int h = stream % n_heads;
  const int v0 = blockIdx.y * vb;
  const int col = tid % vb;  // register tile: one column, rows grp + ng * q
  const int grp = tid / vb;
  const int ng = kThreads / vb;

  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vbp = v + b * vs.b + h * vs.h + v0;
  const float* wb = lw + b * ws.b + h * ws.h;
  T* ob = out + b * os.b + h * os.h + v0;
  const long long sbase = static_cast<long long>(stream) * dk * dv + v0;

  for (int e = tid; e < dk * vb; e += kThreads) {
    const int d = e / vb;
    const int j = e % vb;
    st[e] = s0 != nullptr ? s0[sbase + static_cast<long long>(d) * dv + j] : 0.0f;
  }
  for (int d = tid; d < dk; d += kThreads) u_s[d] = u[b * u_sb + h * u_sh + d];

  for (int c0 = 0; c0 < seq; c0 += chunk) {
    const int cl = min(chunk, seq - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < cl * dk; e += kThreads) {
      const int i = e / dk;
      const int d = e % dk;
      const long long t = c0 + i;
      r_s[i * kp + d] = to_f32(rb[t * rs.s + d]);
      k_s[i * kp + d] = to_f32(kb[t * ks.s + d]);
      pc_s[i * kp + d] = wb[t * ws.s + d];
    }
    for (int e = tid; e < cl * vb; e += kThreads) {
      const int i = e / vb;
      const int j = e % vb;
      v_s[i * vb + j] = to_f32(vbp[(c0 + i) * vs.s + j]);
    }
    __syncthreads();

    // Inclusive cumsum of the log-decay over the chunk, one thread per key
    // dim, eight loads in flight.
    for (int d = tid; d < dk; d += kThreads) {
      float acc = 0.0f;
      for (int i0 = 0; i0 < cl; i0 += 8) {
        float x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] = i0 + q < cl ? pc_s[(i0 + q) * kp + d] : 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          acc += x[q];
          if (i0 + q < cl) pc_s[(i0 + q) * kp + d] = acc;
        }
      }
    }
    __syncthreads();

    // Pair weights: sum_d r_id k_jd e^{pc_{i-1,d} - pc_jd} for j < i, the
    // bonus (r_i * u) . k_i on the diagonal, 0 above it.
    for (int e = tid; e < cl * cl; e += kThreads) {
      const int i = e / cl;
      const int j = e % cl;
      const float* ri = r_s + i * kp;
      float acc = 0.0f;
      if (j < i) {
        const float* kj = k_s + j * kp;
        const float* pi = pc_s + (i - 1) * kp;
        const float* pj = pc_s + j * kp;
        for (int d = 0; d < dk; ++d) acc = fmaf(ri[d] * kj[d], expf(pi[d] - pj[d]), acc);
      } else if (j == i) {
        const float* ki = k_s + i * kp;
        for (int d = 0; d < dk; ++d) acc = fmaf(ri[d] * u_s[d], ki[d], acc);
      }
      att[i * ap + j] = acc;
    }
    __syncthreads();

    // r <- r e^{pc_prev}, k <- k e^{tot - pc} (both factors at most 1).
    const float* tot = pc_s + (cl - 1) * kp;
    for (int e = tid; e < cl * dk; e += kThreads) {
      const int i = e / dk;
      const int d = e % dk;
      const float prev = i > 0 ? pc_s[(i - 1) * kp + d] : 0.0f;
      r_s[i * kp + d] *= expf(prev);
      k_s[i * kp + d] *= expf(tot[d] - pc_s[i * kp + d]);
    }
    __syncthreads();

    // Outputs: out_i = r_dec_i S + sum_{j<=i} att_ij v_j, R rows per thread.
    {
      float acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = 0.0f;
      for (int d = 0; d < dk; ++d) {
        const float sv = st[d * vb + col];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = grp + ng * q;
          if (i < cl) acc[q] = fmaf(r_s[i * kp + d], sv, acc[q]);
        }
      }
      for (int j = 0; j < cl; ++j) {
        const float xv = v_s[j * vb + col];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = grp + ng * q;
          if (i < cl && j <= i) acc[q] = fmaf(att[i * ap + j], xv, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = grp + ng * q;
        if (i < cl) store(ob + (c0 + i) * os.s + col, acc[q]);
      }
    }
    __syncthreads();  // the outputs read the state before its update

    // State: S_dc <- e^{tot_d} S_dc + sum_j k_dec_jd v_jc, R key rows per thread.
    {
      float acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = 0.0f;
      for (int j = 0; j < cl; ++j) {
        const float xv = v_s[j * vb + col];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int d = grp + ng * q;
          if (d < dk) acc[q] = fmaf(k_s[j * kp + d], xv, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int d = grp + ng * q;
        if (d < dk) st[d * vb + col] = fmaf(expf(tot[d]), st[d * vb + col], acc[q]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * vb; e += kThreads) {
    const int d = e / vb;
    const int j = e % vb;
    s_t[sbase + static_cast<long long>(d) * dv + j] = st[e];
  }
}

// ----------------------------------------------------------------------- //
// bf16 on the tensor cores
// ----------------------------------------------------------------------- //
using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x2_trans;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::split2;

constexpr int kD = 64;           // key dims (Dk <= 64, zero-padded)
constexpr int kPad = 8;          // bf16 row padding: ldmatrix rows hit distinct banks
constexpr int kMThreads = 128;
constexpr float kSpan = 60.0f;   // largest anchored exponent of the fast path

template <int MT, int VB>
struct MmaSmem {
  bf16 rk[2][2][MT][kD + kPad];  // [buffer][r, k][step][key]
  bf16 v[2][MT][VB + kPad];      // [buffer][step][column]
  float lw[2][MT][kD];           // log-decay, then its inclusive cumsum
  bf16 f[4][MT][kD + kPad];      // the factors A hi, A lo, B hi, B lo [step][key]
  float st[VB][kD + 8];          // the state transposed, S^T [column][key]
  float u[kD];
  float ea[kD];                  // e^{A's anchor}: scales S's rows for the cross product
  float eb[kD];                  // e^{tot - B's anchor}: scales B's state product
  float et[kD];                  // e^{tot}: the state's decay over the chunk
  float halves[2][kD];           // each half chunk's summed log-decay
  float bonus[MT];               // (r_i * u) . k_i
};

// float32 -> bf16 hi + lo, one value (split2 for pairs).
__device__ __forceinline__ void split1(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// One block: one stream and a slice of VB columns of Dv; 4 warps; MT = 32
// (chunk <= 32) or 64 rows per chunk tile, short chunks zero-padded.
//
// Anchored factors.  The pair weight e^{pc_prev_id - pc_jd} depends on the
// key dim d, so the weights are not a product until the decay is split
// between the two sides: with a_d the cumulative log-decay at the end of
// the chunk's first half,
//   A_id = r_id e^{pc_prev_id - a_d},   B_jd = k_jd e^{a_d - pc_jd},
//   att_ij = sum_d A_id B_jd  (j < i),
// and the cross and state products reuse them: cross = A (e^{a} o S),
// S' = e^{tot} o S + e^{tot - a} o (B^T v) (row scales per key dim).
// That is two expf per (i, d) and three per key dim, where the CUDA-core
// kernel takes one per (i, j, d).  Every
// exponent of A and B is bounded by the larger half chunk's span (48 at
// the model's clamp w >= 0.05 with chunk 32); where a half spans more than
// kSpan the block (uniformly) takes the other anchors, A = r e^{pc_prev}
// and B = k e^{tot - pc} (both at most 1), and forms the pair weights by
// the exact per-pair loop.  Pairs j >= i, whose products may overflow on
// the fast path, are discarded by a select, never multiplied.
//
// Per chunk: each thread sums half a column of the log-decay in registers
// (thread = key dim x half: rows are read along the keys, conflict-free),
// one barrier shares the halves and the steep test, then the same thread
// forms its rows' factors and cumulative log-decays; the bonus goes 128 /
// MT threads per row.  The MT / 16 row tiles of 16 rows share the 4 warps
// (two warps per tile, on half the columns each, when MT = 32): a warp
// forms its tile's pair weights (hi x hi + hi x lo + lo x hi), the cross
// product against S^T (float32 in shared memory, split per load), and the
// weights, turned from accumulators into A fragments, times v (bf16,
// exact).  Then every warp updates a column tile of S^T.  The next chunk's
// r / k / v / lw arrive by cp.async in the other buffer meanwhile.
template <int MT, int VB>
__global__ void __launch_bounds__(kMThreads)
rwkv6_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 bf16* __restrict__ out, float* __restrict__ s_t, Strides rs, Strides ks,
                 Strides vs, Strides ws, Strides os, long long u_sb, long long u_sh,
                 int n_heads, int seq, int dk, int dv, int chunk) {
  extern __shared__ __align__(16) uint8_t mma_raw[];
  MmaSmem<MT, VB>& sm = *reinterpret_cast<MmaSmem<MT, VB>*>(mma_raw);
  constexpr int RT = MT / 16;      // row tiles
  constexpr int CG = 4 / RT;       // warps per row tile, each on VB / CG columns of out
  constexpr int HALF = MT / 2;
  constexpr int NT = VB / 8 / CG;  // n8 column tiles of out per warp
  constexpr int PER = VB / 8;      // n8 key tiles of S^T per warp
  constexpr int TPR = kMThreads / MT;  // threads per row of the bonus
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int stream = blockIdx.x;
  const int b = stream / n_heads;
  const int h = stream % n_heads;
  const int v0 = blockIdx.y * VB;
  const bf16* rb = r + b * rs.b + h * rs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h + v0;
  const float* wb = lw + b * ws.b + h * ws.h;
  bf16* ob = out + b * os.b + h * os.h + v0;
  const long long sbase = static_cast<long long>(stream) * dk * dv + v0;

  for (int e = tid; e < VB * kD; e += kMThreads) {
    const int d = e / VB;
    const int c = e % VB;
    sm.st[c][d] = s0 != nullptr && d < dk ? s0[sbase + static_cast<long long>(d) * dv + c] : 0.0f;
  }
  if (tid < kD) sm.u[tid] = tid < dk ? u[b * u_sb + h * u_sh + tid] : 0.0f;

  auto load = [&](int c, int buf) {
    const int c0 = c * chunk;
    const int cl = min(chunk, seq - c0);
    for (int e = tid; e < 2 * MT * (kD / 8); e += kMThreads) {
      const int m = e / (MT * (kD / 8));
      const int i = (e / (kD / 8)) % MT;
      const int col = (e % (kD / 8)) * 8;
      const bool ok = i < cl && col < dk;
      const bf16* src = m == 0 ? rb + (c0 + i) * rs.s + col : kb + (c0 + i) * ks.s + col;
      cp_async16(&sm.rk[buf][m][i][col], ok ? src : rb, ok);
    }
    for (int e = tid; e < MT * (VB / 8); e += kMThreads) {
      const int i = e / (VB / 8);
      const int col = (e % (VB / 8)) * 8;
      const bool ok = i < cl;
      cp_async16(&sm.v[buf][i][col], ok ? vb + (c0 + i) * vs.s + col : vb, ok);
    }
    for (int e = tid; e < MT * (kD / 4); e += kMThreads) {
      const int i = e / (kD / 4);
      const int col = (e % (kD / 4)) * 4;
      const bool ok = i < cl && col < dk;
      cp_async16(&sm.lw[buf][i][col], ok ? wb + (c0 + i) * ws.s + col : wb, ok);
    }
  };

  const int n_chunks = (seq + chunk - 1) / chunk;
  const int rt = warp % RT;                // this warp's row tile and columns of out
  const int col0 = (warp / RT) * 8 * NT;
  const int r0 = 16 * rt + (lane >> 2);    // this thread's rows r0 and r0 + 8
  const int q4 = 2 * (lane & 3);
  const int d = tid % kD;                  // factors: key dim d, rows of half hs
  const int hs = tid / kD;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int c0 = c * chunk;
    const int cl = min(chunk, seq - c0);
    __syncthreads();  // chunk c - 1 is done with the other buffer
    if (c + 1 < n_chunks) load(c + 1, buf ^ 1);  // prefetch under this chunk's products
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // This thread's half column of the log-decay (padded steps hold 0).
    float x[HALF];
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < HALF; ++q) {
      x[q] = sm.lw[buf][hs * HALF + q][d];
      part += x[q];
    }
    sm.halves[hs][d] = part;
    {  // the bonus (r_i * u) . k_i: TPR threads per row, thread p on the key
       // pairs 2 p + 2 TPR m (a warp's loads hit distinct banks)
      const int i = tid / TPR;
      float acc = 0.0f;
#pragma unroll
      for (int dd = 2 * (tid % TPR); dd < kD; dd += 2 * TPR) {
        const float2 rr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sm.rk[buf][0][i][dd]));
        const float2 kk = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sm.rk[buf][1][i][dd]));
        acc = fmaf(rr.x * sm.u[dd], kk.x, acc);
        acc = fmaf(rr.y * sm.u[dd + 1], kk.y, acc);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (tid % TPR == 0) sm.bonus[i] = acc;
    }
    const bool steep = __syncthreads_or(part < -kSpan) != 0;

    // Factors of this thread's rows; the cumulative log-decay stays in lw
    // for the exact branch.  The second half's is h0 + its own prefix, so
    // the last row's equals tot = h0 + h1 exactly (e^{tot - pc} = 1 there).
    {
      const float h0 = sm.halves[0][d];
      const float tot = h0 + sm.halves[1][d];
      const float anchor_a = steep ? 0.0f : h0;
      const float anchor_b = steep ? tot : h0;
      float pre = 0.0f;
      float pc = hs == 0 ? 0.0f : h0;
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        const int i = hs * HALF + q;
        const float prev = pc;
        pre += x[q];
        pc = hs == 0 ? pre : h0 + pre;
        const float av = __bfloat162float(sm.rk[buf][0][i][d]) * expf(prev - anchor_a);
        const float bv = __bfloat162float(sm.rk[buf][1][i][d]) * expf(anchor_b - pc);
        split1(av, sm.f[0][i][d], sm.f[1][i][d]);
        split1(bv, sm.f[2][i][d], sm.f[3][i][d]);
        sm.lw[buf][i][d] = pc;
      }
      if (hs == 0) {
        sm.ea[d] = expf(anchor_a);
        sm.eb[d] = expf(tot - anchor_b);
        sm.et[d] = expf(tot);
      }
    }
    __syncthreads();

    {
      uint32_t ah[4][4], al[4][4];  // A fragments of this warp's rows, all keys
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ldmatrix_x4(ah[q], &sm.f[0][16 * rt + (lane & 15)][16 * q + (lane >> 4) * 8]);
        ldmatrix_x4(al[q], &sm.f[1][16 * rt + (lane & 15)][16 * q + (lane >> 4) * 8]);
      }
      // Pair weights for j <= i (tiles past the diagonal skipped), formed
      // by each of the row tile's CG warps.
      float g[2 * RT][4];
#pragma unroll
      for (int jt = 0; jt < 2 * RT; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[jt][e] = 0.0f;
      if (!steep) {
#pragma unroll
        for (int jt = 0; jt < 2 * RT; jt += 2) {
          if (jt <= 2 * rt) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = 8 * jt + (lane & 7) + ((lane >> 4) << 3);
              const int col = 16 * q + ((lane >> 3) & 1) * 8;
              uint32_t bh[4], bl[4];
              ldmatrix_x4(bh, &sm.f[2][row][col]);
              ldmatrix_x4(bl, &sm.f[3][row][col]);
              mma_bf16(g[jt], ah[q], bh[0], bh[1]);
              mma_bf16(g[jt], ah[q], bl[0], bl[1]);
              mma_bf16(g[jt], al[q], bh[0], bh[1]);
              mma_bf16(g[jt + 1], ah[q], bh[2], bh[3]);
              mma_bf16(g[jt + 1], ah[q], bl[2], bl[3]);
              mma_bf16(g[jt + 1], al[q], bh[2], bh[3]);
            }
          }
        }
      } else {  // the exact per-pair loop: one expf per (i, j, d)
        const float(*pc)[kD] = sm.lw[buf];
#pragma unroll
        for (int jt = 0; jt < 2 * RT; ++jt) {
          if (jt <= 2 * rt + 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = r0 + 8 * (e >> 1);
              const int j = 8 * jt + q4 + (e & 1);
              if (j < i) {  // padded rows hold r = k = 0
                const bf16* ri = sm.rk[buf][0][i];
                const bf16* kj = sm.rk[buf][1][j];
                float acc = 0.0f;
                for (int dd = 0; dd < kD; ++dd) {
                  const int dx = (dd + lane) & (kD - 1);  // lanes on distinct banks
                  acc = fmaf(__bfloat162float(ri[dx]) * __bfloat162float(kj[dx]),
                             expf(pc[i - 1][dx] - pc[j][dx]), acc);
                }
                g[jt][e] = acc;
              }
            }
          }
        }
      }

      float yacc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.0f;
      // The cross product A (e^{a} o S): S^T's keys scaled, split hi + lo.
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = 16 * q + q4;
        const float e0 = sm.ea[kk], e1 = sm.ea[kk + 1], e8 = sm.ea[kk + 8], e9 = sm.ea[kk + 9];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* sp = &sm.st[col0 + 8 * nt + (lane >> 2)][kk];
          const float2 s01 = *reinterpret_cast<const float2*>(sp);
          const float2 s89 = *reinterpret_cast<const float2*>(sp + 8);
          uint32_t h0r, l0r, h1r, l1r;
          split2(s01.x * e0, s01.y * e1, h0r, l0r);
          split2(s89.x * e8, s89.y * e9, h1r, l1r);
          mma_bf16(yacc[nt], ah[q], h0r, h1r);
          mma_bf16(yacc[nt], ah[q], l0r, l1r);
          mma_bf16(yacc[nt], al[q], h0r, h1r);
        }
      }
      // + sum_{j <= i} att_ij v_j: the weights (strictly lower, the bonus
      // on the diagonal) go from the accumulators into A fragments.
      const float bonus0 = sm.bonus[r0];
      const float bonus1 = sm.bonus[r0 + 8];
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        if (q <= rt) {
          float w[2][4];
#pragma unroll
          for (int uu = 0; uu < 2; ++uu) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 16 * q + 8 * uu + q4 + e;
              w[uu][e] = j < r0 ? g[2 * q + uu][e] : (j == r0 ? bonus0 : 0.0f);
              w[uu][2 + e] = j < r0 + 8 ? g[2 * q + uu][2 + e] : (j == r0 + 8 ? bonus1 : 0.0f);
            }
          }
          uint32_t wh[4], wl[4];
          split2(w[0][0], w[0][1], wh[0], wl[0]);
          split2(w[0][2], w[0][3], wh[1], wl[1]);
          split2(w[1][0], w[1][1], wh[2], wl[2]);
          split2(w[1][2], w[1][3], wh[3], wl[3]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t vb4[4];
            ldmatrix_x4_trans(vb4, &sm.v[buf][16 * q + (lane & 15)]
                                        [col0 + 16 * np + (lane >> 4) * 8]);
            mma_bf16(yacc[2 * np], wh, vb4[0], vb4[1]);
            mma_bf16(yacc[2 * np], wl, vb4[0], vb4[1]);
            mma_bf16(yacc[2 * np + 1], wh, vb4[2], vb4[3]);
            mma_bf16(yacc[2 * np + 1], wl, vb4[2], vb4[3]);
          }
          if (NT % 2) {  // an odd last tile (8 columns per warp)
            uint32_t vb2[2];
            ldmatrix_x2_trans(vb2, &sm.v[buf][16 * q + (lane & 15)][col0 + 8 * (NT - 1)]);
            mma_bf16(yacc[NT - 1], wh, vb2[0], vb2[1]);
            mma_bf16(yacc[NT - 1], wl, vb2[0], vb2[1]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + 8 * nt + q4;
        if (r0 < cl)
          *reinterpret_cast<__nv_bfloat162*>(ob + (c0 + r0) * os.s + col) =
              __floats2bfloat162_rn(yacc[nt][0], yacc[nt][1]);
        if (r0 + 8 < cl)
          *reinterpret_cast<__nv_bfloat162*>(ob + (c0 + r0 + 8) * os.s + col) =
              __floats2bfloat162_rn(yacc[nt][2], yacc[nt][3]);
      }
    }
    __syncthreads();  // every warp has read the state

    // S^T <- e^{tot} o S^T + e^{tot - a} o (v^T B): this warp's column tile
    // vt and key tiles dt0 .. dt0 + PER; v enters as it is, B hi + lo.
    {
      const int vt = warp * PER / 8;
      const int dt0 = (warp * PER) % 8;
      float sacc[PER][4];
#pragma unroll
      for (int t = 0; t < PER; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[t][e] = 0.0f;
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        uint32_t va[4];
        ldmatrix_x4_trans(va, &sm.v[buf][16 * q + (lane & 7) + ((lane >> 4) << 3)]
                                       [16 * vt + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int tp = 0; tp < PER / 2; ++tp) {
          const int row = 16 * q + (lane & 15);
          const int col = 8 * (dt0 + 2 * tp) + (lane >> 4) * 8;
          uint32_t bh4[4], bl4[4];
          ldmatrix_x4_trans(bh4, &sm.f[2][row][col]);
          ldmatrix_x4_trans(bl4, &sm.f[3][row][col]);
          mma_bf16(sacc[2 * tp], va, bh4[0], bh4[1]);
          mma_bf16(sacc[2 * tp], va, bl4[0], bl4[1]);
          mma_bf16(sacc[2 * tp + 1], va, bh4[2], bh4[3]);
          mma_bf16(sacc[2 * tp + 1], va, bl4[2], bl4[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < PER; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = 16 * vt + (lane >> 2) + 8 * (e >> 1);
          const int kk = 8 * (dt0 + t) + q4 + (e & 1);
          sm.st[cc][kk] = fmaf(sm.et[kk], sm.st[cc][kk], sm.eb[kk] * sacc[t][e]);
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < VB * kD; e += kMThreads) {
    const int dd = e / VB;
    const int c = e % VB;
    if (dd < dk) s_t[sbase + static_cast<long long>(dd) * dv + c] = sm.st[c][dd];
  }
}

template <int MT, int VB>
cudaError_t launch_mma(const void* r, const void* k, const void* v, const float* lw,
                       const float* u, const float* s0, void* out, float* s_t, const Strides* st,
                       long long u_sb, long long u_sh, int b, int h, int seq, int dk, int dv,
                       int chunk, int device, cudaStream_t s) {
  static bool ready[16] = {};
  auto kern = rwkv6_mma_kernel<MT, VB>;
  const int smem = static_cast<int>(sizeof(MmaSmem<MT, VB>));
  const cudaError_t err = repro::allow_smem(kern, smem, device, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, dv / VB);
  kern<<<grid, kMThreads, smem, s>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v), lw,
      u, s0, static_cast<bf16*>(out), s_t, st[0], st[1], st[2], st[3], st[4], u_sb, u_sh, h,
      seq, dk, dv, chunk);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_r(const void* r, const void* k, const void* v, const float* lw,
                     const float* u, const float* s0, void* out, float* s_t, const Strides* st,
                     long long u_sb, long long u_sh, int b, int h, int seq, int dk, int dv,
                     int chunk, int vb, cudaStream_t s) {
  const long long smem = smem_floats(chunk, dk, vb) * static_cast<long long>(sizeof(float));
  auto kern = rwkv6_scan_kernel<T, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(b * h, dv / vb);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), lw, u, s0,
      static_cast<T*>(out), s_t, st[0], st[1], st[2], st[3], st[4], u_sb, u_sh, h, seq, dk, dv,
      chunk, vb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* lw,
                   const float* u, const float* s0, void* out, float* s_t, const Strides* st,
                   long long u_sb, long long u_sh, int b, int h, int seq, int dk, int dv,
                   int chunk, int vb, cudaStream_t s) {
  const int ng = kThreads / vb;
  const int need = ((chunk > dk ? chunk : dk) + ng - 1) / ng;
#define REPRO_RWKV6_LAUNCH(RR)                                                             \
  return launch_r<T, RR>(r, k, v, lw, u, s0, out, s_t, st, u_sb, u_sh, b, h, seq, dk, dv, \
                         chunk, vb, s)
  if (need <= 1) REPRO_RWKV6_LAUNCH(1);
  if (need <= 2) REPRO_RWKV6_LAUNCH(2);
  if (need <= 4) REPRO_RWKV6_LAUNCH(4);
  if (need <= 8) REPRO_RWKV6_LAUNCH(8);
  if (need <= 16) REPRO_RWKV6_LAUNCH(16);
#undef REPRO_RWKV6_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Strides in elements (batch, head, sequence) of r, k, v, lw and out, then
// u's (batch, head).  `mma` != 0: the bf16 tensor-core kernel, `vb` (16, 32
// or 64) columns per block, for 16-byte aligned rows, Dk a multiple of 8
// and Dv of `vb`.  `mma` == 0: the CUDA-core kernel, `vb` columns per block
// (a power of two <= 64 dividing Dv).  1 <= chunk <= 64; Dk <= 64.  The
// wrapper checks the shapes.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v, const float* lw,
                                const float* u, const float* s0, void* out, float* s_t,
                                long long r_sb, long long r_sh, long long r_ss, long long k_sb,
                                long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                long long v_ss, long long w_sb, long long w_sh, long long w_ss,
                                long long o_sb, long long o_sh, long long o_ss, long long u_sb,
                                long long u_sh, int b, int h, int seq, int dk, int dv,
                                int chunk, int vb, int mma, int is_bf16, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || h == 0 || seq == 0) return 0;
  if (chunk < 1 || chunk > 64 || dk < 1 || dk > 64 || vb < 1 || vb > 64 ||
      kThreads % vb != 0 || dv % vb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[5] = {{r_sb, r_sh, r_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
                         {w_sb, w_sh, w_ss}, {o_sb, o_sh, o_ss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!is_bf16 || dk % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_RWKV6_MMA(MT, VB)                                                                \
  launch_mma<MT, VB>(r, k, v, lw, u, s0, out, s_t, st, u_sb, u_sh, b, h, seq, dk, dv, chunk, \
                     device, s)
    const bool small = chunk <= 32;
    if (vb == 64) err = small ? REPRO_RWKV6_MMA(32, 64) : REPRO_RWKV6_MMA(64, 64);
    else if (vb == 32) err = small ? REPRO_RWKV6_MMA(32, 32) : REPRO_RWKV6_MMA(64, 32);
    else if (vb == 16) err = small ? REPRO_RWKV6_MMA(32, 16) : REPRO_RWKV6_MMA(64, 16);
    else err = cudaErrorInvalidValue;
#undef REPRO_RWKV6_MMA
    return static_cast<int>(err);
  }
  err = is_bf16 ? launch<__nv_bfloat16>(r, k, v, lw, u, s0, out, s_t, st, u_sb, u_sh, b, h, seq,
                                        dk, dv, chunk, vb, s)
                : launch<float>(r, k, v, lw, u, s0, out, s_t, st, u_sb, u_sh, b, h, seq, dk, dv,
                                chunk, vb, s);
  return static_cast<int>(err);
}
