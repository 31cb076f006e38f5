// Mamba2 SSD chunked scan, bf16 or float32 operands, float32 arithmetic and
// state.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/kernel.py:
// `ssd_scan_pallas` (body `_kernel`).  Same function: per chunk of C steps,
// with pc the inclusive cumulative log-decay (one scalar per step and
// stream) and tot its last value,
//   y_i = (C_i e^{pc_i}) S + sum_{j<=i} e^{pc_i - pc_j} (C_i . B_j) x_j
//   S'  = e^{tot} S + sum_j (B_j e^{tot - pc_j})^T x_j.
// The TPU kernel forms the intra-chunk weight as (C e^{pc}) . (B e^{-pc}),
// which overflows float32 once a chunk's decay passes e^-88 (zamba2 clamps
// log a at -6 per step: 64 steps reach -384, and the JAX package's own
// init passes -88 within one chunk).  Here the weight is the segment sum
// e^{pc_i - pc_j} for j <= i (at most 1), and the cross and state terms use
// e^{pc} and e^{tot - pc} (at most 1): finite for any log-decay <= 0.
//
// Layout: x / y [B, H, S, Dh], a [B, H, S] (float32), b / c [B, H, S, Dst]
// as strided views (batch, head and sequence strides in elements, unit
// last stride for x, b, c, y), so the model's [B, S, H, Dh] input and its
// B / C shared by all heads (head stride 0: read in place, never
// expanded) go in without a copy; the states s0 / s_T [B * H, Dst, Dh]
// contiguous float32 (s0 may be null: zeros).
//
// Bound on the H100: at the zamba2-7b prefill (B = 4, S = 4096, 112 heads,
// Dh = Dst = 64, chunk 64) a layer does ~45 GFLOP of float32 work (the
// causal C . B and weight . x products, the cross and state products) on
// ~0.48 GB of operands: the float32 rate bounds it (~0.68 ms at 67
// TFLOP/s).  Design, simple first: one 256-thread block per (stream, slice
// of Dh columns); zamba2's 448 streams fill the card with whole 64-column
// slices (the launcher narrows slices only for small batches).  The Dst x
// slice state stays in shared memory for the whole sequence (the TPU
// kernel's VMEM carry becomes the block's chunk loop).  Each chunk stages
// B and C as float32 rows padded to Dst + 1, scans the log-decay with one
// warp's shuffles, forms the C x C causal weights, then each thread keeps
// an R-row register tile of one column for the output and state products.
// CUDA cores with explicit fmaf; mma.sync / wgmma tiles and cp.async
// staging are later work.
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

// Shared floats: b, c [C][Dst + 1]; x [C][VB]; pc [C]; att [C][C + 1]; the
// state slice [Dst][VB].
long long smem_floats(int chunk, int dst, int vb) {
  return 2LL * chunk * (dst + 1) + 1LL * chunk * vb + chunk + 1LL * chunk * (chunk + 1) +
         1LL * dst * vb;
}

// R: rows of the register tile per thread, >= ceil(max(C, Dst) / (256 / VB)).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ s0, T* __restrict__ y,
                float* __restrict__ s_t, Strides xs, Strides as, Strides bs, Strides cs,
                Strides ys, int n_heads, int seq, int dh, int dst, int chunk, int vb) {
  extern __shared__ float smem[];
  const int kp = dst + 1;
  const int ap = chunk + 1;
  float* b_s = smem;               // B, then B * e^{tot - pc}
  float* c_s = b_s + chunk * kp;   // C, then C * e^{pc}
  float* x_s = c_s + chunk * kp;   // this block's x columns
  float* pc_s = x_s + chunk * vb;  // a, then its inclusive cumsum
  float* att = pc_s + chunk;       // causal weights
  float* st = att + chunk * ap;    // state slice [Dst][VB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int stream = blockIdx.x;
  const int b = stream / n_heads;
  const int h = stream % n_heads;
  const int v0 = blockIdx.y * vb;
  const int col = tid % vb;  // register tile: one column, rows grp + ng * q
  const int grp = tid / vb;
  const int ng = kThreads / vb;

  const T* xb = x + b * xs.b + h * xs.h + v0;
  const float* ab = a + b * as.b + h * as.h;
  const T* bb = bm + b * bs.b + h * bs.h;
  const T* cb = cm + b * cs.b + h * cs.h;
  T* yb = y + b * ys.b + h * ys.h + v0;
  const long long sbase = static_cast<long long>(stream) * dst * dh + v0;

  for (int e = tid; e < dst * vb; e += kThreads) {
    const int d = e / vb;
    const int j = e % vb;
    st[e] = s0 != nullptr ? s0[sbase + static_cast<long long>(d) * dh + j] : 0.0f;
  }

  for (int c0 = 0; c0 < seq; c0 += chunk) {
    const int cl = min(chunk, seq - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < cl * dst; e += kThreads) {
      const int i = e / dst;
      const int d = e % dst;
      const long long t = c0 + i;
      b_s[i * kp + d] = to_f32(bb[t * bs.s + d]);
      c_s[i * kp + d] = to_f32(cb[t * cs.s + d]);
    }
    for (int e = tid; e < cl * vb; e += kThreads) {
      const int i = e / vb;
      const int j = e % vb;
      x_s[i * vb + j] = to_f32(xb[(c0 + i) * xs.s + j]);
    }
    if (tid < 32) {  // inclusive cumsum of the log-decay: one warp's shuffles
      float carry = 0.0f;
      for (int i0 = 0; i0 < cl; i0 += 32) {
        const int i = i0 + lane;
        float v = i < cl ? ab[(c0 + i) * as.s] : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(kFull, v, off);
          if (lane >= off) v += up;
        }
        v += carry;
        if (i < cl) pc_s[i] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
    }
    __syncthreads();

    // Causal weights: e^{pc_i - pc_j} (C_i . B_j) for j <= i, 0 above.
    for (int e = tid; e < cl * cl; e += kThreads) {
      const int i = e / cl;
      const int j = e % cl;
      float acc = 0.0f;
      if (j <= i) {
        const float* ci = c_s + i * kp;
        const float* bj = b_s + j * kp;
        for (int d = 0; d < dst; ++d) acc = fmaf(ci[d], bj[d], acc);
        acc *= expf(pc_s[i] - pc_s[j]);
      }
      att[i * ap + j] = acc;
    }
    __syncthreads();

    // C <- C e^{pc}, B <- B e^{tot - pc} (both factors at most 1).
    const float tot = pc_s[cl - 1];
    for (int e = tid; e < cl * dst; e += kThreads) {
      const int i = e / dst;
      const int d = e % dst;
      c_s[i * kp + d] *= expf(pc_s[i]);
      b_s[i * kp + d] *= expf(tot - pc_s[i]);
    }
    __syncthreads();

    // Outputs: y_i = C_dec_i S + sum_{j<=i} att_ij x_j, R rows per thread.
    {
      float acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = 0.0f;
      for (int d = 0; d < dst; ++d) {
        const float sv = st[d * vb + col];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = grp + ng * q;
          if (i < cl) acc[q] = fmaf(c_s[i * kp + d], sv, acc[q]);
        }
      }
      for (int j = 0; j < cl; ++j) {
        const float xv = x_s[j * vb + col];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = grp + ng * q;
          if (i < cl && j <= i) acc[q] = fmaf(att[i * ap + j], xv, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = grp + ng * q;
        if (i < cl) store(yb + (c0 + i) * ys.s + col, acc[q]);
      }
    }
    __syncthreads();  // the outputs read the state before its update

    // State: S_dc <- e^{tot} S_dc + sum_j B_dec_jd x_jc, R state rows per thread.
    {
      const float decay = expf(tot);
      float acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = 0.0f;
      for (int j = 0; j < cl; ++j) {
        const float xv = x_s[j * vb + col];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int d = grp + ng * q;
          if (d < dst) acc[q] = fmaf(b_s[j * kp + d], xv, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int d = grp + ng * q;
        if (d < dst) st[d * vb + col] = fmaf(decay, st[d * vb + col], acc[q]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < dst * vb; e += kThreads) {
    const int d = e / vb;
    const int j = e % vb;
    s_t[sbase + static_cast<long long>(d) * dh + j] = st[e];
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
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::smem_u32;

constexpr int kMT = 64;  // steps of a chunk tile (chunk <= 64; short chunks zero-padded)
constexpr int kMD = 64;  // state rows (Dst <= 64, zero-padded)
constexpr int kMPad = 8;  // bf16 row padding: ldmatrix rows hit distinct banks
constexpr int kMThreads = 128;

// 4-byte asynchronous copy (the log-decay's strided scalars); `ok ==
// false` zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

// A float32 pair as bf16 hi + lo (hi + lo equals the pair to ~2^-17).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int VB, int HG>
struct MmaSmem {
  bf16 bc[2][2][kMT][kMD + kMPad];  // [buffer][B, C][step][state]
  bf16 x[2][HG][kMT][VB + kMPad];   // [buffer][head][step][column]
  float a[2][HG][kMT];              // log-decay, then its inclusive cumsum
  float st[HG][VB][kMD + 8];        // the state transposed, S^T [column][state]
};

// One block: HG heads of one batch row (sharing B and C when HG > 1) and a
// slice of VB columns of Dh; 4 warps.  Per chunk, warp w owns the steps
// i in [16 w, 16 w + 16) for G = C B^T (formed once, for every head of
// the block), the causal weights and y, and columns of S^T for the state
// update.  bf16 operands x, B, C enter the mma tiles as they are; the
// float32 operands (weights, state, decayed x) as bf16 hi + lo pairs.
template <int VB, int HG>
__global__ void __launch_bounds__(kMThreads)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
               const bf16* __restrict__ bm, const bf16* __restrict__ cm,
               const float* __restrict__ s0, bf16* __restrict__ y, float* __restrict__ s_t,
               Strides xs, Strides as, Strides bs, Strides cs, Strides ys, int n_heads, int seq,
               int dh, int dst, int chunk) {
  extern __shared__ __align__(16) uint8_t mma_raw[];
  MmaSmem<VB, HG>& sm = *reinterpret_cast<MmaSmem<VB, HG>*>(mma_raw);
  constexpr int NT = VB / 8;   // n8 column tiles of y per warp
  constexpr int PER = VB / 8;  // n8 state tiles of S^T per warp
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int v0 = blockIdx.y * VB;
  const int stream0 = blockIdx.x * HG;
  const int b = stream0 / n_heads;
  const int h0 = stream0 % n_heads;
  const bf16* bb = bm + b * bs.b + h0 * bs.h;
  const bf16* cb = cm + b * cs.b + h0 * cs.h;

  for (int e = tid; e < HG * VB * kMD; e += kMThreads) {
    const int hh = e / (VB * kMD);
    const int d = (e / VB) % kMD;
    const int v = e % VB;
    const long long idx = (static_cast<long long>(stream0 + hh) * dst + d) * dh + v0 + v;
    sm.st[hh][v][d] = s0 != nullptr && d < dst ? s0[idx] : 0.0f;
  }

  auto load = [&](int c, int buf) {
    const int c0 = c * chunk;
    const int cl = min(chunk, seq - c0);
    for (int e = tid; e < 2 * kMT * (kMD / 8); e += kMThreads) {
      const int m = e / (kMT * (kMD / 8));
      const int r = (e / (kMD / 8)) % kMT;
      const int col = (e % (kMD / 8)) * 8;
      const bool ok = r < cl && col < dst;
      const bf16* src = m == 0 ? bb + (c0 + r) * bs.s + col : cb + (c0 + r) * cs.s + col;
      cp_async16(&sm.bc[buf][m][r][col], ok ? src : bb, ok);
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const bf16* xb = x + b * xs.b + (h0 + hh) * xs.h + v0;
      for (int e = tid; e < kMT * (VB / 8); e += kMThreads) {
        const int r = e / (VB / 8);
        const int col = (e % (VB / 8)) * 8;
        const bool ok = r < cl;
        cp_async16(&sm.x[buf][hh][r][col], ok ? xb + (c0 + r) * xs.s + col : xb, ok);
      }
    }
    for (int e = tid; e < HG * kMT; e += kMThreads) {
      const int hh = e / kMT;
      const int r = e % kMT;
      const float* ab = a + b * as.b + (h0 + hh) * as.h;
      const bool ok = r < cl;
      cp_async4(&sm.a[buf][hh][r], ok ? ab + (c0 + r) * as.s : ab, ok);
    }
  };

  const int n_chunks = (seq + chunk - 1) / chunk;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's steps r0 and r0 + 8
  const int q4 = 2 * (lane & 3);
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
    if (warp < HG) {  // inclusive cumsum of the log-decay (padded steps hold 0)
      float* ap = sm.a[buf][warp];
      float lo = ap[lane];
      float hi = ap[lane + 32];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ul = __shfl_up_sync(kFull, lo, off);
        const float uh = __shfl_up_sync(kFull, hi, off);
        if (lane >= off) {
          lo += ul;
          hi += uh;
        }
      }
      hi += __shfl_sync(kFull, lo, 31);
      ap[lane] = lo;
      ap[lane + 32] = hi;
    }
    __syncthreads();

    // G = C B^T for this warp's steps, j <= i only (tiles past the diagonal skipped).
    uint32_t cf[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ldmatrix_x4(cf[q], &sm.bc[buf][1][16 * warp + (lane & 15)][16 * q + (lane >> 4) * 8]);
    float g[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int i = 0; i < 4; ++i) g[jt][i] = 0.0f;
#pragma unroll
    for (int jt = 0; jt < 8; jt += 2) {
      if (jt <= 2 * warp) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t bf[4];
          ldmatrix_x4(bf, &sm.bc[buf][0][8 * jt + (lane & 7) + ((lane >> 4) << 3)]
                                      [16 * q + ((lane >> 3) & 1) * 8]);
          mma_bf16(g[jt], cf[q], bf[0], bf[1]);
          mma_bf16(g[jt + 1], cf[q], bf[2], bf[3]);
        }
      }
    }

#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float* pc = sm.a[buf][hh];
      const float pc0 = pc[r0];
      const float pc1 = pc[r0 + 8];
      float yacc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) yacc[nt][i] = 0.0f;
      // (C S)_i, the state as it entered the chunk, then the factor e^{pc_i}.
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* sp = &sm.st[hh][8 * nt + (lane >> 2)][16 * q + q4];
          const float2 s01 = *reinterpret_cast<const float2*>(sp);
          const float2 s89 = *reinterpret_cast<const float2*>(sp + 8);
          uint32_t h0r, l0r, h1r, l1r;
          split2(s01.x, s01.y, h0r, l0r);
          split2(s89.x, s89.y, h1r, l1r);
          mma_bf16(yacc[nt], cf[q], h0r, h1r);
          mma_bf16(yacc[nt], cf[q], l0r, l1r);
        }
      }
      const float e0 = expf(pc0);
      const float e1 = expf(pc1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        yacc[nt][0] *= e0;
        yacc[nt][1] *= e0;
        yacc[nt][2] *= e1;
        yacc[nt][3] *= e1;
      }
      // + sum_{j <= i} e^{pc_i - pc_j} G_ij x_j: the weights go from G's
      // accumulators straight into A fragments (hi + lo).
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q <= warp) {
          float w[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 16 * q + 8 * u + q4 + e;
              const float pj = pc[j];
              w[u][e] = j <= r0 ? g[2 * q + u][e] * expf(pc0 - pj) : 0.0f;
              w[u][2 + e] = j <= r0 + 8 ? g[2 * q + u][2 + e] * expf(pc1 - pj) : 0.0f;
            }
          }
          uint32_t ah[4], al[4];
          split2(w[0][0], w[0][1], ah[0], al[0]);
          split2(w[0][2], w[0][3], ah[1], al[1]);
          split2(w[1][0], w[1][1], ah[2], al[2]);
          split2(w[1][2], w[1][3], ah[3], al[3]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t xb4[4];
            ldmatrix_x4_trans(xb4, &sm.x[buf][hh][16 * q + (lane & 15)][16 * np + (lane >> 4) * 8]);
            mma_bf16(yacc[2 * np], ah, xb4[0], xb4[1]);
            mma_bf16(yacc[2 * np], al, xb4[0], xb4[1]);
            mma_bf16(yacc[2 * np + 1], ah, xb4[2], xb4[3]);
            mma_bf16(yacc[2 * np + 1], al, xb4[2], xb4[3]);
          }
        }
      }
      bf16* yb = y + b * ys.b + (h0 + hh) * ys.h + v0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + q4;
        if (r0 < cl)
          *reinterpret_cast<__nv_bfloat162*>(yb + (c0 + r0) * ys.s + col) =
              __floats2bfloat162_rn(yacc[nt][0], yacc[nt][1]);
        if (r0 + 8 < cl)
          *reinterpret_cast<__nv_bfloat162*>(yb + (c0 + r0 + 8) * ys.s + col) =
              __floats2bfloat162_rn(yacc[nt][2], yacc[nt][3]);
      }
      __syncthreads();  // every warp has read this head's state

      // S^T <- e^{tot} S^T + sum_j (x_j e^{tot - pc_j})^T B_j: this warp's
      // column tile vt and state tiles dt0 .. dt0 + PER.
      const int vt = warp * PER / 8;
      const int dt0 = (warp * PER) % 8;
      const float tot = pc[kMT - 1];  // padded steps add 0
      const float dec = expf(tot);
      float sacc[PER][4];
#pragma unroll
      for (int t = 0; t < PER; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[t][e] = dec * sm.st[hh][16 * vt + (lane >> 2) + 8 * (e >> 1)]
                                  [8 * (dt0 + t) + q4 + (e & 1)];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t xa[4];
        ldmatrix_x4_trans(xa, &sm.x[buf][hh][16 * q + (lane & 7) + ((lane >> 4) << 3)]
                                          [16 * vt + ((lane >> 3) & 1) * 8]);
        float f[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) f[u][e] = expf(tot - pc[16 * q + 8 * u + q4 + e]);
        uint32_t xh[4], xl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&xa[r]);
          const int u = r >> 1;  // a0, a1: steps 16 q + q4 + e; a2, a3: 8 more
          split2(__low2float(p) * f[u][0], __high2float(p) * f[u][1], xh[r], xl[r]);
        }
#pragma unroll
        for (int tp = 0; tp < PER / 2; ++tp) {
          uint32_t bb4[4];
          ldmatrix_x4_trans(bb4, &sm.bc[buf][0][16 * q + (lane & 15)]
                                            [8 * (dt0 + 2 * tp) + (lane >> 4) * 8]);
          mma_bf16(sacc[2 * tp], xh, bb4[0], bb4[1]);
          mma_bf16(sacc[2 * tp], xl, bb4[0], bb4[1]);
          mma_bf16(sacc[2 * tp + 1], xh, bb4[2], bb4[3]);
          mma_bf16(sacc[2 * tp + 1], xl, bb4[2], bb4[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < PER; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.st[hh][16 * vt + (lane >> 2) + 8 * (e >> 1)][8 * (dt0 + t) + q4 + (e & 1)] =
              sacc[t][e];
    }
  }
  __syncthreads();
  for (int e = tid; e < HG * VB * kMD; e += kMThreads) {
    const int hh = e / (VB * kMD);
    const int d = (e / VB) % kMD;
    const int v = e % VB;
    if (d < dst)
      s_t[(static_cast<long long>(stream0 + hh) * dst + d) * dh + v0 + v] = sm.st[hh][v][d];
  }
}

template <int VB, int HG>
cudaError_t launch_mma(const void* x, const float* a, const void* b, const void* c,
                       const float* s0, void* y, float* s_t, const Strides* st, int nb, int nh,
                       int seq, int dh, int dst, int chunk, int device, cudaStream_t s) {
  static bool ready[16] = {};
  auto kern = ssd_mma_kernel<VB, HG>;
  const int smem = static_cast<int>(sizeof(MmaSmem<VB, HG>));
  const cudaError_t err = repro::allow_smem(kern, smem, device, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(nb * nh / HG, dh / VB);
  kern<<<grid, kMThreads, smem, s>>>(
      static_cast<const bf16*>(x), a, static_cast<const bf16*>(b), static_cast<const bf16*>(c),
      s0, static_cast<bf16*>(y), s_t, st[0], st[1], st[2], st[3], st[4], nh, seq, dh, dst, chunk);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_r(const void* x, const float* a, const void* b, const void* c,
                     const float* s0, void* y, float* s_t, const Strides* st, int nb, int nh,
                     int seq, int dh, int dst, int chunk, int vb, cudaStream_t s) {
  const long long smem = smem_floats(chunk, dst, vb) * static_cast<long long>(sizeof(float));
  auto kern = ssd_scan_kernel<T, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nb * nh, dh / vb);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b), static_cast<const T*>(c), s0,
      static_cast<T*>(y), s_t, st[0], st[1], st[2], st[3], st[4], nh, seq, dh, dst, chunk, vb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* a, const void* b, const void* c,
                   const float* s0, void* y, float* s_t, const Strides* st, int nb, int nh,
                   int seq, int dh, int dst, int chunk, int vb, cudaStream_t s) {
  const int ng = kThreads / vb;
  const int need = ((chunk > dst ? chunk : dst) + ng - 1) / ng;
#define REPRO_SSD_LAUNCH(RR) \
  return launch_r<T, RR>(x, a, b, c, s0, y, s_t, st, nb, nh, seq, dh, dst, chunk, vb, s)
  if (need <= 1) REPRO_SSD_LAUNCH(1);
  if (need <= 2) REPRO_SSD_LAUNCH(2);
  if (need <= 4) REPRO_SSD_LAUNCH(4);
  if (need <= 8) REPRO_SSD_LAUNCH(8);
  if (need <= 16) REPRO_SSD_LAUNCH(16);
#undef REPRO_SSD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Strides in elements (batch, head, sequence) of x, a, b, c and y.
// `heads` > 0: the bf16 tensor-core kernel, `heads` (1 or 2; 2 only for
// B / C with head stride 0) heads per block and `vb` (16, 32 or 64)
// columns, for 16-byte aligned rows, Dst a multiple of 8 and Dh of `vb`.
// `heads` == 0: the CUDA-core kernel, `vb` columns per block (a power of
// two <= 64 dividing Dh).  1 <= chunk <= 64; Dst <= 64.  The wrapper
// checks the shapes.
extern "C" int repro_ssd_scan(const void* x, const float* a, const void* b, const void* c,
                              const float* s0, void* y, float* s_t, long long x_sb,
                              long long x_sh, long long x_ss, long long a_sb, long long a_sh,
                              long long a_ss, long long b_sb, long long b_sh, long long b_ss,
                              long long c_sb, long long c_sh, long long c_ss, long long y_sb,
                              long long y_sh, long long y_ss, int nb, int nh, int seq, int dh,
                              int dst, int chunk, int vb, int heads, int is_bf16, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 0 || nh == 0 || seq == 0) return 0;
  if (chunk < 1 || chunk > 64 || dst < 1 || dst > 64 || vb < 1 || vb > 64 ||
      kThreads % vb != 0 || dh % vb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[5] = {{x_sb, x_sh, x_ss}, {a_sb, a_sh, a_ss}, {b_sb, b_sh, b_ss},
                         {c_sb, c_sh, c_ss}, {y_sb, y_sh, y_ss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads > 0) {
    if (!is_bf16 || dst % 8 != 0 || nh % heads != 0)
      return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SSD_MMA(VB, HG) \
  launch_mma<VB, HG>(x, a, b, c, s0, y, s_t, st, nb, nh, seq, dh, dst, chunk, device, s)
    if (heads == 2 && vb == 64) err = REPRO_SSD_MMA(64, 2);
    else if (heads == 1 && vb == 64) err = REPRO_SSD_MMA(64, 1);
    else if (heads == 1 && vb == 32) err = REPRO_SSD_MMA(32, 1);
    else if (heads == 1 && vb == 16) err = REPRO_SSD_MMA(16, 1);
    else err = cudaErrorInvalidValue;
#undef REPRO_SSD_MMA
    return static_cast<int>(err);
  }
  err = is_bf16 ? launch<__nv_bfloat16>(x, a, b, c, s0, y, s_t, st, nb, nh, seq, dh, dst, chunk,
                                        vb, s)
                : launch<float>(x, a, b, c, s0, y, s_t, st, nb, nh, seq, dh, dst, chunk, vb, s);
  return static_cast<int>(err);
}
