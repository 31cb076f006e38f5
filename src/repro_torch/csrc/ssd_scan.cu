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

// Strides in elements (batch, head, sequence) of x, a, b, c and y.  `vb`
// columns per block: a power of two <= 64 that divides Dh; 1 <= chunk <=
// 64; Dst <= 64.  The wrapper checks the shapes.
extern "C" int repro_ssd_scan(const void* x, const float* a, const void* b, const void* c,
                              const float* s0, void* y, float* s_t, long long x_sb,
                              long long x_sh, long long x_ss, long long a_sb, long long a_sh,
                              long long a_ss, long long b_sb, long long b_sh, long long b_ss,
                              long long c_sb, long long c_sh, long long c_ss, long long y_sb,
                              long long y_sh, long long y_ss, int nb, int nh, int seq, int dh,
                              int dst, int chunk, int vb, int is_bf16, int device,
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
  err = is_bf16 ? launch<__nv_bfloat16>(x, a, b, c, s0, y, s_t, st, nb, nh, seq, dh, dst, chunk,
                                        vb, s)
                : launch<float>(x, a, b, c, s0, y, s_t, st, nb, nh, seq, dh, dst, chunk, vb, s);
  return static_cast<int>(err);
}
