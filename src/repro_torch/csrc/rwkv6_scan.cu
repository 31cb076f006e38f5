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
// floor w = 0.05 reaches e^-96 over 32 tokens).  Here every exponent is
// pc_prev_i - pc_j over the pairs j < i only (at most 0), and the cross and
// state terms use e^{pc_prev} and e^{tot - pc} (at most 1): finite for any
// log-decay <= 0.
//
// Layout: r / k / lw [B, H, S, Dk], v / out [B, H, S, Dv] as strided views
// (batch, head and sequence strides in elements, unit last stride), so the
// model's [B, S, H, D] projections go in and come out without a copy; u
// [B, H, Dk] (strided, float32), the states s0 / s_T [B * H, Dk, Dv]
// contiguous float32 (s0 may be null: zeros).  lw is float32.
//
// Bound on the H100: at the rwkv6-1.6b prefill (B = 4, S = 4096, 32 heads,
// Dk = Dv = 64, chunk 32) a layer does ~11 GFLOP of float32 work (the
// cross, intra and state products and the pair weights) on ~0.40 GB of
// operands: the float32 rate bounds it (~0.17 ms at 67 TFLOP/s).
// Design, simple first: one 256-thread block per (stream, slice of Dv
// columns).  The columns of S evolve independently, so a slice holds its
// Dk x slice part of the state in shared memory for the whole sequence
// (the TPU kernel's VMEM carry becomes the block's chunk loop) and the
// launcher narrows the slice (64 -> 16 columns) until there are two blocks
// per SM: 128 streams become 512 blocks.  Each chunk stages r, k and the
// log-decay as float32 rows padded to Dk + 1 (column reads stay
// conflict-free), scans the log-decay per key dim, forms the C x C pair
// weights with one expf per (i, j, d), then each thread keeps an R-row
// register tile of one column for the output and state products.  CUDA
// cores with explicit fmaf; mma.sync / wgmma tiles and cp.async staging
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

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
// u's (batch, head).  `vb` columns per block: a power of two <= 64 that
// divides Dv; 1 <= chunk <= 64; Dk <= 64.  The wrapper checks the shapes.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v, const float* lw,
                                const float* u, const float* s0, void* out, float* s_t,
                                long long r_sb, long long r_sh, long long r_ss, long long k_sb,
                                long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                long long v_ss, long long w_sb, long long w_sh, long long w_ss,
                                long long o_sb, long long o_sh, long long o_ss, long long u_sb,
                                long long u_sh, int b, int h, int seq, int dk, int dv,
                                int chunk, int vb, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || h == 0 || seq == 0) return 0;
  if (chunk < 1 || chunk > 64 || dk < 1 || dk > 64 || vb < 1 || vb > 64 ||
      kThreads % vb != 0 || dv % vb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[5] = {{r_sb, r_sh, r_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
                         {w_sb, w_sh, w_ss}, {o_sb, o_sh, o_ss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(r, k, v, lw, u, s0, out, s_t, st, u_sb, u_sh, b, h, seq,
                                        dk, dv, chunk, vb, s)
                : launch<float>(r, k, v, lw, u, s0, out, s_t, st, u_sb, u_sh, b, h, seq, dk, dv,
                                chunk, vb, s);
  return static_cast<int>(err);
}
