// Causal, sliding-window or bidirectional attention with an online softmax
// (flash attention), bf16 or float32 operands, float32 arithmetic.
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
// h / (H / Hkv) in place; the KV heads are never repeated.
//
// Bound on the H100: at the llama3.2-1b prefill (B = 4, S = 4096, 32 / 8
// heads, Dh = 64, causal) the work is ~2 * S^2 * Dh per head (the causal
// half of QK^T and PV): 275 GFLOP per layer against ~168 MB of q, k, v
// and out, so the tensor cores bound it (~0.28 ms at 989 TFLOP/s bf16).
// Design, simple first: one 256-thread block per (batch, head, 64-row
// query tile).  Four threads share a query row, each holding an
// interleaved quarter of its head dims (q and the accumulator stay in
// registers); 32-key tiles of K and V are staged in shared memory as
// float32.  A score is four partial dot products summed with two
// shuffles, so the four threads hold the same row max and normaliser.
// The key loop ends at the tile's causal limit and starts at its window
// limit, so fully masked tiles cost nothing (the Pallas grid still visits
// them).  CUDA cores with explicit fmaf (the library builds with
// -fmad=false); mma.sync / wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 32;       // keys per shared-memory tile
constexpr int kThreads = 256;  // four threads per query row
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;  // elements; the head-dim stride is 1
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
                 int n_heads, int n_rep, int sq, int skv, float scale, int causal,
                 int window) {
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float qr[kPart], acc[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) {
    qr[i] = qi < sq ? to_f32(qb[qi * qs.s + i * 4 + part]) : 0.0f;
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
        kx = to_f32(kb[kp * ks.s + d]);
        vx = to_f32(vb[kp * vs.s + d]);
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
    T* ob = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int i = 0; i < kPart; ++i) store(ob + i * 4 + part, acc[i] / denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs,
                   Strides ks, Strides vs, Strides os, int b, int h, int hkv, int sq,
                   int skv, int dh, float scale, int causal, int window, cudaStream_t s) {
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  const int n_rep = h / hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  // llama3.2-1b's head dim (64) and zamba2-7b's (3584 / 32 = 112: two 32 x
  // 116 float32 tiles, 29.7 KB of static shared memory); other widths are
  // instantiated when a config needs them.
  if (dh == 64) {
    flash_fwd_kernel<T, 64><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, qs, ks, vs, os, h, n_rep,
                                                      sq, skv, scale, causal, window);
  } else if (dh == 112) {
    flash_fwd_kernel<T, 112><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, qs, ks, vs, os, h,
                                                       n_rep, sq, skv, scale, causal, window);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// `window` <= 0 means no window; it applies only when `causal` is set (as
// in the reference).  The wrapper checks the shapes and the head dims.
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
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, dh,
                                        scale, causal, window, s)
                : launch<float>(q, k, v, o, qs, ks, vs, os, b, h, hkv, sq, skv, dh, scale,
                                causal, window, s);
  return static_cast<int>(err);
}
