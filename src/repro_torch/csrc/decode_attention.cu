// Single-token attention over a KV cache with a valid-prefix length and an
// optional window (flash decoding), bf16 or float32, float32 arithmetic.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention/
// kernel.py: `decode_attention_pallas` (body `_kernel`).  Same math: logits
// `q . k * scale` over cache positions `< length` (and `> length - 1 -
// window`), a running max / normaliser / accumulator, `acc / max(l,
// 1e-30)`.  Positions outside that range are never read: their -1e30
// logits would weigh exactly 0 (for length >= 1; with length 0 the
// reference averages the whole cache and this kernel returns zeros).
//
// Layout: q [B, H, Dh], caches [B, S_max, Hkv, Dh] (the model's per-layer
// layout), out [B, H, Dh], all contiguous; `length` is one device int32,
// so the decode step needs no host sync.  GQA: query head h reads KV head
// h / (H / Hkv) in place -- the cache is never repeated (at B = 16, S =
// 32k that would copy 17 GB per step).
//
// Bound on the H100: the cache read.  At B = 16, length 32000, 8 KV heads,
// Dh = 64, bf16, one layer reads 1.05 GB of K and V (0.31 ms at 3.35
// TB/s); the arithmetic is 4 flops per cache element and query head.
// Design, simple first: one 256-thread block per (batch, KV head) holding
// the group's H / Hkv query rows in registers.  Each cache row is split
// over Dh / (16 B) lanes (8 lanes for bf16 Dh = 64), so a warp reads four
// rows at once with 16-byte loads, four rows deep per lane (unrolled, all
// loads in flight before the arithmetic).  A row's lanes span the next
// power of two: zamba2's Dh = 112 is 14 lanes in bf16 (a span of 16, two
// lanes idle, two rows per warp) and 28 in float32 (a span of 32, four
// idle).  Each lane group keeps its own
// online softmax, the groups of a warp merge by shuffles and the eight
// warps through shared memory.  At B = 16 that is 128 blocks on 132 SMs;
// split-KV with a combine pass is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // cache rows per lane group per step
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of T as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&out)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
  __device__ __forceinline__ static void put(float* p, float x) { *p = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&out)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <typename T, int DH, int NREP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ length_ptr, T* __restrict__ out,
              int s_max, int n_kv, float scale, int window) {
  using V = Vec<T>;
  constexpr int kVec = V::kN;        // elements per 16-byte load
  constexpr int kLanes = DH / kVec;  // lanes holding one cache row
  constexpr int kSpan = kLanes <= 1 ? 1 : kLanes <= 2 ? 2 : kLanes <= 4 ? 4
                        : kLanes <= 8 ? 8 : kLanes <= 16 ? 16 : 32;  // lanes per row group
  constexpr int kGroups = 32 / kSpan;  // cache rows a warp reads at once
  static_assert(DH % kVec == 0 && kLanes >= 1 && kLanes <= 32, "head dim");
  __shared__ float m_s[kWarps][NREP];
  __shared__ float l_s[kWarps][NREP];
  __shared__ float acc_s[kWarps][NREP][DH];

  const int b = blockIdx.x / n_kv;
  const int g = blockIdx.x % n_kv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kSpan;
  const int sub = lane % kSpan;
  const bool on = sub < kLanes;  // lanes past the row's end load nothing
  const int n_heads = n_kv * NREP;

  const int length = *length_ptr;
  const int hi = min(length, s_max);
  const int lo = window > 0 ? max(0, length - window) : 0;

  float qv[NREP][kVec];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qp = q + (static_cast<long long>(b) * n_heads + g * NREP + r) * DH + sub * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) qv[r][j] = on ? V::one(qp + j) : 0.0f;
  }
  float m[NREP], l[NREP], acc[NREP][kVec];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.0f;
  }

  const long long row = static_cast<long long>(n_kv) * DH;  // cache position stride
  const long long base = (static_cast<long long>(b) * s_max * n_kv + g) * DH + sub * kVec;
  const T* kb = kc + base;
  const T* vb = vc + base;
  constexpr int kStep = kWarps * kGroups * kUnroll;  // rows per block step

  // The loop bound is uniform across the warp (its shuffles need every lane).
  for (int w0 = lo + warp * kGroups * kUnroll; w0 < hi; w0 += kStep) {
    const int p0 = w0 + grp * kUnroll;
    float kx[kUnroll][kVec], vx[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (on && p0 + u < hi) {
        V::load(kb + (p0 + u) * row, kx[u]);
        V::load(vb + (p0 + u) * row, vx[u]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kx[u][j] = vx[u][j] = 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float sc[kUnroll];
      float m_blk = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) dot = fmaf(qv[r][j], kx[u][j], dot);
#pragma unroll
        for (int off = kSpan / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
        sc[u] = p0 + u < hi ? dot * scale : -INFINITY;
        m_blk = fmaxf(m_blk, sc[u]);
      }
      const float m_new = fmaxf(m[r], m_blk);
      const float alpha = expf(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(sc[u] - m_new);
        l[r] += p;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[r][j] = fmaf(p, vx[u][j], acc[r][j]);
      }
      m[r] = m_new;
    }
  }

  // Merge the lane groups of each warp (lanes with the same `sub`).
#pragma unroll
  for (int off = kSpan; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], off);
      const float lo_ = __shfl_xor_sync(kFull, l[r], off);
      const float mm = fmaxf(m[r], mo);
      const float a = expf(m[r] - mm);
      const float c = expf(mo - mm);
      l[r] = l[r] * a + lo_ * c;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float ao = __shfl_xor_sync(kFull, acc[r][j], off);
        acc[r][j] = acc[r][j] * a + ao * c;
      }
      m[r] = mm;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (sub == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = l[r];
      }
      if (on) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc_s[warp][r][sub * kVec + j] = acc[r][j];
      }
    }
  }
  __syncthreads();

  // Merge the warps; one thread per (query row, head dim).
  for (int e = threadIdx.x; e < NREP * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e % DH;
    float mm = m_s[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][r]);
    float lsum = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][r] - mm);
      lsum = fmaf(l_s[w][r], c, lsum);
      o = fmaf(acc_s[w][r][d], c, o);
    }
    V::put(out + (static_cast<long long>(b) * n_heads + g * NREP + r) * DH + d,
           o / fmaxf(lsum, 1e-30f));
  }
}

// Instantiated for llama3.2-1b's head dim and query heads per KV head (64,
// 32 / 8 = 4) and zamba2-7b's shared attention (112, MHA: 1); other shapes
// are added when a config needs them.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* len, void* o,
                   int b, int s_max, int n_kv, int n_rep, int dh, float scale, int window,
                   cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (dh == 64 && n_rep == 4) {
    decode_kernel<T, 64, 4><<<b * n_kv, kThreads, 0, s>>>(qp, kp, vp, len, op, s_max, n_kv,
                                                          scale, window);
  } else if (dh == 112 && n_rep == 1) {
    decode_kernel<T, 112, 1><<<b * n_kv, kThreads, 0, s>>>(qp, kp, vp, len, op, s_max, n_kv,
                                                           scale, window);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// `length` points at one device int32; `window` <= 0 means no window.
extern "C" int repro_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const int* length, void* out, int b, int h, int hkv,
                                      int s_max, int dh, float scale, int window, int is_bf16,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || h == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(q, k_cache, v_cache, length, out, b, s_max, hkv,
                                        h / hkv, dh, scale, window, s)
                : launch<float>(q, k_cache, v_cache, length, out, b, s_max, hkv, h / hkv, dh,
                                scale, window, s);
  return static_cast<int>(err);
}
