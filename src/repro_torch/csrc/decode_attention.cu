// Single-token attention over a KV cache with a valid-prefix length and an
// optional window (flash decoding), bf16 or float32, float32 arithmetic.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention/
// kernel.py: `decode_attention_pallas` (body `_kernel`).  Same math: logits
// `q . k * scale` over cache positions `< length` (and `> length - 1 -
// window`), a running max / normaliser / accumulator, `acc / max(l,
// 1e-30)`.  Positions outside that range are never read: their -1e30
// logits weigh exactly 0.  When the range is empty (length 0) every logit
// of the reference is -1e30 and its softmax weighs all S_max rows equally:
// the kernel then reads the whole cache with equal logits, so the output
// is the mean of V, as `ref.py` computes (the Pallas kernel returns zeros
// there; ROADMAP Queue 3).
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
// Design: split-KV.  The wrapper picks `n_splits` from host-known numbers
// only (B, Hkv, S_max, and the blocks the card holds at once: the SM count
// times this kernel's blocks per SM from CUDA's occupancy calculator), so
// that one wave of 128-thread blocks, one per (batch, KV head, split),
// fills the card.  Each block reads the device `length` and computes its
// own slice of the valid range (the formula of kernels/decode_attention/
// kernel.py:split_range), holds the group's H / Hkv query rows in
// registers and streams its slice: each cache row is split over Dh / (16
// B) lanes (8 lanes for bf16 Dh = 64), so a warp reads four rows at once,
// four rows deep per lane.  The 16-byte pieces go through a per-thread
// cp.async ring in shared memory, kStages - 1 steps ahead of the
// arithmetic, so loads stay in flight without holding registers and
// without block barriers (a thread reads only the slots it filled).  A
// row's lanes span the next power of two: zamba2's Dh = 112 is 14 lanes in
// bf16 (a span of 16, two lanes idle, two rows per warp) and 28 in float32
// (a span of 32, four idle).  Each lane group keeps its own online softmax;
// the groups of a warp merge by shuffles and the warps through shared
// memory into one float32 partial (m, l, acc[Dh]) per (batch, query head,
// split), written to a workspace the wrapper allocates.  A split with no
// rows writes l = 0 and m = -inf.  `decode_combine_kernel` then merges the
// splits of each query row in split order (deterministic) and writes
// `acc / max(l, 1e-30)` in q's dtype.  TMA bulk copies of the cache rows
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // cache rows per lane group per step
constexpr int kStages = 4;  // cp.async ring: steps in flight per thread, kStages - 1 ahead
// Each thread's ring slots (16 bytes of K and of V per row of a step),
// thread index fastest so a warp's slots are contiguous: 64 KB per block.
constexpr int kRingBytes = kStages * kUnroll * 2 * kThreads * 16;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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
};

template <>
struct Vec<__nv_bfloat16> {
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
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// Lane geometry of one cache row: 16-byte loads, lanes spanning the next
// power of two.  kernel.py:rows_per_step mirrors kStep.
template <typename T, int DH>
struct Rows {
  static constexpr int kVec = Vec<T>::kN;   // elements per 16-byte load
  static constexpr int kLanes = DH / kVec;  // lanes holding one cache row
  static constexpr int kSpan = kLanes <= 1 ? 1 : kLanes <= 2 ? 2 : kLanes <= 4 ? 4
                               : kLanes <= 8 ? 8 : kLanes <= 16 ? 16 : 32;
  static constexpr int kGroups = 32 / kSpan;               // rows a warp reads at once
  static constexpr int kStep = kWarps * kGroups * kUnroll;  // rows per block step
  static_assert(DH % kVec == 0 && kLanes >= 1 && kLanes <= 32, "head dim");
};

template <typename T, int DH, int NREP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ length_ptr, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int s_max, int n_kv, int n_splits, float scale,
                    int window) {
  using V = Vec<T>;
  using R = Rows<T, DH>;
  constexpr int kVec = R::kVec, kLanes = R::kLanes, kSpan = R::kSpan, kGroups = R::kGroups;
  extern __shared__ uint4 ring[];  // [kStages][kUnroll][K, V][kThreads]
  __shared__ float m_s[kWarps][NREP];
  __shared__ float l_s[kWarps][NREP];
  __shared__ float acc_s[kWarps][NREP][DH];

  const int split = blockIdx.x;
  const int b = blockIdx.y / n_kv;
  const int g = blockIdx.y % n_kv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kSpan;
  const int sub = lane % kSpan;
  const bool on = sub < kLanes;  // lanes past the row's end load nothing
  const int n_heads = n_kv * NREP;

  // The valid range, and this split's slice of it: the formula of
  // kernels/decode_attention/kernel.py:valid_range / split_range (their
  // tiling is tested on the CPU in tests/test_torch_llm_kernels.py).
  const int length = *length_ptr;
  int hi = min(length, s_max);
  int lo = window > 0 ? max(0, length - window) : 0;
  const bool uniform = hi <= lo;  // no valid row: equal weight on all S_max rows
  if (uniform) {
    lo = 0;
    hi = s_max;
  }
  int chunk = (hi - lo + n_splits - 1) / n_splits;
  chunk = (chunk + R::kStep - 1) / R::kStep * R::kStep;
  const int s_lo = min(hi, lo + split * chunk);
  const int s_hi = min(hi, s_lo + chunk);

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

  // Step i of this warp covers rows w_lo + i * kStep + [0, kGroups *
  // kUnroll); the count is uniform across the warp (its shuffles need every
  // lane).  Each thread copies its own rows' 16-byte pieces into its own
  // ring slots, kStages - 1 steps ahead, so no block barrier is needed:
  // cp.async.wait_group orders a thread's copies before its reads.
  const int w_lo = s_lo + warp * kGroups * kUnroll;
  const int n_iter = s_hi > w_lo ? (s_hi - w_lo + R::kStep - 1) / R::kStep : 0;
  auto slot = [&](int i, int u, int kv) {
    return ring + (((i % kStages) * kUnroll + u) * 2 + kv) * kThreads + threadIdx.x;
  };
  auto issue = [&](int i) {
    if (i < n_iter) {
      const int p0 = w_lo + i * R::kStep + grp * kUnroll;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = on && p0 + u < s_hi;  // zero-filled otherwise
        repro::cp_async16(slot(i, u, 0), ok ? kb + (p0 + u) * row : kb, ok);
        repro::cp_async16(slot(i, u, 1), ok ? vb + (p0 + u) * row : vb, ok);
      }
    }
    repro::cp_async_commit();  // empty past the last step: the group count stays fixed
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  for (int i = 0; i < n_iter; ++i) {
    issue(i + kStages - 1);
    repro::cp_async_wait<kStages - 1>();
    const int p0 = w_lo + i * R::kStep + grp * kUnroll;
    float kx[kUnroll][kVec], vx[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      V::unpack(*slot(i, u, 0), kx[u]);
      V::unpack(*slot(i, u, 1), vx[u]);
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
        sc[u] = p0 + u < s_hi ? (uniform ? 0.0f : dot * scale) : -INFINITY;
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
  repro::cp_async_wait<0>();

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

  // Merge the warps into this split's partial; one thread per (query row,
  // head dim).  Warps that saw no row hold m = -1e30, l = 0 and weigh 0.
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
    const long long part = (static_cast<long long>(b) * n_heads + g * NREP + r) * n_splits + split;
    part_acc[part * DH + d] = o;
    if (d == 0) {
      part_ml[2 * part] = lsum > 0.0f ? mm : -INFINITY;
      part_ml[2 * part + 1] = lsum;
    }
  }
}

// One block per (batch, query head); thread d merges head dim d over the
// splits in split order.
template <typename T, int DH>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      T* __restrict__ out, int n_splits) {
  const int d = threadIdx.x;
  if (d >= DH) return;
  const long long row = blockIdx.x;
  const float* ml = part_ml + 2 * row * n_splits;
  const float* pa = part_acc + row * n_splits * DH + d;
  float mm = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mm = fmaxf(mm, ml[2 * s]);
  float lsum = 0.0f, o = 0.0f;
  if (mm > -INFINITY) {
    for (int s = 0; s < n_splits; ++s) {
      const float l = ml[2 * s + 1];
      if (l > 0.0f) {
        const float c = expf(ml[2 * s] - mm);
        lsum = fmaf(l, c, lsum);
        o = fmaf(pa[s * DH], c, o);
      }
    }
  }
  Vec<T>::put(out + row * DH + d, o / fmaxf(lsum, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  const int* len;
  void* o;
  float *part_acc, *part_ml;
  int b, s_max, n_kv, n_splits;
  float scale;
  int window;
};

// Lets the split kernel take its 64 KB ring (over the 48 KB default) on
// `device`, and with `blocks_per_sm` reports how many of its blocks one SM
// holds.
template <typename T, int DH, int NREP>
cudaError_t prepare(int device, int* blocks_per_sm) {
  auto kern = decode_split_kernel<T, DH, NREP>;
  static bool ready[16] = {};
  const cudaError_t err = repro::allow_smem(kern, kRingBytes, device, ready);
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, kThreads, kRingBytes);
}

template <typename T, int DH, int NREP>
cudaError_t launch_shape(const Args& a, int device, cudaStream_t s) {
  cudaError_t err = prepare<T, DH, NREP>(device, nullptr);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_splits, a.b * a.n_kv);
  decode_split_kernel<T, DH, NREP><<<grid, kThreads, kRingBytes, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.len,
      a.part_acc, a.part_ml, a.s_max, a.n_kv, a.n_splits, a.scale, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, DH><<<a.b * a.n_kv * NREP, (DH + 31) / 32 * 32, 0, s>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.o), a.n_splits);
  return cudaGetLastError();
}

template <typename T, int DH, int NREP>
cudaError_t run(const Args* a, int device, cudaStream_t s, int* blocks_per_sm) {
  return a ? launch_shape<T, DH, NREP>(*a, device, s)
           : prepare<T, DH, NREP>(device, blocks_per_sm);
}

// Instantiated for the (head dim, query heads per KV head) pairs of the
// ported configs: llama3.2-1b (64, 32 / 8 = 4), whisper-medium's self and
// cross attention (64, MHA: 1) and its smoke config, zamba2-7b's shared
// attention (112, MHA: 1), kimi-k2-1t-a32b (112, 64 / 8 = 8),
// phi3-medium-14b (128, 40 / 10 = 4), mixtral-8x22b (128, 48 / 8 = 6),
// qwen2-vl-2b (128, 12 / 2 = 6), yi-34b (128, 56 / 8 = 7) and
// command-r-35b (128, 64 / 8 = 8); and the smoke configs at the kernels'
// head dim of 64 (`configs.for_kernels` widens their head dims and keeps
// their ratios of 2, 3, 7 and 8).  (112, 8) holds q and the accumulator as
// 8 x kVec registers a thread, as (128, 8) does.  Other shapes are added
// when a config needs them.  `a == nullptr` asks for the split kernel's
// blocks per SM instead of launching.
template <typename T>
cudaError_t dispatch(int dh, int n_rep, const Args* a, int device, cudaStream_t s,
                     int* blocks_per_sm) {
  if (dh == 64) {
    switch (n_rep) {
      case 1: return run<T, 64, 1>(a, device, s, blocks_per_sm);
      case 2: return run<T, 64, 2>(a, device, s, blocks_per_sm);
      case 3: return run<T, 64, 3>(a, device, s, blocks_per_sm);
      case 4: return run<T, 64, 4>(a, device, s, blocks_per_sm);
      case 7: return run<T, 64, 7>(a, device, s, blocks_per_sm);
      case 8: return run<T, 64, 8>(a, device, s, blocks_per_sm);
    }
  } else if (dh == 112) {
    switch (n_rep) {
      case 1: return run<T, 112, 1>(a, device, s, blocks_per_sm);
      case 8: return run<T, 112, 8>(a, device, s, blocks_per_sm);
    }
  } else if (dh == 128) {
    switch (n_rep) {
      case 4: return run<T, 128, 4>(a, device, s, blocks_per_sm);
      case 6: return run<T, 128, 6>(a, device, s, blocks_per_sm);
      case 7: return run<T, 128, 7>(a, device, s, blocks_per_sm);
      case 8: return run<T, 128, 8>(a, device, s, blocks_per_sm);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// `length` points at one device int32; `window` <= 0 means no window.
// `part_acc` holds B * H * n_splits * dh floats and `part_ml` B * H *
// n_splits * 2 (the wrapper's workspace).  Two launches: the split pass,
// then the combine.
extern "C" int repro_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const int* length, void* out, float* part_acc,
                                      float* part_ml, int b, int h, int hkv, int s_max, int dh,
                                      int n_splits, float scale, int window, int is_bf16,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || h == 0) return 0;
  if (n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, length, out, part_acc, part_ml, b, s_max, hkv, n_splits,
               scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch<__nv_bfloat16>(dh, h / hkv, &a, device, s, nullptr)
                : dispatch<float>(dh, h / hkv, &a, device, s, nullptr);
  return static_cast<int>(err);
}

// Blocks of the split kernel one SM holds at once (its registers and its
// ring bound it), for the wrapper's split plan.
extern "C" int repro_decode_attention_blocks_per_sm(int dh, int n_rep, int is_bf16, int device,
                                                    int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = is_bf16 ? dispatch<__nv_bfloat16>(dh, n_rep, nullptr, device, nullptr, blocks_per_sm)
                : dispatch<float>(dh, n_rep, nullptr, device, nullptr, blocks_per_sm);
  return static_cast<int>(err);
}
