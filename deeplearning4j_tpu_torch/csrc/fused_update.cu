// One-pass fused optimizer updates over many parameter leaves, for Hopper
// (sm_90a). One kernel template, two update rules:
//
//   Adam — replaces the TPU kernel B1a,
//     deeplearning4j_tpu/ops/fused_update.py `_adam_kernel` (via
//     `adam_update`): for every element of every leaf, in f32 math,
//       m' = b1 m + (1 - b1) g
//       v' = b2 v + (1 - b2) g g
//       p' = p - lrbc m' / (sqrt(v') + eps)
//   Nesterovs — replaces the TPU kernel B1b, `_nesterov_kernel` (via
//     `nesterov_update`), ND4J's form:
//       v' = mu v - lr g
//       p' = p + mu v' - lr g
//   with p and the moments updated in place (the TPU kernels'
//   input_output_aliases), each in its stored dtype.
//
// Bound. Adam: 4 reads and 3 writes an element and about 12 flops, 28
// bytes an element in float32. Nesterovs: 3 reads and 2 writes and 6
// flops, 20 bytes an element. Both are bound by memory, over the card's
// 3.35 TB/s.
//
// Design. One launch a step for a whole group of leaves, where the TPU
// launches once a leaf. The launch reads a device table of leaves, six
// int64 a leaf: the p, g, m and v addresses, the element count n and the
// leaf's first chunk (Nesterovs has no m: its column is 0 and never
// read). Each leaf is cut into chunks of `chunk` elements (a multiple of
// 4, chosen by the caller, which built the table with it); blocks walk the
// chunks in a grid-stride loop, find a chunk's leaf by a binary search
// over the first-chunk column, and stream it with 16-byte (float32) or
// 8-byte (bfloat16) vector accesses when all the addresses allow, scalar
// ones otherwise. The step's scalar (Adam's lrbc = lr sqrt(1 - b2^t) /
// (1 - b1^t), Nesterovs' lr from its schedule) is read from device memory,
// so the host never waits for the step count and the launch can be
// captured in a CUDA graph later.
//
// Numerics. Every operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn): no multiply-add contraction, so the kernels give
// the same bits as the same sequence of PyTorch elementwise operations.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLeafWords = 6;         // p, g, m, v, n, first chunk

// an update rule: kHasM says whether the leaf table's m column is used
struct AdamRule {
  static constexpr bool kHasM = true;
  float b1, c1, b2, c2, eps;          // c = 1 - b, rounded from double
  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v, float lrbc) const {
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(c1, g));
    v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(c2, g), g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lrbc, m),
                               __fadd_rn(__fsqrt_rn(v), eps)));
  }
};

struct NesterovRule {
  static constexpr bool kHasM = false;
  float mu;
  __device__ __forceinline__ void operator()(float& p, float g, float&,
                                             float& v, float lr) const {
    const float lrg = __fmul_rn(lr, g);
    v = __fsub_rn(__fmul_rn(mu, v), lrg);
    p = __fsub_rn(__fadd_rn(p, __fmul_rn(mu, v)), lrg);
  }
};

// four neighbouring elements as one vector access
struct F4 {
  float x[4];
};
__device__ __forceinline__ F4 load4(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return F4{{a.x, a.y, a.z, a.w}};
}
__device__ __forceinline__ void store4(float* p, const F4& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x[0], a.x[1], a.x[2], a.x[3]);
}
__device__ __forceinline__ F4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return F4{{lo.x, lo.y, hi.x, hi.y}};
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const F4& a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x[0], a.x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.x[2], a.x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, typename Rule>
__global__ void __launch_bounds__(kThreads)
multi_update_kernel(const int64_t* __restrict__ table, int n_leaves,
                    int n_chunks, int64_t chunk,
                    const float* __restrict__ scalar_ptr, Rule rule) {
  const float sc = *scalar_ptr;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the last leaf whose first chunk is <= c
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid * kLeafWords + 5] <= c) lo = mid; else hi = mid - 1;
    }
    const int64_t* leaf = table + lo * kLeafWords;
    T* p = reinterpret_cast<T*>(leaf[0]);
    const T* g = reinterpret_cast<const T*>(leaf[1]);
    T* m = reinterpret_cast<T*>(leaf[2]);
    T* v = reinterpret_cast<T*>(leaf[3]);
    const int64_t n = leaf[4];
    const int64_t start = (int64_t)(c - leaf[5]) * chunk;
    const int64_t end = start + chunk < n ? start + chunk : n;
    const uintptr_t any = (uintptr_t)p | (uintptr_t)g | (uintptr_t)v |
                          (Rule::kHasM ? (uintptr_t)m : 0);
    int64_t i0 = start;
    if ((any & (4 * sizeof(T) - 1)) == 0) {
      // start is a multiple of chunk, so every vector stays aligned
      const int64_t nvec = (end - start) / 4;
      for (int64_t j = threadIdx.x; j < nvec; j += kThreads) {
        const int64_t e = start + 4 * j;
        F4 pp = load4(p + e), gg = load4(g + e), vv = load4(v + e);
        F4 mm = {};
        if constexpr (Rule::kHasM) mm = load4(m + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) rule(pp.x[u], gg.x[u], mm.x[u], vv.x[u],
                                         sc);
        store4(p + e, pp);
        if constexpr (Rule::kHasM) store4(m + e, mm);
        store4(v + e, vv);
      }
      i0 = start + 4 * nvec;
    }
    for (int64_t e = i0 + threadIdx.x; e < end; e += kThreads) {
      float pp = ld1(p + e), vv = ld1(v + e), mm = 0.f;
      if constexpr (Rule::kHasM) mm = ld1(m + e);
      rule(pp, ld1(g + e), mm, vv, sc);
      st1(p + e, pp);
      if constexpr (Rule::kHasM) st1(m + e, mm);
      st1(v + e, vv);
    }
  }
}

template <typename Rule>
int launch(const void* table, int n_leaves, int n_chunks, int chunk,
           const void* scalar, int dtype, void* stream, const Rule& rule) {
  if (n_leaves < 0 || n_chunks < 0 || chunk < 4 || chunk % 4)
    return (int)cudaErrorInvalidValue;
  if (n_leaves == 0 || n_chunks == 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = n_chunks < 8 * sms ? n_chunks : 8 * sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* tab = static_cast<const int64_t*>(table);
  const float* sc = static_cast<const float*>(scalar);
  if (dtype == 0) {
    multi_update_kernel<float, Rule><<<grid, kThreads, 0, st>>>(
        tab, n_leaves, n_chunks, chunk, sc, rule);
  } else if (dtype == 1) {
    multi_update_kernel<__nv_bfloat16, Rule><<<grid, kThreads, 0, st>>>(
        tab, n_leaves, n_chunks, chunk, sc, rule);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: device int64 [n_leaves, 6] (p, g, m, v, n, first chunk), leaves
// in chunk order, chunks of `chunk` elements; lrbc / lr: device float32
// scalar; dtype: 0 = float32, 1 = bfloat16 for every tensor of every leaf.
// Each returns 0 or a cudaError_t.
int dl4j_adam_multi(const void* table, int n_leaves, int n_chunks,
                    int chunk, const void* lrbc, float b1, float c1,
                    float b2, float c2, float eps, int dtype,
                    void* stream) {
  AdamRule rule;
  rule.b1 = b1; rule.c1 = c1; rule.b2 = b2; rule.c2 = c2; rule.eps = eps;
  return launch(table, n_leaves, n_chunks, chunk, lrbc, dtype, stream, rule);
}

// the m column of the table is not read
int dl4j_nesterov_multi(const void* table, int n_leaves, int n_chunks,
                        int chunk, const void* lr, float mu, int dtype,
                        void* stream) {
  NesterovRule rule;
  rule.mu = mu;
  return launch(table, n_leaves, n_chunks, chunk, lr, dtype, stream, rule);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
