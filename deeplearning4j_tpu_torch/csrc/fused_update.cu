// One-pass fused optimizer updates over many parameter leaves, for Hopper
// (sm_90a). One kernel template a design, two update rules:
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
// bytes an element in float32 (14 in bfloat16). Nesterovs: 3 reads and 2
// writes and 6 flops, 20 bytes an element (10). Both are bound by memory,
// over the card's 3.35 TB/s: the arithmetic is under 0.5 flop a byte.
//
// The leaf table. One launch a step for a whole group of leaves, where
// the TPU launches once a leaf. The launch reads a device table of
// leaves, five int64 a leaf: the p, m and v addresses, the element count
// n and the leaf's first chunk (Nesterovs has no m: its column is 0 and
// never read), uploaded once a leaf set. The gradients' addresses, new
// at most steps (each step's backward makes its gradients anew), go by
// value in the launch's own parameters (`GradAddrs`, a __grid_constant__
// array: 4 KB for up to 512 leaves, 32,000 bytes for up to 4,000, under
// the 32,764 bytes CUDA 12.1 and later allow), so a step copies nothing
// to the card before its launch and a captured graph keeps the addresses
// it was captured with. Each leaf is cut into chunks of `chunk` elements
// (2048; the caller built the first-chunk column with it), leaves in
// table order.
//
// Design 1 (`multi_update_kernel`, "multi"): up to 8 blocks an SM walk
// the chunks in a grid-stride loop, find a chunk's leaf by a binary search
// over the first-chunk column, and stream it with 16-byte (float32) or
// 8-byte (bfloat16) vector accesses when all the addresses allow, scalar
// ones otherwise. Nothing keeps the next chunk's bytes in flight while a
// chunk is computed, and each chunk pays a search and a reload of its row.
//
// Design 2 (`persistent_update_kernel`, "persistent"): two blocks an SM,
// each owning a contiguous run of chunks (the caller's block table: first
// chunk, end, first leaf), so a block finds its first leaf once and walks
// forward. One producer thread streams each chunk's g, p, v (and m) into
// a ring of 3 shared-memory stages with TMA 1-D bulk copies
// (`cp.async.bulk ... mbarrier::complete_tx::bytes`, one "full" mbarrier
// a stage; 32 KB a float32 Adam stage, 96 KB a block, so four stages,
// 128 KB, stay in flight an SM while two are computed: the ~25 KB an SM
// that covers HBM's latency at 3.35 TB/s, several times over; against
// one block of 4 or 6 stages, two of 2 and one of 16 consumer warps,
// this was the fastest or tied at every path shape on an H100:
// tools/torch_b1_variants.py). Eight
// consumer warps update from shared memory and store 16-byte vectors
// straight to p, m and v, then free the stage on its "empty" mbarrier
// (phase parity: round r of a stage has parity r & 1). Bulk copies need 16-byte aligned addresses and
// lengths: a leaf whose addresses are not all 16-byte aligned (a view at
// an odd offset), and the tail of a leaf past its last whole 16 bytes (a
// bf16 length not a multiple of 8, a leaf of 1 or 127 elements), take a
// scalar path from global memory inside the same stage, so every chunk,
// short or not, goes round the ring the same way (an empty copy still
// completes its stage's phase).
//
// The step's scalar (Adam's lrbc = lr sqrt(1 - b2^t) / (1 - b1^t),
// Nesterovs' lr from its schedule) is read from device memory once a
// thread, so the host never waits for the step count and the launch can
// be captured in a CUDA graph. `adam_lrbc_kernel` computes Adam's lrbc on
// the card from the step counter (one thread; it replaces no TPU kernel:
// JAX computes it with XLA ops, deeplearning4j_tpu/optim/updaters.py:193),
// so a step's update costs the host one launch for it and not a dozen
// elementwise operations.
//
// Numerics. Every operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn): no multiply-add contraction, so both designs
// give the same bits as the same sequence of PyTorch elementwise
// operations.
//
// Design 2 sets its dynamic shared-memory limit (over 48 KB) in
// `dl4j_fused_update_prepare`, which the caller runs once after loading
// the library: never inside a launch, which a CUDA graph may capture.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLeafWords = 5;         // p, m, v, n, first chunk
constexpr int kSmallCap = 512;        // leaves of the small GradAddrs
constexpr int kMaxLeaves = 4000;      // leaves of the large one

// the gradients' addresses, leaves in table order, passed by value
template <int Cap>
struct GradAddrs {
  const void* g[Cap];
};

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

// one leaf's row of the table
template <typename T>
struct Leaf {
  T* p;
  T* m;
  T* v;
  const T* g;
  int64_t n, first;
};

template <typename T>
__device__ __forceinline__ Leaf<T> leaf_row(const int64_t* table,
                                            const void* const* gaddr,
                                            int l) {
  const int64_t* row = table + (int64_t)l * kLeafWords;
  return Leaf<T>{reinterpret_cast<T*>(row[0]), reinterpret_cast<T*>(row[1]),
                 reinterpret_cast<T*>(row[2]),
                 static_cast<const T*>(gaddr[l]), row[3], row[4]};
}

// elements [i0, end) of one chunk from global memory, one a thread
template <typename T, typename Rule>
__device__ __forceinline__ void scalar_span(T* p, const T* g, T* m, T* v,
                                            int64_t i0, int64_t end,
                                            int tid, int nthreads,
                                            const Rule& rule, float sc) {
  for (int64_t e = i0 + tid; e < end; e += nthreads) {
    float pp = ld1(p + e), vv = ld1(v + e), mm = 0.f;
    if constexpr (Rule::kHasM) mm = ld1(m + e);
    rule(pp, ld1(g + e), mm, vv, sc);
    st1(p + e, pp);
    if constexpr (Rule::kHasM) st1(m + e, mm);
    st1(v + e, vv);
  }
}

// ------------------------------------------------------------ design 1
template <typename T, typename Rule, int Cap>
__global__ void __launch_bounds__(kThreads)
multi_update_kernel(const int64_t* __restrict__ table,
                    const __grid_constant__ GradAddrs<Cap> grads,
                    int n_leaves, int n_chunks, int64_t chunk,
                    const float* __restrict__ scalar_ptr, Rule rule) {
  const float sc = *scalar_ptr;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the last leaf whose first chunk is <= c
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid * kLeafWords + 4] <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf<T> L = leaf_row<T>(table, grads.g, lo);
    const int64_t start = (int64_t)(c - L.first) * chunk;
    const int64_t end = start + chunk < L.n ? start + chunk : L.n;
    const uintptr_t any = (uintptr_t)L.p | (uintptr_t)L.g | (uintptr_t)L.v |
                          (Rule::kHasM ? (uintptr_t)L.m : 0);
    int64_t i0 = start;
    if ((any & (4 * sizeof(T) - 1)) == 0) {
      // start is a multiple of chunk, so every vector stays aligned
      const int64_t nvec = (end - start) / 4;
      for (int64_t j = threadIdx.x; j < nvec; j += kThreads) {
        const int64_t e = start + 4 * j;
        F4 pp = load4(L.p + e), gg = load4(L.g + e), vv = load4(L.v + e);
        F4 mm = {};
        if constexpr (Rule::kHasM) mm = load4(L.m + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) rule(pp.x[u], gg.x[u], mm.x[u], vv.x[u],
                                         sc);
        store4(L.p + e, pp);
        if constexpr (Rule::kHasM) store4(L.m + e, mm);
        store4(L.v + e, vv);
      }
      i0 = start + 4 * nvec;
    }
    scalar_span(L.p, L.g, L.m, L.v, i0, end, threadIdx.x, kThreads, rule,
                sc);
  }
}

// ------------------------------------------------------------ design 2
namespace persist {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kBlockThreads = kConsumers + 32;   // + the producer warp
constexpr int kStages = 3;
constexpr int kChunk = 2048;                     // elements a stage
constexpr int kBlockWords = 3;                   // first chunk, end, leaf

// what the producer tells the consumers about the chunk a stage holds
template <typename T>
struct Stage {
  T* p;                 // the chunk's first element in each tensor
  T* m;
  T* v;
  const T* g;
  int len;              // elements of the chunk
  int nbulk;            // its leading elements, copied in by TMA
};

// sixteen bytes of elements as floats
template <typename T>
struct V16 {
  static constexpr int kN = 16 / sizeof(T);
  float x[kN];
};

__device__ __forceinline__ V16<float> load16(const float* p) {
  const F4 a = load4(p);
  return V16<float>{{a.x[0], a.x[1], a.x[2], a.x[3]}};
}
__device__ __forceinline__ void store16(float* p, const V16<float>& a) {
  store4(p, F4{{a.x[0], a.x[1], a.x[2], a.x[3]}});
}
__device__ __forceinline__ V16<__nv_bfloat16> load16(
    const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  V16<__nv_bfloat16> out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out.x[2 * i] = f.x;
    out.x[2 * i + 1] = f.y;
  }
  return out;
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const V16<__nv_bfloat16>& a) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a.x[2 * i], a.x[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing `bar`'s transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(bytes),
         "r"(hopper::smem_u32(bar))
      : "memory");
}

// tensors a stage holds: g, p, v (and m)
template <typename Rule>
constexpr int kTensors = Rule::kHasM ? 4 : 3;

template <typename T, typename Rule>
constexpr size_t smem_bytes() {
  return (size_t)kStages * kTensors<Rule> * kChunk * sizeof(T) +
         2 * kStages * sizeof(uint64_t) + kStages * sizeof(Stage<T>);
}

template <typename T, typename Rule, int Cap>
__global__ void __launch_bounds__(kBlockThreads, 2)
persistent_update_kernel(const int64_t* __restrict__ table,
                         const __grid_constant__ GradAddrs<Cap> grads,
                         const int64_t* __restrict__ blocks, int n_leaves,
                         int n_chunks, const float* __restrict__ scalar_ptr,
                         Rule rule) {
  constexpr int NT = kTensors<Rule>;
  constexpr int kVec = V16<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  // stage s, tensor k (0 g, 1 p, 2 v, 3 m): kChunk elements
  T* data = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)kStages * NT * kChunk * sizeof(T));
  uint64_t* empty = full + kStages;
  Stage<T>* meta = reinterpret_cast<Stage<T>*>(empty + kStages);

  const int64_t* blk = blocks + (int64_t)blockIdx.x * kBlockWords;
  const int64_t c0 = blk[0], c1 = blk[1];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == kConsumerWarps) {
    // the producer: one thread walks the block's chunks forward
    if (lane != 0) return;
    int l = (int)blk[2];
    Leaf<T> L = leaf_row<T>(table, grads.g, l);
    int64_t next = l + 1 < n_leaves ? table[(l + 1) * kLeafWords + 4]
                                    : n_chunks;
    for (int64_t c = c0, it = 0; c < c1; ++c, ++it) {
      const int s = (int)(it % kStages);
      const uint32_t round = (uint32_t)(it / kStages);
      hopper::mbar_wait(&empty[s], (round & 1) ^ 1);
      while (c >= next) {                  // past this leaf's chunks
        ++l;
        L = leaf_row<T>(table, grads.g, l);
        next = l + 1 < n_leaves ? table[(l + 1) * kLeafWords + 4]
                                : n_chunks;
      }
      const int64_t start = (c - L.first) * kChunk;
      const int len = (int)(L.n - start < kChunk ? L.n - start : kChunk);
      const uintptr_t any = (uintptr_t)L.p | (uintptr_t)L.g |
                            (uintptr_t)L.v |
                            (Rule::kHasM ? (uintptr_t)L.m : 0);
      // start is a multiple of kChunk: an aligned leaf's chunks stay so
      const int nbulk = (any & 15) == 0 ? len / kVec * kVec : 0;
      Stage<T>& st = meta[s];
      st.p = L.p + start;
      st.m = Rule::kHasM ? L.m + start : nullptr;
      st.v = L.v + start;
      st.g = L.g + start;
      st.len = len;
      st.nbulk = nbulk;
      const uint32_t bytes = (uint32_t)nbulk * sizeof(T);
      // the arrival releases the stores above to the consumers' wait
      hopper::mbar_expect_tx(&full[s], bytes * NT);
      if (bytes) {
        T* slot = data + (size_t)s * NT * kChunk;
        bulk_load(slot, st.g, bytes, &full[s]);
        bulk_load(slot + kChunk, st.p, bytes, &full[s]);
        bulk_load(slot + 2 * kChunk, st.v, bytes, &full[s]);
        if constexpr (Rule::kHasM)
          bulk_load(slot + 3 * kChunk, st.m, bytes, &full[s]);
      }
    }
    return;
  }

  // the consumers
  const float sc = *scalar_ptr;
  const int tid = threadIdx.x;
  for (int64_t c = c0, it = 0; c < c1; ++c, ++it) {
    const int s = (int)(it % kStages);
    const uint32_t round = (uint32_t)(it / kStages);
    hopper::mbar_wait(&full[s], round & 1);
    const Stage<T> st = meta[s];
    const T* slot = data + (size_t)s * NT * kChunk;
    for (int j = tid * kVec; j < st.nbulk; j += kConsumers * kVec) {
      V16<T> gg = load16(slot + j), pp = load16(slot + kChunk + j),
             vv = load16(slot + 2 * kChunk + j), mm = {};
      if constexpr (Rule::kHasM) mm = load16(slot + 3 * kChunk + j);
#pragma unroll
      for (int u = 0; u < kVec; ++u) rule(pp.x[u], gg.x[u], mm.x[u],
                                          vv.x[u], sc);
      store16(st.p + j, pp);
      if constexpr (Rule::kHasM) store16(st.m + j, mm);
      store16(st.v + j, vv);
    }
    // a ragged tail, or a whole unaligned chunk, from global memory
    scalar_span(st.p, st.g, st.m, st.v, (int64_t)st.nbulk,
                (int64_t)st.len, tid, kConsumers, rule, sc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);   // the stage is free
  }
}

template <typename T, typename Rule>
cudaError_t set_limit() {
  cudaError_t e = cudaFuncSetAttribute(
      persistent_update_kernel<T, Rule, kSmallCap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T, Rule>());
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(persistent_update_kernel<T, Rule, kMaxLeaves>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<T, Rule>());
}

}  // namespace persist

__global__ void adam_lrbc_kernel(const int64_t* __restrict__ step,
                                 const float* __restrict__ lr_ptr, float lr,
                                 float b1, float b2,
                                 float* __restrict__ out) {
  // the operations of the plain version in order: t = f32(step) + 1, then
  // lr sqrt(1 - b2^t) / (1 - b1^t), each rounded on its own; lr is a
  // schedule's value where `lr_ptr` is given
  const float t = __fadd_rn(__ll2float_rn(*step), 1.0f);
  const float rate = lr_ptr ? *lr_ptr : lr;
  const float num = __fmul_rn(rate,
                              __fsqrt_rn(__fsub_rn(1.0f, powf(b2, t))));
  *out = __fdiv_rn(num, __fsub_rn(1.0f, powf(b1, t)));
}

template <int Cap>
GradAddrs<Cap> grad_addrs(const int64_t* host, int n) {
  GradAddrs<Cap> a;
  for (int i = 0; i < n; ++i)
    a.g[i] = reinterpret_cast<const void*>(host[i]);
  for (int i = n; i < Cap; ++i) a.g[i] = nullptr;
  return a;
}

template <typename Rule, int Cap>
int launch_multi_cap(const int64_t* tab, const int64_t* gaddr, int n_leaves,
                     int n_chunks, int chunk, const float* sc, int dtype,
                     cudaStream_t st, const Rule& rule) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = n_chunks < 8 * sms ? n_chunks : 8 * sms;
  const GradAddrs<Cap> g = grad_addrs<Cap>(gaddr, n_leaves);
  if (dtype == 0) {
    multi_update_kernel<float, Rule, Cap><<<grid, kThreads, 0, st>>>(
        tab, g, n_leaves, n_chunks, chunk, sc, rule);
  } else if (dtype == 1) {
    multi_update_kernel<__nv_bfloat16, Rule, Cap><<<grid, kThreads, 0, st>>>(
        tab, g, n_leaves, n_chunks, chunk, sc, rule);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Rule>
int launch_multi(const void* table, const int64_t* gaddr, int n_leaves,
                 int n_chunks, int chunk, const void* scalar, int dtype,
                 void* stream, const Rule& rule) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves || n_chunks < 0 || chunk < 4 ||
      chunk % 4)
    return (int)cudaErrorInvalidValue;
  if (n_leaves == 0 || n_chunks == 0) return 0;
  const int64_t* tab = static_cast<const int64_t*>(table);
  const float* sc = static_cast<const float*>(scalar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_leaves <= kSmallCap
             ? launch_multi_cap<Rule, kSmallCap>(tab, gaddr, n_leaves,
                                                 n_chunks, chunk, sc, dtype,
                                                 st, rule)
             : launch_multi_cap<Rule, kMaxLeaves>(tab, gaddr, n_leaves,
                                                  n_chunks, chunk, sc, dtype,
                                                  st, rule);
}

template <typename Rule, int Cap>
int launch_persistent_cap(const int64_t* tab, const int64_t* gaddr,
                          const int64_t* blk, int n_blocks, int n_leaves,
                          int n_chunks, const float* sc, int dtype,
                          cudaStream_t st, const Rule& rule) {
  const GradAddrs<Cap> g = grad_addrs<Cap>(gaddr, n_leaves);
  if (dtype == 0) {
    persist::persistent_update_kernel<float, Rule, Cap>
        <<<n_blocks, persist::kBlockThreads,
           persist::smem_bytes<float, Rule>(), st>>>(
            tab, g, blk, n_leaves, n_chunks, sc, rule);
  } else if (dtype == 1) {
    persist::persistent_update_kernel<__nv_bfloat16, Rule, Cap>
        <<<n_blocks, persist::kBlockThreads,
           persist::smem_bytes<__nv_bfloat16, Rule>(), st>>>(
            tab, g, blk, n_leaves, n_chunks, sc, rule);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Rule>
int launch_persistent(const void* table, const int64_t* gaddr,
                      const void* blocks, int n_blocks, int n_leaves,
                      int n_chunks, int chunk, const void* scalar, int dtype,
                      void* stream, const Rule& rule) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves || n_chunks < 0 ||
      n_blocks < 0 || chunk != persist::kChunk)
    return (int)cudaErrorInvalidValue;
  if (n_leaves == 0 || n_chunks == 0 || n_blocks == 0) return 0;
  const int64_t* tab = static_cast<const int64_t*>(table);
  const int64_t* blk = static_cast<const int64_t*>(blocks);
  const float* sc = static_cast<const float*>(scalar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_leaves <= kSmallCap
             ? launch_persistent_cap<Rule, kSmallCap>(
                   tab, gaddr, blk, n_blocks, n_leaves, n_chunks, sc, dtype,
                   st, rule)
             : launch_persistent_cap<Rule, kMaxLeaves>(
                   tab, gaddr, blk, n_blocks, n_leaves, n_chunks, sc, dtype,
                   st, rule);
}

}  // namespace

extern "C" {

// Raises design 2's dynamic shared-memory limit for its kernels (float32
// and bfloat16, Adam and Nesterovs, both GradAddrs sizes); 0 or a
// cudaError_t.
int dl4j_fused_update_prepare(void) {
  cudaError_t e = persist::set_limit<float, AdamRule>();
  if (e == cudaSuccess) e = persist::set_limit<__nv_bfloat16, AdamRule>();
  if (e == cudaSuccess) e = persist::set_limit<float, NesterovRule>();
  if (e == cudaSuccess)
    e = persist::set_limit<__nv_bfloat16, NesterovRule>();
  return (int)e;
}

// table: device int64 [n_leaves, 5] (p, m, v, n, first chunk), leaves in
// chunk order, chunks of `chunk` elements; gaddr: HOST int64 [n_leaves],
// the gradients' device addresses, copied into the launch's parameters
// (n_leaves at most 4000); lrbc / lr: device float32 scalar; dtype: 0 =
// float32, 1 = bfloat16 for every tensor of every leaf. Design 1. Each
// returns 0 or a cudaError_t.
int dl4j_adam_multi(const void* table, const int64_t* gaddr, int n_leaves,
                    int n_chunks, int chunk, const void* lrbc, float b1,
                    float c1, float b2, float c2, float eps, int dtype,
                    void* stream) {
  AdamRule rule;
  rule.b1 = b1; rule.c1 = c1; rule.b2 = b2; rule.c2 = c2; rule.eps = eps;
  return launch_multi(table, gaddr, n_leaves, n_chunks, chunk, lrbc, dtype,
                      stream, rule);
}

// the m column of the table is not read
int dl4j_nesterov_multi(const void* table, const int64_t* gaddr,
                        int n_leaves,
                        int n_chunks, int chunk, const void* lr, float mu,
                        int dtype, void* stream) {
  NesterovRule rule;
  rule.mu = mu;
  return launch_multi(table, gaddr, n_leaves, n_chunks, chunk, lr, dtype,
                      stream, rule);
}

// Design 2: the same table and addresses, and blocks, device int64
// [n_blocks, 3] (first chunk, end chunk, the first chunk's leaf): one
// block each, over chunks of 2048 elements (`chunk` must say so).
int dl4j_adam_persistent(const void* table, const int64_t* gaddr,
                         const void* blocks, int n_blocks, int n_leaves,
                         int n_chunks, int chunk, const void* lrbc, float b1,
                         float c1, float b2, float c2, float eps, int dtype,
                         void* stream) {
  AdamRule rule;
  rule.b1 = b1; rule.c1 = c1; rule.b2 = b2; rule.c2 = c2; rule.eps = eps;
  return launch_persistent(table, gaddr, blocks, n_blocks, n_leaves,
                           n_chunks, chunk, lrbc, dtype, stream, rule);
}

int dl4j_nesterov_persistent(const void* table, const int64_t* gaddr,
                             const void* blocks, int n_blocks, int n_leaves,
                             int n_chunks, int chunk, const void* lr,
                             float mu, int dtype, void* stream) {
  NesterovRule rule;
  rule.mu = mu;
  return launch_persistent(table, gaddr, blocks, n_blocks, n_leaves,
                           n_chunks, chunk, lr, dtype, stream, rule);
}

// Adam's bias-corrected rate from the device step counter (int64 0-d):
// out (float32 0-d) = lr sqrt(1 - b2^t) / (1 - b1^t), t = step + 1, with
// lr read from `lr_ptr` (a device float32 scalar) where it is not null.
int dl4j_adam_lrbc(const void* step, const void* lr_ptr, float lr, float b1,
                   float b2, void* out, void* stream) {
  adam_lrbc_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(step), static_cast<const float*>(lr_ptr),
      lr, b1, b2, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
